// Multi-scalar multiplication: R rows, out[r] = prod_t pts[r, t]^exps[r, t]
// over the order-q subgroup of F_p^* (one FP word in Montgomery form per
// element, exponents standard-form words).
//
// The port's own kernel: it replaces no Pallas kernel.  The reference's
// MSM is jnp code (src/repro/core/group.py) and the port's plain version
// is a sort-based Pippenger in torch ops (repro_torch/core/group.py),
// some thousands of launches a row.  Here one launch computes every
// row: each thread takes K terms of one row (strided by the block, so
// loads coalesce), finds the highest bit its warp's exponents set, and
// runs one left-to-right square-and-multiply over those bits into a
// single accumulator (Straus's interleaving: the K terms share the
// squarings).  The thread products meet in a warp-shuffle tree and a
// shared-memory tree, one partial per block; where a row spans several
// blocks a second launch multiplies each row's partials.  The group is
// commutative and every product exact and canonical, so the result is
// the plain version's bit for bit.
//
// A row is up to three segments (points, exponents) laid end to end, so
// a caller can hand over halves of vectors in place; each segment's rows
// lie a fixed number of words apart (0: one point vector shared by every
// row; negative: rows in reverse order).  Ragged rows of one flat
// segment come as term offsets, with the blocks of each row as tile
// offsets (both on the device).  The kernel allocates nothing.
//
// Bound on the card: integer operations.  A term is 16 bytes read once,
// and costs one multiply per exponent bit below the warp's top bit
// (selected by the bit, so lanes do not diverge) plus its share of the
// 61 squarings: about 61 + 61/K Montgomery products of 38 32-bit
// operations each, against 16 bytes.  So K grows with the work (up to
// 16, registers for 16 points and exponents) to spread the squarings,
// and the loads stay in registers from the first bit to the last.
#include "mont64.cuh"

#define MSM_MAX_SEGS 3
#define MSM_MAX_THREADS 256

struct MsmRows {
    const uint64_t* pts[MSM_MAX_SEGS];
    const uint64_t* exps[MSM_MAX_SEGS];
    int64_t pstride[MSM_MAX_SEGS];     // words between rows (0: shared)
    int64_t estride[MSM_MAX_SEGS];
    int64_t start[MSM_MAX_SEGS + 1];   // segment s: row terms [start[s], start[s+1])
    int nseg;
    const int64_t* term_off;           // ragged: R + 1 term offsets, else null
    const int64_t* tile_off;           // ragged: R + 1 tile offsets, else null
    int64_t tiles_per_row;             // regular rows
    int64_t rows;
    uint64_t emask, m, np, one;
};

// Product of every lane's v, in lane 0 (all 32 lanes take part).
__device__ __forceinline__ uint64_t warp_product(uint64_t v, uint64_t m,
                                                 uint64_t np) {
#pragma unroll
    for (int d = 16; d > 0; d >>= 1)
        v = mont_mul64(v, __shfl_down_sync(0xffffffffu, v, d), m, np);
    return v;
}

// Product of every thread's v, in thread 0 (blockDim.x a multiple of 32,
// at most MSM_MAX_THREADS).
__device__ __forceinline__ uint64_t block_product(uint64_t v, uint64_t m,
                                                  uint64_t np, uint64_t one) {
    __shared__ uint64_t warp_part[MSM_MAX_THREADS / 32];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    v = warp_product(v, m, np);
    if (lane == 0) warp_part[warp] = v;
    __syncthreads();
    if (warp == 0) {
        v = lane < (int)(blockDim.x >> 5) ? warp_part[lane] : one;
        v = warp_product(v, m, np);
    }
    return v;
}

// One block per tile: TB = blockDim.x * K consecutive terms of one row.
// Writes the tile's product to partial[tile].
template <int K>
__global__ void __launch_bounds__(MSM_MAX_THREADS)
msm_tiles_kernel(const MsmRows a, uint64_t* __restrict__ partial) {
    const int64_t tile = blockIdx.x;
    int64_t row, first, n_row, base = 0;
    if (a.tile_off != nullptr) {
        if (tile >= a.tile_off[a.rows]) return;        // the whole block
        int64_t lo = 0, hi = a.rows;   // tile_off[lo] <= tile < tile_off[hi]
        while (hi - lo > 1) {
            const int64_t mid = (lo + hi) >> 1;
            if (a.tile_off[mid] <= tile) lo = mid; else hi = mid;
        }
        row = lo;
        first = tile - a.tile_off[row];
        base = a.term_off[row];
        n_row = a.term_off[row + 1] - base;
    } else {
        row = tile / a.tiles_per_row;
        first = tile % a.tiles_per_row;
        n_row = a.start[a.nseg];
    }
    first = first * blockDim.x * K + threadIdx.x;

    uint64_t p[K], e[K], any = 0;
#pragma unroll
    for (int i = 0; i < K; ++i) {
        const int64_t t = first + (int64_t)i * blockDim.x;
        p[i] = a.one;
        e[i] = 0;
        if (t < n_row) {
            if (a.tile_off != nullptr) {
                p[i] = a.pts[0][base + t];
                e[i] = a.exps[0][base + t];
            } else {
#pragma unroll
                for (int s = 0; s < MSM_MAX_SEGS; ++s) {
                    if (s < a.nseg && t >= a.start[s] && t < a.start[s + 1]) {
                        const int64_t u = t - a.start[s];
                        p[i] = a.pts[s][row * a.pstride[s] + u];
                        e[i] = a.exps[s][row * a.estride[s] + u];
                    }
                }
            }
            e[i] &= a.emask;
        }
        any |= e[i];
    }
    // the warp's highest set bit bounds its (warp-uniform) loop
    const int top = __reduce_max_sync(0xffffffffu,
                                      any ? 64 - __clzll((long long)any) : 0);
    uint64_t acc = a.one;
    for (int j = top - 1; j >= 0; --j) {
        acc = mont_mul64(acc, acc, a.m, a.np);
#pragma unroll
        for (int i = 0; i < K; ++i)
            acc = mont_mul64(acc, ((e[i] >> j) & 1) ? p[i] : a.one, a.m,
                             a.np);
    }
    acc = block_product(acc, a.m, a.np, a.one);
    if (threadIdx.x == 0) partial[tile] = acc;
}

// One block per row: the product of the row's tile partials.
__global__ void __launch_bounds__(MSM_MAX_THREADS)
msm_rows_kernel(const uint64_t* __restrict__ partial,
                const int64_t* __restrict__ tile_off, int64_t tiles_per_row,
                uint64_t* __restrict__ out, uint64_t m, uint64_t np,
                uint64_t one) {
    const int64_t row = blockIdx.x;
    const int64_t lo = tile_off ? tile_off[row] : row * tiles_per_row;
    const int64_t hi = tile_off ? tile_off[row + 1] : lo + tiles_per_row;
    uint64_t acc = one;
    for (int64_t i = lo + threadIdx.x; i < hi; i += blockDim.x)
        acc = mont_mul64(acc, partial[i], m, np);
    acc = block_product(acc, m, np, one);
    if (threadIdx.x == 0) out[row] = acc;
}

template <int K>
static int launch_tiles(const MsmRows& a, int64_t tiles, int threads,
                        uint64_t* partial, cudaStream_t stream) {
    msm_tiles_kernel<K><<<(unsigned)tiles, threads, 0, stream>>>(a, partial);
    return (int)cudaGetLastError();
}

// seg: nseg x {points, points row stride, exponents, exponents row
// stride, length} (host memory; pointers as int64).  term_off / tile_off:
// null for regular rows, else the ragged rows' device offsets (one
// segment).  partial == out when every row is one tile: then the second
// launch is skipped.  Returns the first launch error, or 0.
extern "C" int zk_msm(const int64_t* seg, int nseg, const void* term_off,
                      const void* tile_off, int64_t rows, int64_t tiles,
                      int64_t tiles_per_row, int threads, int k,
                      uint64_t emask, uint64_t m, uint64_t np, uint64_t one,
                      void* partial, void* out, void* stream) {
    if (rows <= 0) return 0;
    if (nseg < 1 || nseg > MSM_MAX_SEGS || threads < 32 ||
        threads > MSM_MAX_THREADS || threads % 32 != 0)
        return (int)cudaErrorInvalidValue;
    MsmRows a = {};
    a.start[0] = 0;
    for (int s = 0; s < nseg; ++s) {
        a.pts[s] = (const uint64_t*)seg[5 * s];
        a.pstride[s] = seg[5 * s + 1];
        a.exps[s] = (const uint64_t*)seg[5 * s + 2];
        a.estride[s] = seg[5 * s + 3];
        a.start[s + 1] = a.start[s] + seg[5 * s + 4];
    }
    a.nseg = nseg;
    a.term_off = (const int64_t*)term_off;
    a.tile_off = (const int64_t*)tile_off;
    a.tiles_per_row = tiles_per_row;
    a.rows = rows;
    a.emask = emask;
    a.m = m;
    a.np = np;
    a.one = one;
    cudaStream_t st = (cudaStream_t)stream;
    uint64_t* part = (uint64_t*)partial;
    int err;
    if (tiles > 0) {
        switch (k) {
            case 1: err = launch_tiles<1>(a, tiles, threads, part, st); break;
            case 2: err = launch_tiles<2>(a, tiles, threads, part, st); break;
            case 4: err = launch_tiles<4>(a, tiles, threads, part, st); break;
            case 8: err = launch_tiles<8>(a, tiles, threads, part, st); break;
            case 16: err = launch_tiles<16>(a, tiles, threads, part, st); break;
            default: return (int)cudaErrorInvalidValue;
        }
        if (err != 0) return err;
    }
    if (partial == out) return 0;
    msm_rows_kernel<<<(unsigned)rows, MSM_MAX_THREADS, 0, st>>>(
        part, (const int64_t*)tile_off, tiles_per_row, (uint64_t*)out, m, np,
        one);
    return (int)cudaGetLastError();
}
