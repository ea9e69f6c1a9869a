// Exact int16 x int16 -> int64 matrix product in one launch, on the int8
// tensor cores.
//
// Replaces src/repro/kernels/qmatmul/kernel.py:93 (qmatmul_digits, body
// _qmatmul_body:45) together with the host assembly of its wrapper
// (src/repro/kernels/qmatmul/ops.py:85-99).  Each int16 x splits into the
// reference's int8 digits x = 256 x_hi + x_c + 128 (x_hi = x >> 8,
// x_c = (x & 0xFF) - 128), and
//
//   A B = 2^16 hh + 2^8 (hc + ch) + cc + 2^15 rowsum(Ah) + 2^7 rowsum(Ac)
//         + 2^15 colsum(Bh) + 2^7 colsum(Bc) + 2^14 K_run
//
// with hh = Ah Bh, hc = Ah Bc, ch = Ac Bh, cc = Ac Bc and the sums over
// the K_run entries the kernel ran: K rounded up to the K tile, the
// reference's padded-K rule (an int16 zero pad adds 0 to A B, and the
// identity holds over the padded operands).
//
// Bound on the H100: bytes 2MK + 2KN + 8MN against 4 x 2MNK int8
// tensor-core operations.  At the witness shapes of the fcnn-zkdl-16l
// width the bytes decide: Z = A W and G_X = G_Z W^T (128 x 4096 x 4096)
// move 38.8 MB (11.6 us at 3.35 TB/s; the operations take 8.7 us), and
// G_W = G_Z^T A (4096 x 128 x 4096) writes 128 MB of int64 (40.7 us).
//
// Design:
// * Operands by pointer and stride, as they lie: each is K-contiguous
//   ("kmajor") or contiguous along M / N ("outer"), so the witness's .T
//   views need no copy.  Each K step, cp.async copies a 64 x 64 int16
//   tile of each into a 3-stage shared-memory ring: inside the operands
//   each thread copies two 16-byte chunks from pointers set up once;
//   tiles at an edge take zero-filled copies, and an operand that is not
//   16-byte aligned 2-byte loads (load_edge_tile).  Rows are padded to
//   144 bytes, so the ldmatrix reads below are free of bank conflicts in
//   both layouts.
// * The split happens in registers.  ldmatrix (kmajor) or ldmatrix.trans
//   (outer) hands every thread the int16 pairs (row g, k = 2t, 2t + 1) of
//   8 x 8 blocks in either layout, and two byte permutes turn two such
//   pairs into one register of four x_hi and one of four x_c digits:
//   the K-major int8 fragment that mma.sync needs for both A and B (it
//   never transposes 8-bit B).  A and B use the same order of K inside a
//   fragment, so every product pairs the right entries.  No digit tile is
//   ever stored.
// * mma.sync.m16n8k32.s8.s8.s32 computes the four digit products: each
//   A fragment is used against B_hi and B_c, each B fragment against A_hi
//   and A_c.  8 warps of 32 x 16 outputs (128 registers, two blocks to an
//   SM); 64 x 64 tiles give 128 blocks at Z and G_X and 4096 at G_W.
// * The digit row and column sums run on the tensor cores too: the same
//   fragments against a fragment of ones, each row and column once.
// * int32 digit products wrap only at K_run = 2^17, where one all
//   -128 x -128 sum reaches 2^31; every digit product lies in
//   [-16256 K_run, 16384 K_run], an interval shorter than 2^32 for
//   K_run <= 131586, so the epilogue recovers it from its residue mod
//   2^32.  The wrapper accepts K <= 2^17.
// * The epilogue assembles the int64 result in registers and writes each
//   output once, two per 16-byte streaming store.
//
// What holds it back: at Z and G_X every block streams the whole K
// extent of its 64 rows of A and 64 columns of B from L2, 128 MB in all,
// 3.3 times the bytes of the bound, and feeds mma.sync from registers
// filled by ldmatrix and byte permutes; sharing tiles across a
// thread-block cluster (TMA multicast) and wgmma are the next steps.  At
// G_W each block runs two K steps, and its loads, products and int64
// stores overlap only with the other block on its SM.
#include <cstdint>
#include <cuda_runtime.h>

#define QM_TILE 64                 // output tile QM_TILE x QM_TILE
#define QM_BK 64                   // K tile, int16 entries
#define QM_PITCH 72                // int16 per shared row: 64 + 16 bytes
#define QM_STAGES 3
#define QM_THREADS 256             // 8 warps, 2 x 4, 32 x 16 outputs each
#define QM_TILE_ELEMS (QM_TILE * QM_PITCH)
#define QM_SMEM (QM_STAGES * 2 * QM_TILE_ELEMS * 2)
#define QM_K_MAX (1 << 17)

__device__ __forceinline__ void cp_async16(int16_t* dst, const int16_t* src,
                                           int src_bytes) {
    const uint32_t s = (uint32_t)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(s), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Four 8 x 8 b16 blocks; lanes 8i..8i+7 give the row addresses of block i.
template <bool TRANS>
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const int16_t* p) {
    const uint32_t s = (uint32_t)__cvta_generic_to_shared(p);
    if (TRANS)
        asm volatile(
            "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, "
            "[%4];\n"
            : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(s)
            : "memory");
    else
        asm volatile(
            "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
            : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(s)
            : "memory");
}

// Two registers of int16 pairs (k0, k1) and (k2, k3) -> the x_hi digits
// and the x_c digits of (k0, k1, k2, k3), one int8 per byte.
__device__ __forceinline__ void split(uint32_t lo, uint32_t hi, uint32_t& dh,
                                      uint32_t& dc) {
    dh = __byte_perm(lo, hi, 0x7531);
    dc = __byte_perm(lo, hi, 0x6420) ^ 0x80808080u;
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
    asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One 64 x 64 int16 tile at the edge of an operand, or of an operand
// that is not 16-byte aligned: entry (i, j) of the tile is
// src[i * ld + j], valid for i < i_lim and j < j_lim (zero elsewhere); j
// is the contiguous direction.  `safe` is a readable address for copies
// of zero bytes.  Thread x copies rows x / 8 + 32 c (c < 2), entries
// 8 (x % 8) .. + 7.
__device__ __noinline__ void load_edge_tile(int16_t* dst, const int16_t* src,
                                            int64_t ld, int64_t i_lim,
                                            int64_t j_lim, int vec,
                                            const int16_t* safe) {
    const int i0 = threadIdx.x >> 3, j0 = (threadIdx.x & 7) * 8;
    if (vec) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
            const int i = i0 + 32 * c;
            int64_t n = i < i_lim ? j_lim - j0 : 0;
            n = n < 0 ? 0 : (n > 8 ? 8 : n);
            cp_async16(dst + i * QM_PITCH + j0, n ? src + i * ld + j0 : safe,
                       (int)n * 2);
        }
    } else {
        for (int e = threadIdx.x; e < QM_TILE * QM_BK; e += QM_THREADS) {
            const int i = e / QM_BK, j = e % QM_BK;
            dst[i * QM_PITCH + j] =
                (i < i_lim && j < j_lim) ? src[i * ld + j] : (int16_t)0;
        }
    }
}

// A_K / B_K: the operand is K-contiguous (A (M, K) row-major, B stored as
// (N, K) row-major); otherwise contiguous along M (A) or N (B).
template <bool A_K, bool B_K>
__global__ void __launch_bounds__(QM_THREADS) qmatmul_kernel(
    const int16_t* __restrict__ a, int64_t a_ld, int a_vec,
    const int16_t* __restrict__ b, int64_t b_ld, int b_vec,
    int64_t* __restrict__ out, int64_t M, int64_t N, int64_t K) {
    extern __shared__ __align__(16) int16_t ring[];
    __shared__ int64_t srow[QM_TILE], scol[QM_TILE];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int wm = warp >> 2, wn = warp & 3;
    const int g = lane >> 2, t = lane & 3;
    const int mi = lane >> 3, li = lane & 7;   // ldmatrix block and row
    const int64_t m0 = (int64_t)blockIdx.y * QM_TILE;
    const int64_t n0 = (int64_t)blockIdx.x * QM_TILE;
    const int n_kt = (int)((K + QM_BK - 1) / QM_BK);

    // Inside the operands (a whole, 16-byte aligned tile), each thread
    // copies two 16-byte chunks of each tile, rows i0 and i0 + 32 of the
    // tile, from pointers that advance by one K tile per step.
    const int i0 = threadIdx.x >> 3, j0 = (threadIdx.x & 7) * 8;
    const int full_kt = (int)(K / QM_BK);       // K tiles off the K edge
    const bool a_full = a_vec && M - m0 >= QM_TILE;
    const bool b_full = b_vec && N - n0 >= QM_TILE;
    const int16_t* a_p = A_K ? a + (m0 + i0) * a_ld + j0
                             : a + i0 * a_ld + m0 + j0;
    const int16_t* b_p = B_K ? b + (n0 + i0) * b_ld + j0
                             : b + i0 * b_ld + n0 + j0;
    const int64_t a_kstep = A_K ? QM_BK : QM_BK * a_ld;
    const int64_t b_kstep = B_K ? QM_BK : QM_BK * b_ld;
    const int chunk = i0 * QM_PITCH + j0;

    auto load = [&](int stage, int kt) {
        int16_t* sa = ring + stage * 2 * QM_TILE_ELEMS;
        int16_t* sb = sa + QM_TILE_ELEMS;
        const int64_t k0 = (int64_t)kt * QM_BK;
        if (a_full && kt < full_kt) {
            const int16_t* p = a_p + kt * a_kstep;
            cp_async16(sa + chunk, p, 16);
            cp_async16(sa + chunk + 32 * QM_PITCH, p + 32 * a_ld, 16);
        } else if (A_K) {
            load_edge_tile(sa, a + m0 * a_ld + k0, a_ld, M - m0, K - k0,
                           a_vec, a);
        } else {
            load_edge_tile(sa, a + k0 * a_ld + m0, a_ld, K - k0, M - m0,
                           a_vec, a);
        }
        if (b_full && kt < full_kt) {
            const int16_t* p = b_p + kt * b_kstep;
            cp_async16(sb + chunk, p, 16);
            cp_async16(sb + chunk + 32 * QM_PITCH, p + 32 * b_ld, 16);
        } else if (B_K) {
            load_edge_tile(sb, b + n0 * b_ld + k0, b_ld, N - n0, K - k0,
                           b_vec, b);
        } else {
            load_edge_tile(sb, b + k0 * b_ld + n0, b_ld, K - k0, N - n0,
                           b_vec, b);
        }
    };

    int acc[4][2][2][4];           // [hh, hc, ch, cc][m tile][n tile][frag]
#pragma unroll
    for (int p = 0; p < 4; ++p)
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int j = 0; j < 2; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) acc[p][i][j][e] = 0;
    // digit sums on the tensor cores, against a fragment of ones: warp
    // (wm, wn) sums the columns of its n tile wm and, for wn < 2, the rows
    // of its m tile wn (each row and column of the block summed once)
    const uint32_t ones_a[4] = {0x01010101u, 0x01010101u, 0x01010101u,
                                0x01010101u};
    const uint32_t ones_b[2] = {0x01010101u, 0x01010101u};
    int rs_h[4] = {}, rs_c[4] = {}, cs_h[4] = {}, cs_c[4] = {};

#pragma unroll
    for (int s = 0; s < QM_STAGES - 1; ++s) {
        if (s < n_kt) load(s, s);
        cp_async_commit();
    }
    for (int kt = 0, use = 0, fill = QM_STAGES - 1; kt < n_kt; ++kt) {
        cp_async_wait<QM_STAGES - 2>();
        __syncthreads();
        if (kt + QM_STAGES - 1 < n_kt) load(fill, kt + QM_STAGES - 1);
        cp_async_commit();
        fill = fill == QM_STAGES - 1 ? 0 : fill + 1;

        const int16_t* sa = ring + use * 2 * QM_TILE_ELEMS;
        use = use == QM_STAGES - 1 ? 0 : use + 1;
        const int16_t* sb = sa + QM_TILE_ELEMS;
#pragma unroll
        for (int kk = 0; kk < QM_BK; kk += 32) {
            uint32_t bh[2][2], bc[2][2];
#pragma unroll
            for (int nt = 0; nt < 2; ++nt) {
                const int nb = wn * 16 + nt * 8;
                uint32_t r[4];         // k = kk + 8 i + (2t, 2t + 1), n = g
                ldsm_x4<!B_K>(r, B_K
                    ? sb + (nb + li) * QM_PITCH + kk + mi * 8
                    : sb + (kk + mi * 8 + li) * QM_PITCH + nb);
                split(r[0], r[1], bh[nt][0], bc[nt][0]);
                split(r[2], r[3], bh[nt][1], bc[nt][1]);
                if (nt == wm) {
                    mma_s8(cs_h, ones_a, bh[nt]);
                    mma_s8(cs_c, ones_a, bc[nt]);
                }
            }
#pragma unroll
            for (int mt = 0; mt < 2; ++mt) {
                const int mb = wm * 32 + mt * 16;
                uint32_t ah[4], ac[4];
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                    const int ro = (mi & 1) * 8;
                    const int ko = kk + h * 16 + (mi >> 1) * 8;
                    uint32_t r[4];     // rows g, g + 8 x k 0..15 of half h
                    ldsm_x4<!A_K>(r, A_K
                        ? sa + (mb + ro + li) * QM_PITCH + ko
                        : sa + (ko + li) * QM_PITCH + mb + ro);
                    split(r[0], r[2], ah[2 * h], ac[2 * h]);
                    split(r[1], r[3], ah[2 * h + 1], ac[2 * h + 1]);
                }
                if (mt == wn) {               // only warps with wn < 2
                    mma_s8(rs_h, ah, ones_b);
                    mma_s8(rs_c, ac, ones_b);
                }
#pragma unroll
                for (int nt = 0; nt < 2; ++nt) {
                    mma_s8(acc[0][mt][nt], ah, bh[nt]);
                    mma_s8(acc[1][mt][nt], ah, bc[nt]);
                    mma_s8(acc[2][mt][nt], ac, bh[nt]);
                    mma_s8(acc[3][mt][nt], ac, bc[nt]);
                }
            }
        }
    }
    cp_async_wait<0>();

    // digit product = (uint32)(v + off) - off, off = 16256 K_run; the -off
    // of all four products and the 2^14 K_run term fold into srow
    const int64_t k_run = (int64_t)n_kt * QM_BK;
    const uint32_t off = (uint32_t)(16256 * k_run);
    if (wn < 2 && t == 0) {        // rows g, g + 8 of m tile wn
        const int lr = wm * 32 + wn * 16 + g;
        const int64_t base = 16384 * k_run - 66049 * (int64_t)off;
        srow[lr] = 32768 * (int64_t)rs_h[0] + 128 * (int64_t)rs_c[0] + base;
        srow[lr + 8] = 32768 * (int64_t)rs_h[2] + 128 * (int64_t)rs_c[2] +
                       base;
    }
    if (g == 0) {                  // columns 2t, 2t + 1 of n tile wm
#pragma unroll
        for (int e = 0; e < 2; ++e)
            scol[wn * 16 + wm * 8 + 2 * t + e] =
                32768 * (int64_t)cs_h[e] + 128 * (int64_t)cs_c[e];
    }
    __syncthreads();

    const bool pairs = (N & 1) == 0;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
            const int lr = wm * 32 + mt * 16 + g + 8 * hf;
            const int64_t row = m0 + lr;
            if (row >= M) continue;
            const int64_t rsum = srow[lr];
#pragma unroll
            for (int nt = 0; nt < 2; ++nt) {
                const int lc = wn * 16 + nt * 8 + 2 * t;
                const int64_t col = n0 + lc;
                int64_t v[2];
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    const int f = 2 * hf + e;
                    uint64_t u = (uint64_t)((uint32_t)acc[0][mt][nt][f] + off)
                                     * 65536u +
                                 ((uint32_t)acc[3][mt][nt][f] + off);
                    u += (uint64_t)((uint32_t)acc[1][mt][nt][f] + off) * 256u;
                    u += (uint64_t)((uint32_t)acc[2][mt][nt][f] + off) * 256u;
                    v[e] = (int64_t)u + rsum + scol[lc + e];
                }
                int64_t* p = out + row * N + col;
                if (pairs && col + 1 < N) {
                    __stcs(reinterpret_cast<longlong2*>(p),
                           make_longlong2(v[0], v[1]));
                } else {
                    if (col < N) p[0] = v[0];
                    if (col + 1 < N) p[1] = v[1];
                }
            }
        }
}

template <bool A_K, bool B_K>
static int launch(const int16_t* a, int64_t a_ld, int a_vec,
                  const int16_t* b, int64_t b_ld, int b_vec, int64_t* out,
                  int64_t M, int64_t N, int64_t K, cudaStream_t stream) {
    static bool smem_set = false;
    if (!smem_set) {
        const cudaError_t err = cudaFuncSetAttribute(
            qmatmul_kernel<A_K, B_K>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, QM_SMEM);
        if (err != cudaSuccess) return (int)err;
        smem_set = true;
    }
    const dim3 grid((unsigned)((N + QM_TILE - 1) / QM_TILE),
                    (unsigned)((M + QM_TILE - 1) / QM_TILE));
    qmatmul_kernel<A_K, B_K><<<grid, QM_THREADS, QM_SMEM, stream>>>(
        a, a_ld, a_vec, b, b_ld, b_vec, out, M, N, K);
    return (int)cudaGetLastError();
}

// out (M, N) int64 row-major = A (M, K) x B (K, N), int16 operands given
// by pointer, the stride of their non-contiguous dimension (ld, in
// entries) and whether K is their contiguous dimension.
extern "C" int zk_qmatmul_i64(const void* a, int64_t a_ld, int a_kmajor,
                              const void* b, int64_t b_ld, int b_kmajor,
                              void* out, int64_t M, int64_t N, int64_t K,
                              void* stream) {
    if (M <= 0 || N <= 0 || K <= 0) return 0;
    if (K > QM_K_MAX || (M + QM_TILE - 1) / QM_TILE > 65535)
        return (int)cudaErrorInvalidValue;
    const int16_t *pa = (const int16_t*)a, *pb = (const int16_t*)b;
    const int a_vec = (uintptr_t)a % 16 == 0 && a_ld % 8 == 0;
    const int b_vec = (uintptr_t)b % 16 == 0 && b_ld % 8 == 0;
    int64_t* po = (int64_t*)out;
    cudaStream_t s = (cudaStream_t)stream;
    if (a_kmajor && b_kmajor)
        return launch<true, true>(pa, a_ld, a_vec, pb, b_ld, b_vec, po, M, N,
                                  K, s);
    if (a_kmajor)
        return launch<true, false>(pa, a_ld, a_vec, pb, b_ld, b_vec, po, M,
                                   N, K, s);
    if (b_kmajor)
        return launch<false, true>(pa, a_ld, a_vec, pb, b_ld, b_vec, po, M,
                                   N, K, s);
    return launch<false, false>(pa, a_ld, a_vec, pb, b_ld, b_vec, po, M, N,
                                K, s);
}
