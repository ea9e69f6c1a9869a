// Sumcheck MLE fold and IPA halves fold over FQ.
//
// fold replaces src/repro/kernels/sumcheck_fold/kernel.py:169
// (fold_planes, body _fold_body:35): T'[i] = T[2i] + (T[2i+1] - T[2i]) * r.
// The input is read as (outer, 2, inner): inner = 1 folds adjacent words
// (one sumcheck round over a whole (K, n) table stack in one launch, or
// the column variables of a matrix), inner = C folds adjacent rows of an
// (R, C) matrix.  r arrives by value in Montgomery form.
//
// fold_halves replaces kernel.py:74 (fold_halves_planes, body
// _fold_halves_body:45): out[i] = c_lo * lo[i] + c_hi * hi[i], the IPA
// scalar fold of the two halves of a vector.
//
// Bound on the card: both are memory-bound (16 bytes read and 8 written
// per output word against one or two 64-bit Montgomery multiplies), so
// each output word is produced in a single pass with coalesced loads and
// no intermediate diff or product array ever reaches device memory.
#include "mont64.cuh"

__global__ void fold_kernel(const uint64_t* __restrict__ x,
                            uint64_t* __restrict__ out, int64_t outer,
                            int64_t inner, uint64_t r, uint64_t m,
                            uint64_t np) {
    const int64_t n = outer * inner;
    ZK_GRID_LOOP(i, n) {
        const int64_t o = i / inner, j = i - o * inner;
        const uint64_t ev = x[(2 * o) * inner + j];
        const uint64_t od = x[(2 * o + 1) * inner + j];
        out[i] = add_mod64(ev, mont_mul64(sub_mod64(od, ev, m), r, m, np), m);
    }
}

__global__ void fold_halves_kernel(const uint64_t* __restrict__ lo,
                                   const uint64_t* __restrict__ hi,
                                   uint64_t* __restrict__ out, int64_t n,
                                   uint64_t c_lo, uint64_t c_hi, uint64_t m,
                                   uint64_t np) {
    ZK_GRID_LOOP(i, n) {
        out[i] = add_mod64(mont_mul64(lo[i], c_lo, m, np),
                           mont_mul64(hi[i], c_hi, m, np), m);
    }
}

extern "C" int zk_fold(const void* x, void* out, int64_t outer,
                       int64_t inner, uint64_t r, uint64_t m, uint64_t np,
                       void* stream) {
    const int64_t n = outer * inner;
    if (n <= 0) return 0;
    const int threads = 256;
    fold_kernel<<<zk_blocks(n, threads), threads, 0, (cudaStream_t)stream>>>(
        (const uint64_t*)x, (uint64_t*)out, outer, inner, r, m, np);
    return (int)cudaGetLastError();
}

extern "C" int zk_fold_halves(const void* lo, const void* hi, void* out,
                              int64_t n, uint64_t c_lo, uint64_t c_hi,
                              uint64_t m, uint64_t np, void* stream) {
    if (n <= 0) return 0;
    const int threads = 256;
    fold_halves_kernel<<<zk_blocks(n, threads), threads, 0,
                         (cudaStream_t)stream>>>(
        (const uint64_t*)lo, (const uint64_t*)hi, (uint64_t*)out, n, c_lo,
        c_hi, m, np);
    return (int)cudaGetLastError();
}
