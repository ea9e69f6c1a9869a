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
// pow_mul replaces kernel.py:131 (pow_mul_planes, body _pow_mul_body:84):
// out[i] = lo[i]^{e_lo} * hi[i]^{e_hi} over FP, the IPA generator fold,
// with two standard-form exponents below 2^61 passed by value.
//
// Bound on the card: fold and fold_halves are memory-bound (16 bytes read
// and 8 written per output word against one or two 64-bit Montgomery
// multiplies), so each output word is produced in a single pass with
// coalesced loads and no intermediate diff or product array ever reaches
// device memory.  pow_mul is bound by operations (up to ~180 multiplies
// per word): one thread owns one word and its square-and-multiply chains
// stay in registers.  The exponents are the same for every thread, so
// the bit tests never diverge; the loop stops at the highest bit either
// exponent sets, and the lo chain is skipped when e_lo = 1 (the pair
// IPA's merge gg_lo * gg_hi^{e}).
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

__global__ void pow_mul_kernel(const uint64_t* __restrict__ lo,
                               const uint64_t* __restrict__ hi,
                               uint64_t* __restrict__ out, int64_t n,
                               uint64_t e_lo, uint64_t e_hi, uint64_t one,
                               uint64_t m, uint64_t np) {
    const bool lo_chain = e_lo != 1;
    const uint64_t bits = lo_chain ? (e_lo | e_hi) : e_hi;
    const int top = bits ? 64 - __clzll((long long)bits) : 0;
    ZK_GRID_LOOP(i, n) {
        uint64_t acc_lo = lo[i], acc_hi = hi[i];
        uint64_t res_lo = lo_chain ? one : acc_lo, res_hi = one;
        for (int j = 0; j < top; ++j) {
            if ((e_hi >> j) & 1) res_hi = mont_mul64(res_hi, acc_hi, m, np);
            if (lo_chain && ((e_lo >> j) & 1))
                res_lo = mont_mul64(res_lo, acc_lo, m, np);
            if (j + 1 < top) {
                acc_hi = mont_mul64(acc_hi, acc_hi, m, np);
                if (lo_chain) acc_lo = mont_mul64(acc_lo, acc_lo, m, np);
            }
        }
        out[i] = mont_mul64(res_lo, res_hi, m, np);
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

extern "C" int zk_pow_mul(const void* lo, const void* hi, void* out,
                          int64_t n, uint64_t e_lo, uint64_t e_hi,
                          uint64_t one, uint64_t m, uint64_t np,
                          void* stream) {
    if (n <= 0) return 0;
    const int threads = 256;
    pow_mul_kernel<<<zk_blocks(n, threads), threads, 0,
                     (cudaStream_t)stream>>>(
        (const uint64_t*)lo, (const uint64_t*)hi, (uint64_t*)out, n, e_lo,
        e_hi, one, m, np);
    return (int)cudaGetLastError();
}
