// Elementwise exponentiation over FQ or FP in Montgomery form:
// out[i] = base[i]^(e[i] mod 2^nbits), with base^0 = one.
//
// Replaces no Pallas kernel: the reference's g_pow is jnp code (a loop
// over the exponent bits in src/repro/core/group.py), as its MSM is.
// The callers are the merged pair IPA's H basis h^w (2^28
// elements, w = 1 on most of them), the verifier's zkReLU bases H^{1/e}
// (random 61-bit exponents), and every Fermat inverse and python-int power
// (the exponent passed by value: batch_inv, group inverses, g_pow_int).
//
// Bound on the card: operations.  A random 61-bit exponent costs about 84
// Montgomery products here (below) against 24 bytes moved (base and
// exponent read, one word written); at 38 int32 operations a product and
// 33.5 T/s that is 25 ms for 2^28 elements, against 1.9 ms of bytes.
//
// Design: one thread takes one element (grid-stride loop), with its own
// top exponent bit from __clzll, so no host sync finds the largest
// exponent and whole warps of unit exponents (most of the merged IPA's w)
// exit at once with no product.  A bit-by-bit square-and-multiply would
// diverge within a warp (each thread's multiply falls on its own bits, so
// the warp pays a multiply at nearly every bit: 59 ms at 2^28 on the
// H100); a fixed 3-bit window keeps the warp in step: 60 squarings, one
// multiply by a table entry a window (base^0..base^7, built with 6
// products, in shared memory, one column a thread), about 84 products.
// Products skip REDC's final subtraction (`mont_mul_lazy`) and the result
// is reduced once.  A stride of 0 reads a base or an exponent broadcast;
// exps == nullptr takes one exponent by value.
#include "mont64.cuh"

constexpr int kThreads = 128;
constexpr int kWindow = 3;
constexpr int kTable = 1 << kWindow;

// REDC without the final subtraction: for a, b < 2m and m < 2^62,
// (a*b + q*m) / 2^64 < (4m^2 + 2^64 m) / 2^64 < 2m, so products of such
// operands stay below 2m and one subtraction at the end gives the
// canonical residue mont_mul64 would.
__device__ __forceinline__ uint64_t mont_mul_lazy(uint64_t a, uint64_t b,
                                                  uint64_t m, uint64_t np) {
    const uint64_t lo = a * b, hi = __umul64hi(a, b);
    const uint64_t q = lo * np;
    return hi + __umul64hi(q, m) + (lo != 0);
}

__global__ void __launch_bounds__(kThreads) powmod_kernel(
        const uint64_t* __restrict__ base, int64_t base_inc,
        const uint64_t* __restrict__ exps, int64_t exp_inc,
        uint64_t exp_value, uint64_t mask, uint64_t* __restrict__ out,
        int64_t n, uint64_t one, uint64_t m, uint64_t np) {
    __shared__ uint64_t table[kTable][kThreads];
    const int t = threadIdx.x;
    ZK_GRID_LOOP(i, n) {
        const uint64_t e = (exps ? exps[i * exp_inc] : exp_value) & mask;
        const uint64_t b = base[i * base_inc];
        if (e <= 1) {
            out[i] = e ? b : one;
            continue;
        }
        table[0][t] = one;
        table[1][t] = b;
        uint64_t x = b;
#pragma unroll
        for (int d = 2; d < kTable; ++d) {
            x = mont_mul_lazy(x, b, m, np);
            table[d][t] = x;
        }
        const int top = 64 - __clzll((long long)e);
        int shift = (top - 1) / kWindow * kWindow;
        uint64_t acc = table[e >> shift][t];
        for (shift -= kWindow; shift >= 0; shift -= kWindow) {
#pragma unroll
            for (int k = 0; k < kWindow; ++k)
                acc = mont_mul_lazy(acc, acc, m, np);
            acc = mont_mul_lazy(acc, table[(e >> shift) & (kTable - 1)][t],
                                m, np);
        }
        out[i] = acc >= m ? acc - m : acc;
    }
}

extern "C" int zk_powmod(const void* base, int64_t base_inc, const void* exps,
                         int64_t exp_inc, uint64_t exp_value, uint64_t mask,
                         void* out, int64_t n, uint64_t one, uint64_t m,
                         uint64_t np, void* stream) {
    if (n <= 0) return 0;
    powmod_kernel<<<zk_blocks(n, kThreads), kThreads, 0,
                    (cudaStream_t)stream>>>(
        (const uint64_t*)base, base_inc, (const uint64_t*)exps, exp_inc,
        exp_value, mask, (uint64_t*)out, n, one, m, np);
    return (int)cudaGetLastError();
}
