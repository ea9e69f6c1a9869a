// One-word Montgomery arithmetic shared by every kernel of the port.
//
// A field element is one uint64 word holding x * 2^64 mod m (canonical,
// < m < 2^62).  mont_mul64 is REDC with R = 2^64: the 128-bit product
// comes from one multiply plus __umul64hi, q = lo * n' cancels the low
// word, and one conditional subtract returns the canonical residue --
// the same value the JAX package's 16-bit-limb CIOS multiply produces.
#pragma once
#include <cstdint>
#include <cuda_runtime.h>

__device__ __forceinline__ uint64_t mont_mul64(uint64_t a, uint64_t b,
                                               uint64_t m, uint64_t np) {
    uint64_t lo = a * b;
    uint64_t hi = __umul64hi(a, b);
    uint64_t q = lo * np;                 // q * m == -lo (mod 2^64)
    uint64_t mhi = __umul64hi(q, m);
    uint64_t u = hi + mhi + (lo != 0);    // (a*b + q*m) / 2^64 < 2m
    return u >= m ? u - m : u;
}

__device__ __forceinline__ uint64_t add_mod64(uint64_t a, uint64_t b,
                                              uint64_t m) {
    uint64_t s = a + b;                   // < 2m < 2^63
    return s >= m ? s - m : s;
}

__device__ __forceinline__ uint64_t sub_mod64(uint64_t a, uint64_t b,
                                              uint64_t m) {
    return a >= b ? a - b : a + m - b;
}

// Grid-stride loop bounds shared by the elementwise kernels.
#define ZK_GRID_LOOP(i, n)                                                  \
    for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;        \
         i < (n); i += (int64_t)gridDim.x * blockDim.x)

static inline unsigned zk_blocks(int64_t n, int threads) {
    int64_t b = (n + threads - 1) / threads;
    if (b < 1) b = 1;
    if (b > 1048576) b = 1048576;        // grid-stride covers the rest
    return (unsigned)b;
}
