// Elementwise Montgomery multiply over FQ or FP: out[i] = a[i] * b[i] * 2^-64.
//
// Replaces the Pallas kernel src/repro/kernels/modmul/kernel.py:50
// (modmul_planes, body _modmul_body: 16-bit-limb CIOS over (4,R,128)
// planes).  On the H100 one thread owns one 64-bit word and the product
// is a native 64x64->128 multiply plus REDC (mont64.cuh), so there are
// no limb planes.  A scalar operand is read with stride 0 (a_inc or
// b_inc = 0), which is how every "table times one challenge" product of
// the prover runs without materialising a broadcast.
//
// Bound on the card: 24 bytes per element (two reads, one write) against
// 38 32-bit integer operations (counted in the compiled SASS, a
// multiply-add as 2); at 3.35 TB/s the memory side dominates,
// so the design keeps one pass, coalesced 8-byte accesses, and no
// shared memory.
#include "mont64.cuh"

__global__ void modmul_kernel(const uint64_t* __restrict__ a, int64_t a_inc,
                              const uint64_t* __restrict__ b, int64_t b_inc,
                              uint64_t* __restrict__ out, int64_t n,
                              uint64_t m, uint64_t np) {
    ZK_GRID_LOOP(i, n) {
        out[i] = mont_mul64(a[i * a_inc], b[i * b_inc], m, np);
    }
}

// Scalar operand passed by value.
__global__ void modmul_scalar_kernel(const uint64_t* __restrict__ a,
                                     uint64_t s, uint64_t* __restrict__ out,
                                     int64_t n, uint64_t m, uint64_t np) {
    ZK_GRID_LOOP(i, n) {
        out[i] = mont_mul64(a[i], s, m, np);
    }
}

extern "C" int zk_modmul(const void* a, int64_t a_inc, const void* b,
                         int64_t b_inc, void* out, int64_t n, uint64_t m,
                         uint64_t np, void* stream) {
    if (n <= 0) return 0;
    const int threads = 256;
    modmul_kernel<<<zk_blocks(n, threads), threads, 0, (cudaStream_t)stream>>>(
        (const uint64_t*)a, a_inc, (const uint64_t*)b, b_inc, (uint64_t*)out,
        n, m, np);
    return (int)cudaGetLastError();
}

extern "C" int zk_modmul_scalar(const void* a, uint64_t s, void* out,
                                int64_t n, uint64_t m, uint64_t np,
                                void* stream) {
    if (n <= 0) return 0;
    const int threads = 256;
    modmul_scalar_kernel<<<zk_blocks(n, threads), threads, 0,
                           (cudaStream_t)stream>>>(
        (const uint64_t*)a, s, (uint64_t*)out, n, m, np);
    return (int)cudaGetLastError();
}
