// Hash-to-group generator derivation, one thread per generator index.
//
// The port's own kernel: there is no TPU kernel for it.  It computes what
// src/repro/core/group.py:381 (derive_generators) computes in a host
// loop, bit for bit:
//     t = max(int.from_bytes(SHA-256(label || i.to_bytes(8, "little")),
//                            "little") mod P, 2)
//     g = t^2 * 2^64 mod P                      (a quadratic residue, in
//                                                Montgomery form)
// The host builds the padded single SHA-256 block of the label with the
// index bytes zeroed (label + 8 bytes must fit in 55 bytes); each thread
// ORs its index in, runs one compression, reduces the 256-bit digest mod P
// by Horner over four 64-bit words (v * 2^64 mod P is one Montgomery
// multiply by R^2), squares and lifts.
//
// Bound on the card: integer operations -- ~3,400 32-bit ops per hash
// against 8 bytes written -- so the block is kept in registers and the
// message schedule is computed in place over a 16-word ring.
#include "mont64.cuh"

__constant__ uint32_t kSha256K[64] = {
    0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5, 0x3956c25b, 0x59f111f1,
    0x923f82a4, 0xab1c5ed5, 0xd807aa98, 0x12835b01, 0x243185be, 0x550c7dc3,
    0x72be5d74, 0x80deb1fe, 0x9bdc06a7, 0xc19bf174, 0xe49b69c1, 0xefbe4786,
    0x0fc19dc6, 0x240ca1cc, 0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da,
    0x983e5152, 0xa831c66d, 0xb00327c8, 0xbf597fc7, 0xc6e00bf3, 0xd5a79147,
    0x06ca6351, 0x14292967, 0x27b70a85, 0x2e1b2138, 0x4d2c6dfc, 0x53380d13,
    0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85, 0xa2bfe8a1, 0xa81a664b,
    0xc24b8b70, 0xc76c51a3, 0xd192e819, 0xd6990624, 0xf40e3585, 0x106aa070,
    0x19a4c116, 0x1e376c08, 0x2748774c, 0x34b0bcb5, 0x391c0cb3, 0x4ed8aa4a,
    0x5b9cca4f, 0x682e6ff3, 0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208,
    0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2};

__device__ __forceinline__ uint32_t rotr(uint32_t x, int n) {
    return __funnelshift_r(x, x, n);
}

__device__ __forceinline__ uint32_t bswap32(uint32_t x) {
    return __byte_perm(x, 0, 0x0123);
}

__device__ void sha256_block(uint32_t w[16], uint32_t h[8]) {
    uint32_t a = 0x6a09e667, b = 0xbb67ae85, c = 0x3c6ef372, d = 0xa54ff53a;
    uint32_t e = 0x510e527f, f = 0x9b05688c, g = 0x1f83d9ab, hh = 0x5be0cd19;
#pragma unroll
    for (int t = 0; t < 64; ++t) {
        uint32_t wt;
        if (t < 16) {
            wt = w[t];
        } else {
            const uint32_t w15 = w[(t - 15) & 15], w2 = w[(t - 2) & 15];
            const uint32_t s0 = rotr(w15, 7) ^ rotr(w15, 18) ^ (w15 >> 3);
            const uint32_t s1 = rotr(w2, 17) ^ rotr(w2, 19) ^ (w2 >> 10);
            wt = w[t & 15] + s0 + w[(t - 7) & 15] + s1;
            w[t & 15] = wt;
        }
        const uint32_t S1 = rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25);
        const uint32_t ch = (e & f) ^ (~e & g);
        const uint32_t t1 = hh + S1 + ch + kSha256K[t] + wt;
        const uint32_t S0 = rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22);
        const uint32_t mj = (a & b) ^ (a & c) ^ (b & c);
        const uint32_t t2 = S0 + mj;
        hh = g; g = f; f = e; e = d + t1;
        d = c; c = b; b = a; a = t1 + t2;
    }
    h[0] = 0x6a09e667 + a; h[1] = 0xbb67ae85 + b; h[2] = 0x3c6ef372 + c;
    h[3] = 0xa54ff53a + d; h[4] = 0x510e527f + e; h[5] = 0x9b05688c + f;
    h[6] = 0x1f83d9ab + g; h[7] = 0x5be0cd19 + hh;
}

__global__ void generators_kernel(const uint32_t* __restrict__ block,
                                  int label_len, int64_t start, int64_t n,
                                  uint64_t* __restrict__ out, uint64_t p,
                                  uint64_t np, uint64_t r2) {
    ZK_GRID_LOOP(i, n) {
        const uint64_t idx = (uint64_t)(start + i);
        uint32_t w[16];
#pragma unroll
        for (int k = 0; k < 16; ++k) w[k] = block[k];
#pragma unroll
        for (int k = 0; k < 8; ++k) {
            const int pos = label_len + k;
            const uint32_t byte = (uint32_t)(idx >> (8 * k)) & 0xffu;
            w[pos >> 2] |= byte << (24 - 8 * (pos & 3));
        }
        uint32_t h[8];
        sha256_block(w, h);
        // digest bytes read as a little-endian integer: 64-bit word j holds
        // bytes 8j..8j+7, i.e. byte-swapped H[2j] low and H[2j+1] high
        uint64_t v = 0;
#pragma unroll
        for (int j = 3; j >= 0; --j) {
            const uint64_t word = (uint64_t)bswap32(h[2 * j])
                                  | ((uint64_t)bswap32(h[2 * j + 1]) << 32);
            v = add_mod64(mont_mul64(v, r2, p, np), word % p, p);
        }
        if (v < 2) v = 2;
        const uint64_t tm = mont_mul64(v, r2, p, np);       // t * R
        out[i] = mont_mul64(tm, tm, p, np);                  // t^2 * R
    }
}

extern "C" int zk_derive_generators(const void* block, int label_len,
                                    int64_t start, int64_t n, void* out,
                                    uint64_t p, uint64_t np, uint64_t r2,
                                    void* stream) {
    if (n <= 0) return 0;
    const int threads = 256;
    generators_kernel<<<zk_blocks(n, threads), threads, 0,
                        (cudaStream_t)stream>>>(
        (const uint32_t*)block, label_len, start, n, (uint64_t*)out, p, np,
        r2);
    return (int)cudaGetLastError();
}
