// Exact int16 matmul as four int8 digit products.
//
// zk_qmatmul_digits replaces src/repro/kernels/qmatmul/kernel.py:74
// (qmatmul_digits, body _qmatmul_body:45): with every int16 operand split
// into int8 digits x = 256 * x_hi + x_c + 128, one launch computes the four
// exact int32 products hh = Ah Bh, hc = Ah Bc, ch = Ac Bh, cc = Ac Bc.
// The wrapper (ops.py) adds the rank-1 row/column sums and assembles the
// int64 product.  Inputs: A digits (M, Kp) and B digits TRANSPOSED (N, Kp),
// int8 row-major, so four consecutive K digits of either operand are one
// 32-bit word and one __dp4a multiplies-and-adds them.  Kp is a multiple
// of the K tile (the wrapper pads K with int16 zeros, as the reference
// pads); ragged M and N edges are masked here.  |digit product| <= 2^14, so
// int32 sums are exact for Kp <= 2^17 (asserted by the wrapper).
//
// Bound on the card: 4 x 2MNK int8 operations; at the witness shapes
// (128 x 4096 x 4096) that is work for the int8 tensor cores, which this
// first kernel does not use: it is a shared-memory tiled __dp4a GEMM
// (64 x 64 outputs per block of 256 threads, each thread 4 x 4 outputs of
// all four products in registers, a K tile of 32 digits), bound by the
// dp4a issue rate.  mma.sync / wgmma is later work.
#include <cstdint>
#include <cuda_runtime.h>

#define QM_BM 64
#define QM_BN 64
#define QM_BKW 8                  // 32-bit words (4 digits each) per K tile
#define QM_LD (QM_BKW + 1)        // padded row: conflict-free column reads
#define QM_THREADS 256

__global__ void __launch_bounds__(QM_THREADS) qmatmul_digits_kernel(
    const int32_t* __restrict__ a_hi, const int32_t* __restrict__ a_c,
    const int32_t* __restrict__ b_hi, const int32_t* __restrict__ b_c,
    int32_t* __restrict__ hh, int32_t* __restrict__ hc,
    int32_t* __restrict__ ch, int32_t* __restrict__ cc, int64_t M,
    int64_t N, int64_t kw) {
    __shared__ int32_t sa_h[QM_BM][QM_LD], sa_c[QM_BM][QM_LD];
    __shared__ int32_t sb_h[QM_BN][QM_LD], sb_c[QM_BN][QM_LD];
    const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
    const int64_t m0 = (int64_t)blockIdx.y * QM_BM;
    const int64_t n0 = (int64_t)blockIdx.x * QM_BN;
    int32_t acc[4][4][4];         // [product][row][col]
#pragma unroll
    for (int p = 0; p < 4; ++p)
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[p][r][c] = 0;

    for (int64_t k0 = 0; k0 < kw; k0 += QM_BKW) {
        for (int t = threadIdx.x; t < QM_BM * QM_BKW; t += QM_THREADS) {
            const int row = t / QM_BKW, w = t % QM_BKW;
            const int64_t gm = m0 + row, gn = n0 + row;
            int32_t vh = 0, vc = 0;
            if (gm < M) {
                vh = a_hi[gm * kw + k0 + w];
                vc = a_c[gm * kw + k0 + w];
            }
            sa_h[row][w] = vh;
            sa_c[row][w] = vc;
            vh = vc = 0;
            if (gn < N) {
                vh = b_hi[gn * kw + k0 + w];
                vc = b_c[gn * kw + k0 + w];
            }
            sb_h[row][w] = vh;
            sb_c[row][w] = vc;
        }
        __syncthreads();
#pragma unroll
        for (int w = 0; w < QM_BKW; ++w) {
            int32_t ah[4], ac[4], bh[4], bc[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                ah[i] = sa_h[ty + 16 * i][w];
                ac[i] = sa_c[ty + 16 * i][w];
                bh[i] = sb_h[tx + 16 * i][w];
                bc[i] = sb_c[tx + 16 * i][w];
            }
#pragma unroll
            for (int r = 0; r < 4; ++r)
#pragma unroll
                for (int c = 0; c < 4; ++c) {
                    acc[0][r][c] = __dp4a(ah[r], bh[c], acc[0][r][c]);
                    acc[1][r][c] = __dp4a(ah[r], bc[c], acc[1][r][c]);
                    acc[2][r][c] = __dp4a(ac[r], bh[c], acc[2][r][c]);
                    acc[3][r][c] = __dp4a(ac[r], bc[c], acc[3][r][c]);
                }
        }
        __syncthreads();
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
            const int64_t gm = m0 + ty + 16 * r, gn = n0 + tx + 16 * c;
            if (gm < M && gn < N) {
                const int64_t o = gm * N + gn;
                hh[o] = acc[0][r][c];
                hc[o] = acc[1][r][c];
                ch[o] = acc[2][r][c];
                cc[o] = acc[3][r][c];
            }
        }
}

extern "C" int zk_qmatmul_digits(const void* a_hi, const void* a_c,
                                 const void* bt_hi, const void* bt_c,
                                 void* hh, void* hc, void* ch, void* cc,
                                 int64_t M, int64_t N, int64_t k_pad,
                                 void* stream) {
    if (M <= 0 || N <= 0) return 0;
    if (k_pad % (4 * QM_BKW) != 0) return (int)cudaErrorInvalidValue;
    const int64_t gx = (N + QM_BN - 1) / QM_BN, gy = (M + QM_BM - 1) / QM_BM;
    if (gy > 65535) return (int)cudaErrorInvalidValue;
    qmatmul_digits_kernel<<<dim3((unsigned)gx, (unsigned)gy), QM_THREADS, 0,
                            (cudaStream_t)stream>>>(
        (const int32_t*)a_hi, (const int32_t*)a_c, (const int32_t*)bt_hi,
        (const int32_t*)bt_c, (int32_t*)hh, (int32_t*)hc, (int32_t*)ch,
        (int32_t*)cc, M, N, k_pad / 4);
    return (int)cudaGetLastError();
}
