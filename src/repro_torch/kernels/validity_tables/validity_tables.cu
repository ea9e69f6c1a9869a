// zkReLU eq. (19) validity tables, both statements in one launch.
//
// Replaces src/repro/kernels/validity_tables/kernel.py:106
// (validity_tables_planes, body _tables_body:40).  Per flat (row, bit)
// position p:
//     bit   = (vals >> shift) & 1
//     z_sel = region ? z_main : z_rem
//     a     = [bit] + kmask * k - z_sel
//     b     = es + (z_sel - ([(1-bit)(1-colmask)] + kpmask * k)) * e_full
// where [x] is the Montgomery ONE when the 0/1 integer x is set.  All
// scalars arrive by value in Montgomery form.
//
// Bound on the card: memory -- six 4-byte position planes and two
// 8-byte field tables in, two 8-byte tables out (56 bytes per position)
// against one Montgomery multiply -- so the kernel is a single coalesced
// pass with the bit decomposition done in registers.
#include "mont64.cuh"

__global__ void validity_tables_kernel(
    const int32_t* __restrict__ vals, const int32_t* __restrict__ shift,
    const int32_t* __restrict__ kmask, const int32_t* __restrict__ kpmask,
    const int32_t* __restrict__ colmask, const int32_t* __restrict__ region,
    const uint64_t* __restrict__ e_full, const uint64_t* __restrict__ es,
    uint64_t* __restrict__ a_out, uint64_t* __restrict__ b_out, int64_t n,
    uint64_t one, uint64_t k, uint64_t zm, uint64_t zr, uint64_t m,
    uint64_t np) {
    ZK_GRID_LOOP(p, n) {
        const uint32_t bit = ((uint32_t)vals[p] >> (uint32_t)shift[p]) & 1u;
        const uint64_t zsel = region[p] ? zm : zr;
        const uint64_t a = sub_mod64(
            add_mod64(bit ? one : 0, kmask[p] ? k : 0, m), zsel, m);
        const uint32_t nb = (1u - bit) * (uint32_t)(1 - colmask[p]);
        const uint64_t negbp = add_mod64(nb ? one : 0, kpmask[p] ? k : 0, m);
        const uint64_t b = add_mod64(
            es[p], mont_mul64(sub_mod64(zsel, negbp, m), e_full[p], m, np), m);
        a_out[p] = a;
        b_out[p] = b;
    }
}

extern "C" int zk_validity_tables(
    const void* vals, const void* shift, const void* kmask,
    const void* kpmask, const void* colmask, const void* region,
    const void* e_full, const void* es, void* a_out, void* b_out, int64_t n,
    uint64_t one, uint64_t k, uint64_t zm, uint64_t zr, uint64_t m,
    uint64_t np, void* stream) {
    if (n <= 0) return 0;
    const int threads = 256;
    validity_tables_kernel<<<zk_blocks(n, threads), threads, 0,
                             (cudaStream_t)stream>>>(
        (const int32_t*)vals, (const int32_t*)shift, (const int32_t*)kmask,
        (const int32_t*)kpmask, (const int32_t*)colmask,
        (const int32_t*)region, (const uint64_t*)e_full,
        (const uint64_t*)es, (uint64_t*)a_out, (uint64_t*)b_out, n, one, k,
        zm, zr, m, np);
    return (int)cudaGetLastError();
}
