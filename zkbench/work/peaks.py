"""Published peaks of one NVIDIA H100 SXM (dense, no sparsity, at its
700 W limit), the yardstick of every roofline and `mfu` share."""

HBM_BYTES_PER_S = 3.35e12        # HBM3
INT8_OPS_PER_S = 1979e12         # int8 tensor cores
INT32_OPS_PER_S = 33.5e12        # 32-bit integer operations (CUDA cores)
#: 32-bit integer operations one 64-bit Montgomery product is counted as
MONT_MUL_INT32_OPS = 38
