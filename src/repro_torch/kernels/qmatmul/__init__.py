from repro_torch.kernels.qmatmul.ops import (  # noqa: F401
    K_MAX, digit_operands, qmatmul_digits, qmatmul_digits_plain, qmatmul_i64,
    qmatmul_i64_plain, qmatmul_partials)
