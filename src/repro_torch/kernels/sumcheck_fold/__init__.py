from repro_torch.kernels.sumcheck_fold.ops import (  # noqa: F401
    fold, fold_halves, fold_halves_plain, fold_plain, pow_mul_halves,
    pow_mul_plain)
