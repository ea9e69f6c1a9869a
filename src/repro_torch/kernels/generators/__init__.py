from repro_torch.kernels.generators.ops import (  # noqa: F401
    MAX_LABEL_BYTES, derive, derive_plain)
