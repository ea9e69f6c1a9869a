from repro_torch.kernels.msm.ops import (  # noqa: F401
    geometry, msm, msm_plain, msm_ragged)
