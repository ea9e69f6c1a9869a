from repro_torch.kernels.modmul.ops import modmul, modmul_plain  # noqa: F401
