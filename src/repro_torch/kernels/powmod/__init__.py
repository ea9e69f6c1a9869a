from repro_torch.kernels.powmod.ops import powmod, powmod_plain  # noqa: F401
