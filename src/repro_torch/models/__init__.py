"""The model zoo on PyTorch: configs, layers, attention, SSM, MoE and the
transformer assembly (the reference's `repro.models`)."""
