"""The benchmark of `repro_torch`, the PyTorch and CUDA port of the zkDL
prover: one command runs one cell (`zkbench/run.py`).  Configurations,
cells, drivers and per-layer metric readers are files found by name;
see `zkbench/README.md`."""
