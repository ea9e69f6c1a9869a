"""PyTorch + CUDA port of the zkDL prover (`repro`, the JAX package, is
the reference).

Field and group elements are one int64 word each, in Montgomery form
with R = 2^64 -- the same residue as the reference's four 16-bit limbs
(`repro_torch.interop` repacks between the two).  The hot products run
in hand-written sm_90a kernels (`repro_torch.kernels`); on CPU tensors
every kernel wrapper runs its plain PyTorch version instead.  Entry
points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""
