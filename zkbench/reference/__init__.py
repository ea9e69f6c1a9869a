"""The plain reference the benchmark holds the program to: the integer
SGD step of the quantised FCNN (`sgd`) and an independent reading of a
proof's bytes against the reference's own witness (`proofcheck`).
Plain PyTorch and the standard library only: nothing here imports the
program, JAX or the JAX package."""
