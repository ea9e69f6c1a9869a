"""What a cell's timed window drives: one module per driver, named in
the cell's file, each with ``run(ctx) -> dict`` (see `zkbench.harness`
for the context and the dict it returns)."""
