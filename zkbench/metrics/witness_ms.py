"""Seconds of the trainer's integer SGD step (the witness), host clock
synchronised around each step: all steps' time over all steps, in ms."""
from zkbench.metrics import untraced



def read(record):
    steps = [s for c in untraced(record) for s in c["step_s"]]
    return 1e3 * sum(steps) / len(steps) if steps else None
