"""The qmatmul kernel's share of its roofline: the least time of every
exact product the traced steps need (`work.counts.qmatmul_step_bound_s`,
each call bounded on its own) over the kernel's device time."""
from zkbench import tracing
from zkbench.work import counts

KERNEL = "qmatmul_kernel"


def read(record):
    trace = record["trace"]
    if trace is None:
        return None
    launches, secs = tracing.kernel_seconds(trace, KERNEL)
    if not launches or secs <= 0:
        return None
    steps = sum(len(c["step_s"]) for c in record["cycles"] if c["traced"])
    return 100 * steps * counts.qmatmul_step_bound_s(
        record["geometry"]) / secs
