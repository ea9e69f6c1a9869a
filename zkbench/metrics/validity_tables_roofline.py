"""The validity-tables kernel's share of its roofline: one launch's
least time per proof (`work.counts.validity_tables_bound_s`) over its
device time in the traced window."""
from zkbench import tracing
from zkbench.work import counts

KERNEL = "validity_tables_kernel"


def read(record):
    trace = record["trace"]
    if trace is None:
        return None
    launches, secs = tracing.kernel_seconds(trace, KERNEL)
    if not launches or secs <= 0:
        return None
    proofs = sum(1 for c in record["cycles"] if c["traced"])
    return 100 * proofs * counts.validity_tables_bound_s(
        record["geometry"]) / secs
