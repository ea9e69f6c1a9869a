"""The whole window's share of the chip's peak: the least time of the
work the protocol needs per aggregation window
(`work.counts.window_bound_s`: T steps' exact int8 products, the
commitments, the merged pair IPA and the verifier's final
multi-exponentiation) over the windows' host-clock time."""
from zkbench.metrics import untraced
from zkbench.work import counts



def read(record):
    cycles = untraced(record)
    secs = sum(c["cycle_s"] for c in cycles)
    if not cycles or secs <= 0:
        return None
    return 100 * len(cycles) * counts.window_bound_s(record["geometry"]) / secs
