"""The matmul relations' batched sumchecks, seconds per proof: the
``sumcheck-fwd``, ``sumcheck-bwd`` and ``sumcheck-gw`` sub-phases of
`ProofSession.last_profile` summed, each over all of its family's shape
buckets."""
from zkbench.metrics import mean, untraced

SUB_PHASES = ("sumcheck-fwd", "sumcheck-bwd", "sumcheck-gw")


def read(record):
    sums = []
    for c in untraced(record):
        sub = (c["profile"] or {}).get("sub_phases_s", {})
        if all(k in sub for k in SUB_PHASES):
            sums.append(sum(sub[k] for k in SUB_PHASES))
    return mean(sums)
