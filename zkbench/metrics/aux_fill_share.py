"""The share of a stacked aux tensor that holds real entries: 100 x the
unpadded elements over the stacked length (``aux_real`` and
``aux_stacked`` of the prover's ``counts``, `ProofSession.last_profile`).
Each layer's tensor is zero-padded to powers of two and every aux slot
to the widest layer's area, so a network of mixed widths commits,
opens and proves validity for zeros."""
from zkbench.metrics import mean, untraced


def read(record):
    return mean([100 * c["profile"]["counts"]["aux_real"]
                 / c["profile"]["counts"]["aux_stacked"]
                 for c in untraced(record)
                 if c["profile"] and "counts" in c["profile"]])
