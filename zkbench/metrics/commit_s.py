"""The prover's commitment phase, seconds per proof
(`ProofSession.last_profile`)."""
from zkbench.metrics import profile_mean



def read(record):
    return profile_mean(record, "phases_s", "commit")
