"""The prover's openings phase (step (c): claim folds, the merged pair
IPA, zkReLU validity), seconds per proof (`ProofSession.last_profile`)."""
from zkbench.metrics import profile_mean



def read(record):
    return profile_mean(record, "phases_s", "openings")
