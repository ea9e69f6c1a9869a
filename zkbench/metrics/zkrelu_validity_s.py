"""The zkReLU validity statement's preparation, seconds per proof (the
``zkrelu-validity`` sub-phase of `ProofSession.last_profile`)."""
from zkbench.metrics import profile_mean



def read(record):
    return profile_mean(record, "sub_phases_s", "zkrelu-validity")
