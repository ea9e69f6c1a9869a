"""The merged pair IPA's L/R rounds, seconds per proof (the
``ipa-rounds`` sub-phase of `ProofSession.last_profile`)."""
from zkbench.metrics import profile_mean



def read(record):
    return profile_mean(record, "sub_phases_s", "ipa-rounds")
