"""`verify_bytes` of each window's proof, host clock synchronised around
the call: all verifications' time over their count, in seconds."""
from zkbench.metrics import mean, untraced



def read(record):
    return mean([c["verify_s"] for c in untraced(record)])
