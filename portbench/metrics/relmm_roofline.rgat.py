"""The grouped GEMMs' (forward, d_msg and dW) least time over their device
time in the traced steps (rgat_readers.relmm_roofline)."""
from portbench.rgat_readers import relmm_roofline


def read(rec):
    return relmm_roofline(rec)
