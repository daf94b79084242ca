"""The negative-score kernels' least time over their device time in the
traced steps (readers.negscore_roofline)."""
from portbench.readers import negscore_roofline


def read(rec):
    return negscore_roofline(rec)
