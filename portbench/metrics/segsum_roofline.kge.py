"""The segment-sum kernels' least time over their device time in the
traced steps (readers.segsum_roofline)."""
from portbench.readers import segsum_roofline


def read(rec):
    return segsum_roofline(rec)
