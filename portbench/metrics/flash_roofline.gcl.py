"""The InfoNCE denominator kernels' least time over their device time in
the traced steps (readers.flash_roofline)."""
from portbench.readers import flash_roofline


def read(rec):
    return flash_roofline(rec)
