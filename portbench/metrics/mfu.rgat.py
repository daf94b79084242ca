"""The whole step's share of the H100's 67 TFLOP/s float32 peak: the
least operations of every window step (bounds.py) over the peak times the
window's length."""
from portbench.readers import window_mfu


def read(rec):
    return window_mfu(rec)
