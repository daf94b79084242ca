"""Host ms the program's sampler takes for one batch, on the Trainer's
prefetch thread, averaged over the window's batches."""
from portbench.readers import host_mean_ms


def read(rec):
    return host_mean_ms(rec, "sample_s")
