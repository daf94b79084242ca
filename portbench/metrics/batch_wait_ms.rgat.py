"""Host ms between one ``train_step`` return and the next call: what the
Trainer's loop spent waiting for a batch and driving, a window step's
mean."""
from portbench.readers import host_mean_ms


def read(rec):
    return host_mean_ms(rec, "wait_s")
