"""Host ms inside one ``train_step`` call (launching the step's work,
and blocking where the launch queue is full), a window step's mean."""
from portbench.readers import host_mean_ms


def read(rec):
    return host_mean_ms(rec, "dispatch_s")
