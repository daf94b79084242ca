"""The hand-written kernels' launches a traced step, from the program's
``trainer.step`` span counters (rgat_readers.kernel_launches)."""
from portbench.rgat_readers import kernel_launches


def read(rec):
    return kernel_launches(rec)
