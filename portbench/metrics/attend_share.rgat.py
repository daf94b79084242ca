"""The % of the traced steps' device time launched inside the forward's
``rgat.attend`` spans (rgat_readers.attend_share)."""
from portbench.rgat_readers import attend_share


def read(rec):
    return attend_share(rec)
