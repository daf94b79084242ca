"""The share of the traced steps' time in which no device operation ran
(torch.profiler's device events)."""
from portbench.readers import idle_share


def read(rec):
    return idle_share(rec)
