"""The share of the profiled fleet sub-window in which no kernel, copy or
memset ran on the card, in %."""
from portbench import profiling


def read(run):
    return profiling.idle_share(run.profile)
