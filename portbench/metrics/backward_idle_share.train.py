"""The card's idle time while the caller's thread waits in the backward
pass (the gaps that ``profiling.summarize`` puts down to the range
``train.backward`` of ``training/loop.py``), as a share of the profiled
sub-window, in %.

``idle_gaps`` keeps the 10 largest names: a name missing from a shorter
list had no gap (0), one missing from a full list is unknown.  A program
whose trace has no ``train.backward`` range reads nothing."""

NAME = "train.backward"
KEPT = 10   # the names ``profiling.summarize`` keeps in ``idle_gaps``


def read(run):
    prof = run.profile
    if not prof["complete"] or prof["window_s"] <= 0 \
            or NAME not in prof["ranges"]:
        return None
    gaps = dict(prof["idle_gaps"])
    if NAME in gaps:
        return 100.0 * gaps[NAME] / prof["window_s"]
    return 0.0 if len(gaps) < KEPT else None
