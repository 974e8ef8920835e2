"""The training step's backward pass, the remat layers' recompute in it
(the range ``train.backward`` that ``training/loop.py`` opens on the
caller's thread and on autograd's device thread, which launches the
backward's kernels): device ms a training step in the profiled
sub-window."""


def read(run):
    prof = run.profile
    s = prof["ranges"].get("train.backward")
    if not prof["complete"] or not s:
        return None
    return 1e3 * s / prof["steps"]
