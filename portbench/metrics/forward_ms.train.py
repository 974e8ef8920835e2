"""The training step's forward and loss (the range ``train.forward`` that
``training/loop.py`` opens on the caller's thread): device ms a training
step in the profiled sub-window."""


def read(run):
    prof = run.profile
    s = prof["ranges"].get("train.forward")
    if not prof["complete"] or not s:
        return None
    return 1e3 * s / prof["steps"]
