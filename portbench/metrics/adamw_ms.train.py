"""The optimizer (the range ``adamw_update`` that
``training/optimizer.py`` opens: clipping, moments, masters, the cast
back): device ms a training step in the profiled sub-window."""


def read(run):
    prof = run.profile
    s = prof["ranges"].get("adamw_update")
    if not prof["complete"] or not s:
        return None
    return 1e3 * s / prof["steps"]
