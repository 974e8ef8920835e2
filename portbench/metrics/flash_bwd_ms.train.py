"""The flash attention backward (tensor ops, the range
``flash_attention_backward`` that ``kernels/ops.py`` opens): device ms a
training step in the profiled sub-window."""


def read(run):
    prof = run.profile
    s = prof["ranges"].get("flash_attention_backward")
    if not prof["complete"] or not s:
        return None
    return 1e3 * s / prof["steps"]
