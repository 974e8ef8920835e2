"""The SSD scan backward (the plain chunked form differentiated by
autograd, the range ``ssd_scan_backward`` that ``kernels/ops.py``
opens): device ms a training step in the profiled sub-window."""


def read(run):
    prof = run.profile
    s = prof["ranges"].get("ssd_scan_backward")
    if not prof["complete"] or not s:
        return None
    return 1e3 * s / prof["steps"]
