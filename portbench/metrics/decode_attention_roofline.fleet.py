"""The server's decode attention against its bound: the least time the
card could take to read the keys and values that the active rows of every
catch-up round need (bytes, at the published memory rate), over the
device time of the server's decode_attention kernels in the profiled
sub-window, in %."""


def read(run):
    prof = run.profile
    if not prof["complete"]:
        return None
    tag = prof["decode_server"]
    t = sum(s for n, s in prof["calls"].get("decode_attention", ())
            if n.endswith(tag))
    if t <= 0 or prof["decode_bound_s"] <= 0:
        return None
    return 100.0 * prof["decode_bound_s"] / t
