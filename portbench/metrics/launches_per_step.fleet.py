"""Device kernels a fleet step launches (eager dispatch of the edge tower
and of every catch-up round), from the profiled sub-window's trace."""


def read(run):
    prof = run.profile
    if not prof["complete"]:
        return None
    return prof["kernels"] / prof["steps"]
