"""The card's peak allocated memory over the fleet's window (weights,
the server's and the edge's caches, transients), GiB."""


def read(run):
    return run.peak_bytes / 2**30 if run.peak_bytes else None
