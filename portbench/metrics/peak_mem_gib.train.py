"""The card's peak allocated memory over the training window (weights,
f32 masters and moments, gradients, remat's activations), GiB."""


def read(run):
    return run.peak_bytes / 2**30 if run.peak_bytes else None
