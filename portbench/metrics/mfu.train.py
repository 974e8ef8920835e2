"""Model flops of a training step (three times the forward of the server,
its unembed and both heads, and the edge tower; neither remat nor the
SSD backward's recompute counted) times the window's steps a second,
over the card's published bf16 peak, in %."""
from portbench import counts


def read(run):
    if run.window_s <= 0 or not run.steps:
        return None
    rate = run.steps / run.window_s
    return 100.0 * run.step_flops * rate / counts.PEAKS["bf16_flops"]
