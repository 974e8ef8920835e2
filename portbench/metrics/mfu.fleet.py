"""The fleet's useful model flops (the edge tower for every observation,
the server for every replayed token, each at its position) over the
window's seconds and the card's published bf16 peak, in %."""
from portbench import counts


def read(run):
    if run.window_s <= 0 or run.useful_flops <= 0:
        return None
    return 100.0 * run.useful_flops / (run.window_s
                                       * counts.PEAKS["bf16_flops"])
