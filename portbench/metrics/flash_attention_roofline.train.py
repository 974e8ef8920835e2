"""The server's flash attention forward kernel against its bound: one
call at the cell's shape (causal, B x S, the server's heads; bf16 at the
published tensor-core rate), over the kernel's mean device time per call
in the profiled sub-window, in %."""
from portbench import counts, spec


def read(run):
    prof = run.profile
    p, mix = run.p, run.mix
    hd = spec.head_dim(p)
    durs = [s for n, s in prof["calls"].get("flash_attention", ())
            if f"<{hd}, {hd}>" in n]
    if not prof["complete"] or not durs:
        return None
    fl, nb = counts.flash_call(mix["batch"], mix["seq"], p["n_heads"],
                               p["n_kv_heads"], hd, hd, 0, 2)
    bound = counts.bound_s(fl, nb, counts.PEAKS["bf16_flops"])
    return 100.0 * bound / (sum(durs) / len(durs))
