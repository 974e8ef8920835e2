"""The SSD scan kernels (its two device kernels a call) against their
bound: one call at the cell's shape (f32 inputs and outputs; the
operations at the published TF32 tensor-core rate), over the mean device
time of a call in the profiled sub-window, in %."""
from portbench import counts, spec


def read(run):
    prof = run.profile
    chunk = [s for _, s in prof["calls"].get("ssd_scan", ())]
    prep = [s for _, s in prof["calls"].get("ssd_prep", ())]
    if not prof["complete"] or not chunk or len(prep) != len(chunk):
        return None
    s = spec.ssm_dims(run.p)
    fl, nb = counts.ssd_call(run.mix["batch"], run.mix["seq"], s["H"],
                             s["P"], s["N"], run.p.get("ssm_chunk", 128))
    bound = counts.bound_s(fl, nb, counts.PEAKS["tf32_flops"])
    return 100.0 * bound / ((sum(chunk) + sum(prep)) / len(chunk))
