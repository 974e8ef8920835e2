"""The training cells' reference: the first steps of the joint objective
with AdamW (global-norm clipping, bias-corrected moments, decoupled
weight decay) in float32, from the seeded weights, on the same batches.
Returns what the comparison reads: each step's loss, each leaf's norm of
the first (clipped) gradient, and each leaf's norm of the change in its
weight after the last step."""
from __future__ import annotations

from typing import Dict, List

import torch

from portbench import spec, weights
from portbench.reference import model


def initial(seed: int, p: dict, device) -> Dict[str, torch.Tensor]:
    out = {}
    for g, leaves in spec.groups(p).items():
        for k, v in weights.draw_group(seed, g, leaves, p, device).items():
            out[k] = v.float()
    return out


def run(seed: int, p: dict, batches: List[dict], opt: dict, loss_w: dict,
        device, prec: str = "f32") -> dict:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    params = {k: v.requires_grad_(True) for k, v in
              initial(seed, p, device).items()}
    names = list(params)
    m = {k: torch.zeros_like(v) for k, v in params.items()}
    v2 = {k: torch.zeros_like(v) for k, v in params.items()}
    losses, first_grad, first_raw = [], {}, {}
    for step, batch in enumerate(batches, start=1):
        b = {k: torch.as_tensor(x, device=device) for k, x in batch.items()}
        parts = model.collab_loss(params.__getitem__, p, b, loss_w, prec)
        parts["total"].backward()
        losses.append({k: float(x.detach()) for k, x in parts.items()})
        del parts
        with torch.no_grad():
            grads = [params[k].grad for k in names]
            norms = torch.stack([g.norm() for g in grads])
            gnorm = torch.sqrt(norms.square().sum() + 1e-12)
            scale = (torch.clamp(opt["clip_norm"] / gnorm, max=1.0)
                     if opt["clip_norm"] else torch.ones((), device=device))
            if step == 1:
                first_raw = dict(zip(names, norms.tolist()))
                first_grad = dict(zip(names, (norms * scale).tolist()))
            bc1 = 1.0 - opt["b1"] ** step
            bc2 = 1.0 - opt["b2"] ** step
            for k in names:
                w, g = params[k], params[k].grad * scale
                m[k].mul_(opt["b1"]).add_(g, alpha=1 - opt["b1"])
                v2[k].mul_(opt["b2"]).addcmul_(g, g, value=1 - opt["b2"])
                upd = (m[k] / bc1) / (torch.sqrt(v2[k] / bc2) + opt["eps"])
                if opt["weight_decay"]:
                    upd = upd + opt["weight_decay"] * w
                w.sub_(opt["lr"] * upd)
                w.grad = None
    del m, v2
    with torch.no_grad():
        delta = {}
        for g, leaves in spec.groups(p).items():
            w0 = weights.draw_group(seed, g, leaves, p, device)
            for k, x in w0.items():
                delta[k] = float((params[k] - x.float()).norm())
    return {"losses": losses, "first_grad": first_grad,
            "first_grad_raw": first_raw, "delta": delta}
