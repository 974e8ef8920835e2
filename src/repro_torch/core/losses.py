"""Training objectives (``core/losses.py``).

Paper scale: MSE on fhat (the paper's §4 training), with an optional
safety hinge on f - u for the regime where t is learned rather than sized
by Prop 2.  LM scale: the server tower's next-token cross entropy, the
paper's approximation term MSE(fhat, f) and the learned safety hinge on
u < f."""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F


def paper_loss(out: Dict[str, torch.Tensor], f: torch.Tensor, *,
               safety_weight: float = 0.0,
               margin: float = 0.0) -> torch.Tensor:
    """MSE(fhat, f) + safety_weight * E[relu(f - u + margin)^2]."""
    loss = torch.mean((out["fhat"] - f) ** 2)
    if safety_weight:
        viol = F.relu(f - out["u"] + margin)
        loss = loss + safety_weight * torch.mean(viol ** 2)
    return loss


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean next-token cross entropy over all positions; logits (B, S, V)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    ll = torch.gather(logp, -1, labels.long()[..., None])[..., 0]
    return -torch.mean(ll)


# weight of the MoE load-balance loss, the reference's default (0 for the
# dense backbones the port trains)
AUX_WEIGHT = 0.01


def collab_lm_loss(out: Dict[str, torch.Tensor], batch, *,
                   monitor_weight: float = 1.0,
                   safety_weight: float = 10.0) -> Dict[str, torch.Tensor]:
    """The reference's joint objective (ref :38) at its default aux weight
    and hinge margin 0, dense part: the MTP term comes with the MoE family
    (ROADMAP queue 1, item 7).

    lm      : next-token CE of the server tower
    monitor : MSE(fhat, monitor_target), the paper's approximation term
    safety  : hinge on u < f, the paper's safety requirement in learned form
    aux     : MoE load balance (0 for dense backbones)
    """
    lm = cross_entropy(out["logits"], batch["labels"])
    f = batch["monitor_target"].float()
    monitor = torch.mean((out["fhat"] - f) ** 2)
    safety = torch.mean(F.relu(f - out["u"]) ** 2)
    total = (lm + monitor_weight * monitor + safety_weight * safety
             + AUX_WEIGHT * out["aux_loss"])
    return {"lm": lm, "monitor": monitor, "safety": safety,
            "aux": out["aux_loss"], "total": total}
