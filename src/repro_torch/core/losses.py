"""Training objectives (``core/losses.py``).

Paper scale: MSE on fhat (the paper's §4 training), with an optional
safety hinge on f - u for the regime where t is learned rather than sized
by Prop 2.  LM scale: the server tower's next-token cross entropy, the
paper's approximation term MSE(fhat, f), the learned safety hinge on
u < f, the MoE load-balance loss and DeepSeek's MTP term."""
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
    """Mean next-token cross entropy over all positions; logits (B, S, V)
    with labels (B, S), or the audio family's (B, S, K, V) with (B, S,
    K): the mean runs over every codebook too, as the reference's."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    ll = torch.gather(logp, -1, labels.long()[..., None])[..., 0]
    return -torch.mean(ll)


def collab_lm_loss(out: Dict[str, torch.Tensor], batch, *,
                   monitor_weight: float = 1.0, safety_weight: float = 10.0,
                   aux_weight: float = 0.01, mtp_weight: float = 0.3,
                   margin: float = 0.0) -> Dict[str, torch.Tensor]:
    """The reference's joint objective (ref :37).

    lm      : next-token CE of the server tower
    monitor : MSE(fhat, monitor_target), the paper's approximation term
    safety  : hinge on u < f (+ margin), the paper's safety requirement in
              learned form
    aux     : MoE load balance (0 for dense backbones)
    mtp     : with an MTP head (``out["mtp_logits"]``), the CE of the
              labels shifted one more step, the last two positions left
              out; added at ``mtp_weight``
    """
    labels = batch["labels"]
    lm = cross_entropy(out["logits"], labels)
    f = batch["monitor_target"].float()
    monitor = torch.mean((out["fhat"] - f) ** 2)
    safety = torch.mean(F.relu(f - out["u"] + margin) ** 2)
    total = (lm + monitor_weight * monitor + safety_weight * safety
             + aux_weight * out["aux_loss"])
    parts = {"lm": lm, "monitor": monitor, "safety": safety,
             "aux": out["aux_loss"]}
    if out.get("mtp_logits") is not None:
        mtp_labels = torch.roll(labels, -1, 1)
        mtp = cross_entropy(out["mtp_logits"][:, :-2], mtp_labels[:, :-2])
        total = total + mtp_weight * mtp
        parts["mtp"] = mtp
    parts["total"] = total
    return parts
