"""Training objectives (``core/losses.py``).

Paper scale: MSE on fhat (the paper's §4 training), with an optional
safety hinge on f - u for the regime where t is learned rather than sized
by Prop 2.  LM scale: the server tower's next-token cross entropy, the
paper's approximation term MSE(fhat, f), the learned safety hinge on
u < f, the MoE load-balance loss and DeepSeek's MTP term.

On a DeviceMesh (DTensor logits and batch) every mean is over the global
batch, as DTensor reduces a mean over a split dim.  Logits split on the
vocab over ``model`` take the vocab-parallel cross entropy (no rank
holds a row's whole vocab); otherwise the label gather runs on each
rank's own rows (``distributed.sharding.batch_local``)."""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import (batch_local, is_dtensor,
                                              reduce_from, row_placements)


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
    if vocab_split(logits):
        return -torch.mean(_vocab_parallel_ll(logits, labels))
    logp = torch.log_softmax(logits.float(), dim=-1)
    ll = batch_local(lambda lp, lab: torch.gather(
        lp, -1, lab.long()[..., None])[..., 0], logp, labels)
    return -torch.mean(ll)


def vocab_split(logits) -> bool:
    """A DTensor of logits split over a ``model`` dim wider than one on its
    last (vocab) dim."""
    if not is_dtensor(logits):
        return False
    names = list(logits.device_mesh.mesh_dim_names)
    if "model" not in names:
        return False
    i = names.index("model")
    pl = logits.placements[i]
    return (logits.device_mesh.size(i) > 1 and pl.is_shard()
            and pl.dim in (logits.dim() - 1, -1))


def _vocab_parallel_ll(logits, labels):
    """Each label's log-probability from logits split on the vocab over
    ``model`` (megatron's vocab-parallel cross entropy): the row maximum,
    the sum of exponentials and the label's logit each combined by one
    all-reduce over ``model``, so no rank holds a row's whole vocab."""
    import torch.distributed as dist
    from torch.distributed.tensor import Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = logits.device_mesh
    names = list(mesh.mesh_dim_names)
    group = mesh.get_group("model")
    rows = row_placements(labels)
    lg = [Shard(logits.dim() - 1) if n == "model" else rows[i]
          for i, n in enumerate(names)]

    def body(lf, lab):
        lf = lf.float()
        lo = mesh.get_local_rank("model") * lf.shape[-1]
        with torch.no_grad():
            m = lf.amax(dim=-1, keepdim=True)
            dist.all_reduce(m, op=dist.ReduceOp.MAX, group=group)
        se = reduce_from(torch.exp(lf - m).sum(dim=-1), group)
        idx = lab.long() - lo
        mine = (idx >= 0) & (idx < lf.shape[-1])
        picked = torch.gather(lf, -1, torch.where(mine, idx, 0)[..., None])
        picked = reduce_from(picked[..., 0] * mine.to(lf.dtype), group)
        return picked - m[..., 0] - torch.log(se)

    return local_map(body, out_placements=rows, in_placements=(lg, rows),
                     in_grad_placements=(lg, rows), device_mesh=mesh,
                     redistribute_inputs=True)(logits, labels)


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
        mtp_labels = batch_local(lambda lab: torch.roll(lab, -1, 1), labels)
        mtp = cross_entropy(out["mtp_logits"][:, :-2], mtp_labels[:, :-2])
        total = total + mtp_weight * mtp
        parts["mtp"] = mtp
    parts["total"] = total
    return parts
