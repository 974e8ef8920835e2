"""The collaborative model in plain float32 PyTorch.

Written from the architecture as the port defines it (see the
configuration files' ``assumed``): a pre-norm decoder of GQA attention
with half-split rotary embeddings and SwiGLU feed-forward (granite), or
Mamba2 layers with one shared attention + MLP block after every
``shared_attn_every`` of them (zamba2: the SSD recurrence evaluated in
chunks of ``CHUNK`` rows, y = (SSD(x) + D x) * silu(z) * norm_scale, no
gated norm); the edge tower, a small decoder over a 1024-token window;
u = sum_i a_i tanh(w_feat h)_i + softplus(raw_t); v = w_v . h + b_v;
fhat = u - s sigmoid(v).

Every function takes ``W``, a callable from a leaf name to its float32
tensor.  Activations stay float32 throughout; only ``prec="fp8"``
(the control) rounds the operands of each product.  Attention runs a
block of query rows at a time; with autograd on, each block and each
layer is recomputed in the backward (``torch.utils.checkpoint``) so the
reference fits beside nothing else on the card."""
from __future__ import annotations

import math
from typing import Callable, Dict

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from portbench import spec

CHUNK = 64           # SSD chunk (the result does not depend on it)
SCORE_BYTES = 1 << 29  # the most one block of attention scores may take
FP8_MAX = 448.0      # float8 e4m3's largest finite value

Weights = Callable[[str], torch.Tensor]


def fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """x rounded to float8 e4m3 with one scale per slice along ``dim``
    (the amax of the slice maps to 448), back in float32; the rounding
    is a straight-through step for autograd."""
    amax = x.detach().abs().amax(dim=dim, keepdim=True).clamp(min=1e-30)
    scale = FP8_MAX / amax
    q = (x.detach() * scale).to(torch.float8_e4m3fn).float() / scale
    return x + (q - x.detach())


def mm(x: torch.Tensor, w: torch.Tensor, prec: str) -> torch.Tensor:
    if prec == "fp8":
        return fp8(x, -1) @ fp8(w, 0)
    return x @ w


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (B, S, H, D) at positions 0..S-1, half-split pairs."""
    S, D = x.shape[1], x.shape[-1]
    half = D // 2
    inv = 1.0 / theta ** (torch.arange(half, dtype=torch.float32,
                                       device=x.device) / half)
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] * inv
    cos, sin = torch.cos(ang)[None, :, None], torch.sin(ang)[None, :, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _attend_block(q, k, v, q0: int, window: int, prec: str):
    """Rows q0.. of causal attention.  q (B, H, s, D), k, v (B, H, T, D)."""
    s, T, D = q.shape[2], k.shape[2], q.shape[3]
    if prec == "fp8":
        q, k, v = fp8(q, -1), fp8(k, -1), fp8(v, -2)
    scores = (q @ k.transpose(-1, -2)) / math.sqrt(D)
    rows = torch.arange(q0, q0 + s, device=q.device)[:, None]
    cols = torch.arange(T, device=q.device)[None, :]
    ok = cols <= rows
    if window:
        ok = ok & (cols > rows - window)
    p = torch.softmax(scores.masked_fill(~ok, -math.inf), dim=-1)
    if prec == "fp8":
        p = fp8(p, -1)
    return p @ v


def attention(q, k, v, window: int, prec: str) -> torch.Tensor:
    """Causal GQA attention; q (B, S, Hq, D), k, v (B, S, Hkv, D) ->
    (B, S, Hq, D).  Query head h reads kv head h // (Hq / Hkv)."""
    B, S, Hq, D = q.shape
    G = Hq // k.shape[2]
    qh = q.permute(0, 2, 1, 3)
    kh = k.permute(0, 2, 1, 3).repeat_interleave(G, dim=1)
    vh = v.permute(0, 2, 1, 3).repeat_interleave(G, dim=1)
    rows = max(1, min(S, SCORE_BYTES // (4 * B * Hq * S)))
    out = []
    for q0 in range(0, S, rows):
        qb = qh[:, :, q0:q0 + rows]
        hi = q0 + qb.shape[2]
        args = (qb, kh[:, :, :hi], vh[:, :, :hi], q0, window, prec)
        out.append(checkpoint(_attend_block, *args, use_reentrant=False)
                   if torch.is_grad_enabled() else _attend_block(*args))
    return torch.cat(out, dim=2).permute(0, 2, 1, 3)


def block(W: Weights, pre: str, h: torch.Tensor, t: dict, window: int,
          prec: str) -> torch.Tensor:
    """One pre-norm attention + SwiGLU block on h (B, S, d)."""
    B, S, d = h.shape
    hd, hq, hkv = spec.head_dim(t), t["n_heads"], t["n_kv_heads"]
    x = rmsnorm(h, W(f"{pre}.ln_attn.scale"), t["norm_eps"])
    q = mm(x, W(f"{pre}.attn.wq.w"), prec).view(B, S, hq, hd)
    k = mm(x, W(f"{pre}.attn.wk.w"), prec).view(B, S, hkv, hd)
    v = mm(x, W(f"{pre}.attn.wv.w"), prec).view(B, S, hkv, hd)
    o = attention(rope(q, t["rope_theta"]), rope(k, t["rope_theta"]), v,
                  window, prec)
    h = h + mm(o.reshape(B, S, hq * hd), W(f"{pre}.attn.wo.w"), prec)
    x = rmsnorm(h, W(f"{pre}.ln_mlp.scale"), t["norm_eps"])
    g = F.silu(mm(x, W(f"{pre}.mlp.w_gate.w"), prec))
    g = g * mm(x, W(f"{pre}.mlp.w_up.w"), prec)
    return h + mm(g, W(f"{pre}.mlp.w_down.w"), prec)


def causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor):
    """Depthwise causal conv over the sequence: x (B, S, C), w (K, C)."""
    K, S = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, K - 1, 0))
    return sum(xp[:, i:i + S] * w[i] for i in range(K)) + b


def ssd(x, dt, A, Bm, Cm) -> torch.Tensor:
    """y_t = sum_{s<=t} C_t . B_s exp(sum_{s<r<=t} dt_r A) dt_s x_s, by
    chunks of CHUNK rows: within a chunk the pairwise decays, across
    chunks the carried state.  x (B, S, H, P), dt (B, S, H), A (H,),
    Bm, Cm (B, S, N) -> (B, S, H, P)."""
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    L = CHUNK if S % CHUNK == 0 else S
    c = S // L
    la = (dt * A).view(Bsz, c, L, H)
    xdt = (x * dt[..., None]).view(Bsz, c, L, H, P)
    Bc, Cc = Bm.view(Bsz, c, L, N), Cm.view(Bsz, c, L, N)
    cum = torch.cumsum(la, dim=2)                                # (B,c,L,H)
    tri = torch.tril(torch.ones(L, L, dtype=torch.bool, device=x.device))
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]          # t, s
    decay = torch.exp(seg.masked_fill(~tri[None, None, :, :, None], -math.inf))
    cb = torch.einsum("bctn,bcsn->bcts", Cc, Bc)
    y = torch.einsum("bctsh,bcshp->bcthp", cb[..., None] * decay, xdt)
    to_end = torch.exp(cum[:, :, -1:, :] - cum)                  # (B,c,L,H)
    states = torch.einsum("bcshp,bcsn->bchpn", to_end[..., None] * xdt, Bc)
    carry = torch.exp(cum[:, :, -1, :])                          # (B,c,H)
    h = torch.zeros(Bsz, H, P, N, dtype=x.dtype, device=x.device)
    entering = []
    for i in range(c):
        entering.append(h)
        h = carry[:, i, :, None, None] * h + states[:, i]
    h_in = torch.stack(entering, dim=1)                          # (B,c,H,P,N)
    y = y + torch.einsum("bctn,bchpn->bcthp", Cc, h_in) * torch.exp(
        cum)[..., None]
    return y.reshape(Bsz, S, H, P)


def mamba(W: Weights, pre: str, h: torch.Tensor, p: dict,
          prec: str) -> torch.Tensor:
    """One pre-norm residual Mamba2 layer on h (B, S, d)."""
    B, S, _ = h.shape
    s = spec.ssm_dims(p)
    m = f"{pre}.mamba"
    x = rmsnorm(h, W(f"{pre}.ln.scale"), p["norm_eps"])
    z = mm(x, W(f"{m}.w_z.w"), prec)
    xs = F.silu(causal_conv(mm(x, W(f"{m}.w_x.w"), prec),
                            W(f"{m}.conv_x.w"), W(f"{m}.conv_x.b")))
    Bm = F.silu(causal_conv(mm(x, W(f"{m}.w_B.w"), prec),
                            W(f"{m}.conv_B.w"), W(f"{m}.conv_B.b")))
    Cm = F.silu(causal_conv(mm(x, W(f"{m}.w_C.w"), prec),
                            W(f"{m}.conv_C.w"), W(f"{m}.conv_C.b")))
    dt = F.softplus(mm(x, W(f"{m}.w_dt.w"), prec) + W(f"{m}.dt_bias"))
    A = -torch.exp(W(f"{m}.A_log"))
    xh = xs.view(B, S, s["H"], s["P"])
    if prec == "fp8":
        xh, Bm, Cm = fp8(xh, -1), fp8(Bm, -1), fp8(Cm, -1)
    y = ssd(xh, dt, A, Bm, Cm) + W(f"{m}.D")[:, None] * xh
    y = y.reshape(B, S, s["d_in"]) * F.silu(z) * W(f"{m}.norm_scale")
    return h + mm(y, W(f"{m}.out_proj.w"), prec)


def _layer(fn, *args):
    return (checkpoint(fn, *args, use_reentrant=False)
            if torch.is_grad_enabled() else fn(*args))


def layers(p: dict, tower: str):
    """(kind, weight prefix) of every layer of a tower, in order."""
    if tower == "edge" or p["family"] == "dense":
        t = spec.edge_block(p) if tower == "edge" else p
        n = t["n_layers"]
        return [("block", f"{tower}.blocks.{i}") for i in range(n)]
    n_super, k, tail = spec.hybrid_layout(p)
    out = []
    for s in range(n_super):
        out += [("mamba", f"server.mamba_blocks.{s}.{j}") for j in range(k)]
        out.append(("block", "server.shared"))
    return out + [("mamba", f"server.tail.{i}") for i in range(tail)]


def apply_layer(W: Weights, kind: str, pre: str, h: torch.Tensor, p: dict,
                tower: str, prec: str) -> torch.Tensor:
    if kind == "mamba":
        return _layer(lambda x: mamba(W, pre, x, p, prec), h)
    t = spec.edge_block(p) if tower == "edge" else p
    window = t.get("window", 0)
    return _layer(lambda x: block(W, pre, x, t, window, prec), h)


def tower_hidden(W: Weights, p: dict, tower: str, tokens: torch.Tensor,
                 prec: str = "f32") -> torch.Tensor:
    """The final-norm hidden states (B, S, d) of the server or the edge
    over tokens (B, S)."""
    h = W(f"{tower}.embed.table")[tokens]
    for kind, pre in layers(p, tower):
        h = apply_layer(W, kind, pre, h, p, tower, prec)
    return rmsnorm(h, W(f"{tower}.ln_f.scale"), p["norm_eps"])


def u_score(W: Weights, p: dict, edge_h: torch.Tensor) -> torch.Tensor:
    feats = torch.tanh(edge_h @ W("u_head.w_feat.w"))
    return feats @ W("u_head.a") + F.softplus(W("u_head.raw_t"))


def v_score(W: Weights, server_h: torch.Tensor) -> torch.Tensor:
    return server_h @ W("v_head.w")[:, 0] + W("v_head.b")[0]


def collab_loss(W: Weights, p: dict, batch: Dict[str, torch.Tensor],
                weights: dict, prec: str = "f32") -> Dict[str, torch.Tensor]:
    """The joint objective: next-token cross entropy of the server's tied
    unembed, MSE(fhat, f), safety_weight * mean(relu(f - u)^2)."""
    m = p["monitor"]
    hs = tower_hidden(W, p, "server", batch["tokens"], prec)
    he = tower_hidden(W, p, "edge", batch["tokens"], prec)
    logits = mm(hs, W("server.embed.table").T, prec)
    lm = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                         batch["labels"].reshape(-1).long())
    u = u_score(W, p, he)
    fhat = u - m.get("s", 0.2) * torch.sigmoid(v_score(W, hs))
    f = batch["monitor_target"]
    monitor = torch.mean((fhat - f) ** 2)
    safety = torch.mean(F.relu(f - u) ** 2)
    total = (lm + weights["monitor_weight"] * monitor
             + weights["safety_weight"] * safety)
    return {"lm": lm, "monitor": monitor, "safety": safety, "total": total}
