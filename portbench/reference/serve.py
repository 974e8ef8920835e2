"""The fleet's reference scores: u and v at every position of every checked
stream, by whole causal forwards over the streams' tokens (what the
program's per-token decode and catch-up must equal), one layer at a time
with each layer's weights drawn again from the seed and dropped after
use, the streams in blocks so that activations stay small."""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from portbench import spec, weights
from portbench.reference import model

TOKENS_PER_BLOCK = 16384


class LayerWeights:
    """W(name) for one draw group at a time: the group of the last name
    asked is kept, the previous one dropped."""

    def __init__(self, seed: int, p: dict, device):
        self.seed, self.p, self.device = seed, p, device
        self.groups = spec.groups(p)
        self.group, self.vals = None, {}

    def __call__(self, name: str) -> torch.Tensor:
        g = spec.group_of(name)
        if g != self.group:
            self.vals = {}   # drop the last group before drawing the next
            self.vals = {k: v.float() for k, v in weights.draw_group(
                self.seed, g, self.groups[g], self.p, self.device).items()}
            self.group = g
        return self.vals[name]


@torch.no_grad()
def scores(seed: int, p: dict, tokens: np.ndarray, device,
           prec: str = "f32") -> Tuple[np.ndarray, np.ndarray]:
    """tokens (n, T) -> (u (n, T), v (n, T)) as float64 numpy."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    W = LayerWeights(seed, p, device)
    n, T = tokens.shape
    rows = max(1, TOKENS_PER_BLOCK // T)
    tok = torch.as_tensor(tokens, device=device)
    blocks = [slice(i, min(n, i + rows)) for i in range(0, n, rows)]
    out: Dict[str, np.ndarray] = {}
    for tower in ("edge", "server"):
        hs = [W(f"{tower}.embed.table")[tok[b]] for b in blocks]
        for kind, pre in model.layers(p, tower):
            hs = [model.apply_layer(W, kind, pre, h, p, tower, prec)
                  for h in hs]
        hs = [model.rmsnorm(h, W(f"{tower}.ln_f.scale"), p["norm_eps"])
              for h in hs]
        if tower == "edge":
            sc = [model.u_score(W, p, h) for h in hs]
        else:
            sc = [model.v_score(W, h) for h in hs]
        out[tower] = torch.cat(sc).double().cpu().numpy()
        del hs, sc
    return out["edge"], out["server"]
