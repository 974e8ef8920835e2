"""Operations and bytes that the work needs, counted from shapes, and the
published peaks they are held to (``peaks.json``).  Frozen copies of the
port's arithmetic (``attention_pairs`` from ``kernels/ops.py``,
``ssd_flops`` from ``kernels/ssm_scan.py``) so that a later change to
the program cannot move the yardstick.  Imports nothing of the program.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Iterable, Tuple

from portbench import spec

PEAKS = json.loads((Path(__file__).with_name("peaks.json")).read_text())


def bound_s(flops: float, n_bytes: float, peak_flops: float) -> float:
    """The least time the card could take: the larger of the operations
    over the peak rate and the bytes over the memory rate."""
    return max(flops / peak_flops, n_bytes / PEAKS["hbm_bytes_per_s"])


def attention_pairs(S: int, T: int, window: int) -> int:
    """(row, col) pairs a causal (sliding-window) attention computes: row
    r reads cols max(0, r - window + 1) .. min(r, T - 1)."""
    full = S * (S + 1) // 2 if S <= T else T * (T + 1) // 2 + (S - T) * T
    m = max(0, S - window) if window else 0
    return full - m * (m + 1) // 2


def flash_call(B: int, S: int, Hq: int, Hkv: int, D: int, Dv: int,
               window: int, elt: int) -> Tuple[float, float]:
    """(flops, bytes) of one causal flash attention call: QK^T and PV
    over the pairs; q, k, v and o read or written once, lse in f32."""
    flops = 2.0 * B * Hq * (D + Dv) * attention_pairs(S, S, window)
    n_bytes = elt * (B * S * Hq * D + B * S * Hkv * (D + Dv)
                     + B * S * Hq * Dv) + 4 * B * Hq * S
    return flops, n_bytes


def ssd_flops(B: int, S: int, H: int, L: int, P: int, N: int) -> float:
    """Flops the SSD scan's inputs need in its lower-triangular form, chunk
    by chunk: C B^T over the n(n+1)/2 pairs of a chunk once per (batch
    row, chunk), then per (batch row, head, chunk) G @ xdt over the same
    pairs and the carried state through C and the state update."""
    full, tail = S // L, S % L
    total = 0.0
    for n, count in ((L, full), (tail, 1 if tail else 0)):
        total += count * (B * n * (n + 1) * N
                          + B * H * (n * (n + 1) * P + 4.0 * n * N * P))
    return total


def ssd_call(B: int, S: int, H: int, P: int, N: int,
             L: int) -> Tuple[float, float]:
    """(flops, bytes) of one ``ssd_scan`` call: xdt, la, B, C in and y,
    the final state out, f32."""
    n_bytes = 4 * (B * S * H * P + B * S * H + 2 * B * S * N
                   + B * S * H * P + B * H * P * N)
    return ssd_flops(B, S, H, L, P, N), n_bytes


def decode_rows(positions: Iterable[int], Hq: int, Hkv: int, D: int,
                elt: int) -> Tuple[float, float]:
    """(flops, bytes) of one decode attention layer over the rows that are
    active, each at its position p: scores and PV over p + 1 cache rows,
    those rows' keys and values read, q read and o written."""
    flops = n_bytes = 0.0
    for p in positions:
        flops += 4.0 * Hq * D * (p + 1)
        n_bytes += elt * (2 * (p + 1) * Hkv * D + 2 * Hq * D)
    return flops, n_bytes


def matmul_params(t: dict) -> int:
    """Weights a dense tower's token meets in its projections (no
    embedding lookup, no unembed)."""
    d, hd = t["d_model"], spec.head_dim(t)
    per = (d * t["n_heads"] * hd * 2 + d * t["n_kv_heads"] * hd * 2
           + 3 * d * t["d_ff"])
    return t["n_layers"] * per


def dense_token_flops(t: dict, ctx: float, *, unembed: bool) -> float:
    """Forward flops of one token of a dense tower that attends ``ctx``
    positions in every layer: 2 per projection weight, 4 Hq D per
    attended position, and the tied unembed when asked."""
    hd = spec.head_dim(t)
    f = 2.0 * matmul_params(t) + t["n_layers"] * 4.0 * t["n_heads"] * hd * ctx
    if unembed:
        f += 2.0 * t["d_model"] * t["vocab_size"]
    return f


def mamba_token_flops(p: dict) -> float:
    """Forward flops of the projections of one token through one Mamba2
    layer (the scan counted apart by ``ssd_flops``)."""
    d, s = p["d_model"], spec.ssm_dims(p)
    proj_in = 2 * s["d_in"] + 2 * s["N"] + s["H"]
    return 2.0 * d * proj_in + 2.0 * s["d_in"] * d


def train_flops(p: dict, B: int, S: int) -> float:
    """Model flops of one training step of the collaborative model on B x
    S tokens: three times the forward (forward, and a backward twice its
    cost), counting neither remat nor recompute.  The server with its
    unembed and v head, the edge tower (window 1024) with its u head."""
    avg = attention_pairs(S, S, 0) / S
    if p["family"] == "dense":
        server = dense_token_flops(p, avg, unembed=True) * B * S
    else:
        n_super, k, tail = spec.hybrid_layout(p)
        s = spec.ssm_dims(p)
        shared = {**p, "n_layers": 1}
        server = B * S * ((n_super * k + tail) * mamba_token_flops(p)
                          + n_super * dense_token_flops(shared, avg,
                                                        unembed=False)
                          + 2.0 * p["d_model"] * p["vocab_size"])
        server += (n_super * k + tail) * ssd_flops(
            B, S, s["H"], p.get("ssm_chunk", 128), s["P"], s["N"])
    e = spec.edge_block(p)
    e_avg = attention_pairs(S, S, e["window"]) / S
    m = p["monitor"]
    edge = B * S * (dense_token_flops(e, e_avg, unembed=False)
                    + 2.0 * m["d_model"] * m["n_features"]
                    + 2.0 * p["d_model"])
    return 3.0 * (server + edge)
