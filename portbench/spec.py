"""The collaborative model's parameters as the benchmark names them: every
leaf's name, shape and served dtype, worked out from a configuration
file's ``port`` block alone (the names are the port's module paths, so
the harness can fill the program's model leaf by leaf and the reference
can draw the same values again).  Imports nothing of the program."""
from __future__ import annotations

from typing import Dict, List, Tuple

Leaf = Tuple[str, Tuple[int, ...], str]   # name, shape, dtype name


def head_dim(p: dict) -> int:
    return p.get("head_dim") or p["d_model"] // p["n_heads"]


def edge_block(p: dict) -> dict:
    """The edge tower's sizes (the port's ``edge_arch``): a dense decoder
    of the monitor's widths over the server's vocabulary, window 1024."""
    m = p["monitor"]
    return {"family": "dense", "n_layers": m["n_layers"],
            "d_model": m["d_model"], "n_heads": m["n_heads"],
            "n_kv_heads": m["n_heads"], "d_ff": m["d_ff"],
            "vocab_size": p["vocab_size"], "tie_embeddings": True,
            "rope_theta": 1e4, "norm_eps": 1e-5, "window": 1024,
            "dtype": p.get("dtype", "bfloat16"),
            "param_dtype": p.get("param_dtype", "float32")}


def ssm_dims(p: dict) -> Dict[str, int]:
    d_in = p.get("ssm_expand", 2) * p["d_model"]
    return {"d_in": d_in, "H": d_in // 64, "P": 64, "N": p["ssm_state"],
            "K": p.get("ssm_conv", 4)}


def hybrid_layout(p: dict) -> Tuple[int, int, int]:
    """(super-blocks, Mamba2 layers a super-block, tail layers)."""
    k = p.get("shared_attn_every") or p["n_layers"]
    n_super = p["n_layers"] // k
    return n_super, k, p["n_layers"] - n_super * k


def _block(prefix: str, d: int, hq: int, hkv: int, hd: int, ff: int,
           cdt: str, pdt: str) -> List[Leaf]:
    return [(f"{prefix}.ln_attn.scale", (d,), pdt),
            (f"{prefix}.attn.wq.w", (d, hq * hd), cdt),
            (f"{prefix}.attn.wk.w", (d, hkv * hd), cdt),
            (f"{prefix}.attn.wv.w", (d, hkv * hd), cdt),
            (f"{prefix}.attn.wo.w", (hq * hd, d), cdt),
            (f"{prefix}.ln_mlp.scale", (d,), pdt),
            (f"{prefix}.mlp.w_gate.w", (d, ff), cdt),
            (f"{prefix}.mlp.w_up.w", (d, ff), cdt),
            (f"{prefix}.mlp.w_down.w", (ff, d), cdt)]


def _mamba(prefix: str, p: dict, cdt: str, pdt: str) -> List[Leaf]:
    d = p["d_model"]
    s = ssm_dims(p)
    m = f"{prefix}.mamba"
    return [(f"{prefix}.ln.scale", (d,), pdt),
            (f"{m}.A_log", (s["H"],), "float32"),
            (f"{m}.D", (s["H"],), "float32"),
            (f"{m}.dt_bias", (s["H"],), "float32"),
            (f"{m}.norm_scale", (s["d_in"],), pdt),
            (f"{m}.w_z.w", (d, s["d_in"]), cdt),
            (f"{m}.w_x.w", (d, s["d_in"]), cdt),
            (f"{m}.w_B.w", (d, s["N"]), cdt),
            (f"{m}.w_C.w", (d, s["N"]), cdt),
            (f"{m}.w_dt.w", (d, s["H"]), cdt),
            (f"{m}.conv_x.w", (s["K"], s["d_in"]), pdt),
            (f"{m}.conv_x.b", (s["d_in"],), pdt),
            (f"{m}.conv_B.w", (s["K"], s["N"]), pdt),
            (f"{m}.conv_B.b", (s["N"],), pdt),
            (f"{m}.conv_C.w", (s["K"], s["N"]), pdt),
            (f"{m}.conv_C.b", (s["N"],), pdt),
            (f"{m}.out_proj.w", (s["d_in"], d), cdt)]


def _dense_tower(prefix: str, t: dict) -> List[Leaf]:
    cdt, pdt = t["dtype"], t["param_dtype"]
    d = t["d_model"]
    out = [(f"{prefix}.ln_f.scale", (d,), pdt),
           (f"{prefix}.embed.table", (t["vocab_size"], d), cdt)]
    for i in range(t["n_layers"]):
        out += _block(f"{prefix}.blocks.{i}", d, t["n_heads"],
                      t["n_kv_heads"], head_dim(t), t["d_ff"], cdt, pdt)
    return out


def server_leaves(p: dict) -> List[Leaf]:
    cdt, pdt = p.get("dtype", "bfloat16"), p.get("param_dtype", "float32")
    if p["family"] == "dense":
        if not p.get("tie_embeddings", False):
            raise ValueError("the benchmark's dense configs tie embeddings")
        return _dense_tower("server", {**p, "dtype": cdt, "param_dtype": pdt})
    if p["family"] != "hybrid":
        raise ValueError(f"family {p['family']!r} has no spec here")
    d = p["d_model"]
    n_super, k, tail = hybrid_layout(p)
    out = [("server.embed.table", (p["vocab_size"], d), cdt),
           ("server.ln_f.scale", (d,), pdt)]
    for s in range(n_super):
        for j in range(k):
            out += _mamba(f"server.mamba_blocks.{s}.{j}", p, cdt, pdt)
    out += _block("server.shared", d, p["n_heads"], p["n_kv_heads"],
                  head_dim(p), p["d_ff"], cdt, pdt)
    for i in range(tail):
        out += _mamba(f"server.tail.{i}", p, cdt, pdt)
    return out


def leaves(p: dict) -> List[Leaf]:
    """Every leaf of the collaborative model ``{server, v_head, edge,
    u_head}`` in the port's order."""
    m = p["monitor"]
    return (server_leaves(p)
            + [("v_head.w", (p["d_model"], 1), "float32"),
               ("v_head.b", (1,), "float32")]
            + _dense_tower("edge", edge_block(p))
            + [("u_head.a", (m["n_features"],), "float32"),
               ("u_head.raw_t", (), "float32"),
               ("u_head.w_feat.w", (m["d_model"], m["n_features"]),
                "float32")])


def group_of(name: str) -> str:
    """The draw group of a leaf: its name up to the last all-digit part
    (one layer), else its first two parts."""
    parts = name.split(".")
    last = max((i for i, s in enumerate(parts) if s.isdigit()), default=-1)
    return ".".join(parts[:last + 1] if last >= 0 else parts[:2])


def groups(p: dict) -> Dict[str, List[Leaf]]:
    out: Dict[str, List[Leaf]] = {}
    for leaf in leaves(p):
        out.setdefault(group_of(leaf[0]), []).append(leaf)
    return out


def numel(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n
