"""Configuration dataclasses of the PyTorch port.

Copies of ``ArchConfig`` and ``MonitorConfig`` from the JAX package
(``repro/configs/base.py``), kept field-for-field so a config of one
package describes the same model in the other.  The port carries its own
copy: it imports nothing of ``repro``.

``ArchConfig`` describes one backbone (the server-side class ``V`` of the
paper); ``MonitorConfig`` describes the small on-device tower (class
``U``) plus the decomposition hyper-parameters of
``f_hat = u - s * sigma(v)`` (paper Eq. 1).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field


@dataclass(frozen=True)
class MonitorConfig:
    """Edge tower ``u`` and decomposition hyper-parameters (see the JAX
    package's ``MonitorConfig`` for the meaning of each field)."""

    n_layers: int = 2
    d_model: int = 256
    n_heads: int = 4
    d_ff: int = 1024
    n_features: int = 64        # truncated feature basis size (paper's n)
    t_init: float = 0.1         # safety offset t
    s: float = 0.2              # corrector scale s
    threshold: float = 0.0      # warning threshold gamma
    trigger_margin: float = 0.25
    correction_capacity: float = 0.25
    sigma: str = "sigmoid"      # sigmoid | tanh01


@dataclass(frozen=True)
class ArchConfig:
    """One backbone.  The port runs the ``dense`` and ``hybrid`` families;
    the other families' fields are kept so configs stay copies of the
    reference's.
    Left out are the reference's XLA partitioner and scan knobs
    (``decode_cache_shard``, ``moe_impl``, ``zero1``, ``seq_parallel``,
    ``prefill_kv_shard``, ``scan_unroll``): they have no meaning in an
    eager PyTorch program.  ``remat`` keeps its meaning: activation
    checkpointing of each layer in the training forward."""

    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    citation: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 => d_model // n_heads
    qkv_bias: bool = False
    rope_theta: float = 1e4
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    sliding_window: int = 0
    long_context_window: int = 0
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    moe_d_ff: int = 0
    first_dense_layers: int = 0
    capacity_factor: float = 1.25
    use_mla: bool = False
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0
    mtp_depth: int = 0
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_heads: int = 0
    ssm_expand: int = 2
    ssm_chunk: int = 128
    shared_attn_every: int = 0
    slstm_every: int = 0
    cross_attn_every: int = 0
    n_image_tokens: int = 0
    n_codebooks: int = 0
    dtype: str = "bfloat16"          # activation/compute dtype
    param_dtype: str = "float32"     # parameter storage dtype
    remat: bool = True               # activation checkpointing per layer
    monitor: MonitorConfig = field(default_factory=MonitorConfig)

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)
