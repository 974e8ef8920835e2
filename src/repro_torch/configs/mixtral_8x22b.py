"""Mixtral-8x22B [arXiv:2401.04088]: 8-expert top-2 MoE with sliding-window
attention.  56 layers, d_model=6144, 48 heads (GQA kv=8, so 6 query heads
share a kv head), expert d_ff=16384, vocab=32768, bf16 parameters.  A copy
of the JAX package's ``configs/mixtral_8x22b.py`` less its XLA dispatch
knob (the port runs the dense dispatch, ``nn/moe.py``).
"""
from repro_torch.configs.base import ArchConfig, MonitorConfig

FULL = ArchConfig(
    name="mixtral-8x22b", family="moe", citation="arXiv:2401.04088",
    n_layers=56, d_model=6144, n_heads=48, n_kv_heads=8, d_ff=0,
    vocab_size=32768,
    n_experts=8, top_k=2, moe_d_ff=16384, first_dense_layers=0,
    sliding_window=4096, capacity_factor=1.25,
    param_dtype="bfloat16", rope_theta=1e6,
    monitor=MonitorConfig(n_layers=2, d_model=256, n_heads=4, d_ff=1024,
                          n_features=64),
)

SMOKE = FULL.replace(
    n_layers=2, d_model=256, n_heads=4, n_kv_heads=2, d_ff=0,
    vocab_size=512, n_experts=4, top_k=2, moe_d_ff=256, sliding_window=32,
    remat=False, dtype="float32", param_dtype="float32",
    monitor=MonitorConfig(n_layers=1, d_model=64, n_heads=2, d_ff=128,
                          n_features=16),
)
