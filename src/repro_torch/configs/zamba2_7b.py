"""Zamba2-7B [arXiv:2411.15242]: a Mamba2 backbone with one shared
attention + MLP block applied every 6 Mamba2 blocks.

81 layers, d_model=3584, 32 heads (GQA kv=32, head_dim 112), d_ff=14336,
vocab=32000, ssm_state=64.  A copy of the JAX package's
``configs/zamba2_7b.py``.
"""
from repro_torch.configs.base import ArchConfig, MonitorConfig

FULL = ArchConfig(
    name="zamba2-7b", family="hybrid", citation="arXiv:2411.15242",
    n_layers=81, d_model=3584, n_heads=32, n_kv_heads=32, d_ff=14336,
    vocab_size=32000, ssm_state=64, ssm_expand=2, ssm_conv=4,
    shared_attn_every=6, tie_embeddings=True,
    long_context_window=8192,
    monitor=MonitorConfig(n_layers=2, d_model=256, n_heads=4, d_ff=1024,
                          n_features=64),
)

SMOKE = FULL.replace(
    # 5 layers / period 2 runs both the super-blocks and the tail
    n_layers=5, d_model=256, n_heads=4, n_kv_heads=4, d_ff=512,
    vocab_size=512, ssm_state=16, shared_attn_every=2, remat=False,
    dtype="float32",
    monitor=MonitorConfig(n_layers=1, d_model=64, n_heads=2, d_ff=128,
                          n_features=16),
)
