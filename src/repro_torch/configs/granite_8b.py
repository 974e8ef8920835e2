"""Granite-8B-Code [arXiv:2405.04324]: llama-arch dense decoder for code.

36 layers, d_model=4096, 32 heads (GQA kv=8), d_ff=14336, vocab=49152.
A copy of the JAX package's ``configs/granite_8b.py``.
"""
from repro_torch.configs.base import ArchConfig, MonitorConfig

FULL = ArchConfig(
    name="granite-8b", family="dense", citation="arXiv:2405.04324",
    n_layers=36, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=14336,
    vocab_size=49152, rope_theta=1e4, tie_embeddings=True,
    long_context_window=8192,
    monitor=MonitorConfig(n_layers=2, d_model=256, n_heads=4, d_ff=1024,
                          n_features=64),
)

SMOKE = FULL.replace(
    n_layers=2, d_model=256, n_heads=4, n_kv_heads=2, d_ff=512,
    vocab_size=512, remat=False, dtype="float32",
    monitor=MonitorConfig(n_layers=1, d_model=64, n_heads=2, d_ff=128,
                          n_features=16),
)
