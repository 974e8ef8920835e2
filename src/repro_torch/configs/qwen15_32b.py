"""Qwen1.5-32B [hf:Qwen/Qwen1.5-0.5B family]: dense decoder, MHA (kv=40),
QKV bias.  64 layers, d_model=5120, 40 heads, d_ff=27392, vocab=152064.
A copy of the JAX package's ``configs/qwen15_32b.py``.
"""
from repro_torch.configs.base import ArchConfig, MonitorConfig

FULL = ArchConfig(
    name="qwen1.5-32b", family="dense", citation="hf:Qwen/Qwen1.5-0.5B",
    n_layers=64, d_model=5120, n_heads=40, n_kv_heads=40, d_ff=27392,
    vocab_size=152064, qkv_bias=True, rope_theta=1e6,
    long_context_window=8192,
    monitor=MonitorConfig(n_layers=2, d_model=256, n_heads=4, d_ff=1024,
                          n_features=64),
)

SMOKE = FULL.replace(
    n_layers=2, d_model=320, n_heads=5, n_kv_heads=5, d_ff=768,
    vocab_size=512, remat=False, dtype="float32",
    monitor=MonitorConfig(n_layers=1, d_model=64, n_heads=2, d_ff=128,
                          n_features=16),
)
