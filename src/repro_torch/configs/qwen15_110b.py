"""Qwen1.5-110B [hf:Qwen/Qwen1.5-0.5B family]: dense decoder with QKV bias.

80 layers, d_model=8192, 64 heads (GQA kv=8), d_ff=49152, vocab=152064,
bf16 parameters.  A copy of the JAX package's ``configs/qwen15_110b.py``.
"""
from repro_torch.configs.base import ArchConfig, MonitorConfig

FULL = ArchConfig(
    name="qwen1.5-110b", family="dense", citation="hf:Qwen/Qwen1.5-0.5B",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8, d_ff=49152,
    vocab_size=152064, qkv_bias=True, rope_theta=1e6,
    param_dtype="bfloat16", long_context_window=8192,
    monitor=MonitorConfig(n_layers=2, d_model=256, n_heads=4, d_ff=1024,
                          n_features=64),
)

SMOKE = FULL.replace(
    n_layers=2, d_model=256, n_heads=4, n_kv_heads=2, d_ff=768,
    vocab_size=512, remat=False, dtype="float32", param_dtype="float32",
    monitor=MonitorConfig(n_layers=1, d_model=64, n_heads=2, d_ff=128,
                          n_features=16),
)
