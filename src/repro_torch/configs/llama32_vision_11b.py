"""Llama-3.2-11B-Vision [hf:meta-llama/Llama-3.2-11B-Vision] — dense text
decoder with tanh-gated cross-attention image layers every 5th layer.

40 layers, d_model=4096, 32 heads (GQA kv=8), d_ff=14336, vocab=128256,
1601 image patch embeddings (560px/14 + CLS, single tile).  The ViT vision
encoder + projector is a stub: batches carry projected patch embeddings
(B, 1601, d_model).  long_500k = swa-variant.  A copy of the JAX package's ``configs/llama32_vision_11b.py``.
"""
from repro_torch.configs.base import ArchConfig, MonitorConfig

FULL = ArchConfig(
    name="llama-3.2-vision-11b", family="vlm",
    citation="hf:meta-llama/Llama-3.2-11B-Vision",
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=14336,
    vocab_size=128256, cross_attn_every=5, n_image_tokens=1601,
    rope_theta=5e5, long_context_window=8192,
    monitor=MonitorConfig(n_layers=2, d_model=256, n_heads=4, d_ff=1024,
                          n_features=64),
)

SMOKE = FULL.replace(
    n_layers=2, d_model=256, n_heads=4, n_kv_heads=2, d_ff=512,
    vocab_size=512, cross_attn_every=2, n_image_tokens=16,
    remat=False, dtype="float32",
    monitor=MonitorConfig(n_layers=1, d_model=64, n_heads=2, d_ff=128,
                          n_features=16),
)
