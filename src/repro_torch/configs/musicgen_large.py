"""MusicGen-large [arXiv:2306.05284] — decoder-only LM over EnCodec tokens.

48 layers, d_model=2048, 32 heads, d_ff=8192, vocab=2048 per codebook,
4 codebooks (delay interleaving handled by the data pipeline).  The EnCodec
frontend is a stub: batches carry codebook token ids.  long_500k =
swa-variant.  A copy of the JAX package's ``configs/musicgen_large.py``.
"""
from repro_torch.configs.base import ArchConfig, MonitorConfig

FULL = ArchConfig(
    name="musicgen-large", family="audio", citation="arXiv:2306.05284",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=32, d_ff=8192,
    vocab_size=2048, n_codebooks=4, long_context_window=8192,
    monitor=MonitorConfig(n_layers=2, d_model=256, n_heads=4, d_ff=1024,
                          n_features=64),
)

SMOKE = FULL.replace(
    n_layers=2, d_model=256, n_heads=4, n_kv_heads=4, d_ff=512,
    vocab_size=256, n_codebooks=2, remat=False, dtype="float32",
    monitor=MonitorConfig(n_layers=1, d_model=64, n_heads=2, d_ff=128,
                          n_features=16),
)
