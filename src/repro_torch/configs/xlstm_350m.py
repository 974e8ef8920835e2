"""xLSTM-350m [arXiv:2405.04517] — sLSTM + mLSTM blocks (xLSTM[7:1]).

24 layers, d_model=1024, 4 heads, d_ff=0 (blocks carry internal projections),
vocab=50304.  One sLSTM block every 8 layers.  long_500k is native: O(1)
recurrent state, no KV cache.
A copy of the JAX package's ``configs/xlstm_350m.py``.
"""
from repro_torch.configs.base import ArchConfig, MonitorConfig

FULL = ArchConfig(
    name="xlstm-350m", family="ssm", citation="arXiv:2405.04517",
    n_layers=24, d_model=1024, n_heads=4, n_kv_heads=4, d_ff=0,
    vocab_size=50304, slstm_every=8, tie_embeddings=True,
    monitor=MonitorConfig(n_layers=2, d_model=256, n_heads=4, d_ff=1024,
                          n_features=64),
)

SMOKE = FULL.replace(
    n_layers=2, d_model=128, n_heads=2, n_kv_heads=2, vocab_size=512,
    slstm_every=2, remat=False, dtype="float32",
    monitor=MonitorConfig(n_layers=1, d_model=64, n_heads=2, d_ff=128,
                          n_features=16),
)
