"""LM analogue of the paper's synthetic experiment (paper §4.1): a 1-layer
d64 server tower plus a matching edge monitor, the serving workload of the
collaborative engine, and its operating points.  A copy of the serving
part of the JAX package's ``configs/paper_synthetic.py``.
"""
from repro_torch.configs.base import ArchConfig, MonitorConfig

SERVING = ArchConfig(
    name="paper-synthetic-serving", family="dense",
    citation="paper §4.1 (LM-scale analogue of the synthetic experiment)",
    n_layers=1, d_model=64, n_heads=2, n_kv_heads=2, d_ff=128,
    vocab_size=256, tie_embeddings=True,
    monitor=MonitorConfig(n_layers=1, d_model=64, n_heads=2, d_ff=128,
                          n_features=16),
)

# per-stream trigger rate in the paper's Fig-4 operating region (the
# threshold is calibrated to this rate from a probe u-trace)
SERVING_TRIGGER_RATE = 0.15
