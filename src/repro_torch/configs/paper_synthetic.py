"""The paper's own synthetic experiment (§4.1): f(x) = sum_i 0.9^{i-1}
cos(ix), x ~ U[-3,3], server net V = FC(1,16,32,64,100,1), on-device net U
truncated from V's penultimate layer (Eq. 8); and its LM analogue, a
1-layer d64 server tower plus a matching edge monitor, the serving
workload of the collaborative engine, with its operating points.  A copy
of the JAX package's ``configs/paper_synthetic.py`` without the async
and wire operating points, which belong to paths not ported yet.
"""
from dataclasses import dataclass, field
from typing import Tuple

from repro_torch.configs.base import ArchConfig, MonitorConfig


@dataclass(frozen=True)
class PaperMLPConfig:
    name: str
    in_dim: int
    hidden: Tuple[int, ...]          # server net V hidden widths
    n_basis: int                     # width of V's penultimate layer (the phi_i)
    monitor_n: int                   # truncation n for u_{n,t}
    s: float                         # corrector scale
    t_init: float
    threshold: float                 # warning threshold gamma
    rho: float = 0.0                 # exponential-decay rate of the target
    citation: str = "paper §4"
    monitor: MonitorConfig = field(default_factory=MonitorConfig)


FULL = PaperMLPConfig(
    name="paper-synthetic", in_dim=1, hidden=(16, 32, 64, 100), n_basis=100,
    monitor_n=20, s=0.2, t_init=0.1, threshold=0.0, rho=0.9,
    citation="paper §4.1 (exponential decay, rho=0.9, 100 cosine modes)",
)

SMOKE = PaperMLPConfig(
    name="paper-synthetic-smoke", in_dim=1, hidden=(8, 16, 24), n_basis=24,
    monitor_n=8, s=0.3, t_init=0.15, threshold=0.0, rho=0.8,
)

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
