"""The paper's financial experiment (§4.2): predict one ticker's
normalised price from the other 29 (DJIA).  V = FC(29,64,128,256,1); u
truncates the penultimate layer to 16 units; warning threshold 0.8; the
appendix variant uses an independent FC(29,10,1) monitor.  A copy of the
JAX package's ``configs/paper_financial.py``.

The DJIA panel is re-synthesised from a seed by
``data/synthetic.py::financial_series`` (correlated GBM, 30 tickers,
normalised to [0,1]), so nothing is downloaded.
"""
from repro_torch.configs.paper_synthetic import PaperMLPConfig

FULL = PaperMLPConfig(
    name="paper-financial", in_dim=29, hidden=(64, 128, 256), n_basis=256,
    monitor_n=16, s=0.1, t_init=0.02, threshold=0.8,
    citation="paper §4.2 (DJIA, FC(29,64,128,256,1), truncate-16, gamma=0.8)",
)

SMOKE = PaperMLPConfig(
    name="paper-financial-smoke", in_dim=29, hidden=(16, 32, 48), n_basis=48,
    monitor_n=8, s=0.1, t_init=0.05, threshold=0.8,
)
