from repro_torch.core import decomposition, gating  # noqa: F401
