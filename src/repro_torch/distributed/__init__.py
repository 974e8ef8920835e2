"""Placement: the partition rules over the collaborative LM's parameter,
cache and optimizer trees (``distributed/sharding.py``) and the ambient
``DeviceMesh`` that the expert-parallel MoE dispatch reads."""
from repro_torch.distributed import sharding  # noqa: F401
