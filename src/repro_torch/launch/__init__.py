"""Process entry points of the port (``python -m repro_torch.launch.<name>``):
``server``, the standalone correction server."""
