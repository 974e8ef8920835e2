"""Serving: ``MonitorSession`` over the collaborative engine."""
from repro_torch.serving.api import MonitorSession, SessionConfig  # noqa: F401
from repro_torch.serving.collaborative import CollaborativeEngine  # noqa: F401
