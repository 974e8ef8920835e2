from repro_torch.configs.base import ArchConfig, MonitorConfig  # noqa: F401
from repro_torch.configs import registry  # noqa: F401
