"""The port's kernels: each has a plain PyTorch version (CPU tensors) and a
hand-written Hopper kernel (CUDA tensors); ``ops`` picks by device."""
from repro_torch.kernels import ops  # noqa: F401
from repro_torch.kernels.decode_attention import KERNEL as DECODE_ATTENTION
from repro_torch.kernels.flash_attention import KERNEL as FLASH_ATTENTION
from repro_torch.kernels.monitor_combine import KERNEL as MONITOR_COMBINE
from repro_torch.kernels.ssm_scan import KERNEL as SSD_SCAN

KERNELS = {"decode_attention": DECODE_ATTENTION,
           "monitor_combine": MONITOR_COMBINE,
           "flash_attention": FLASH_ATTENTION,
           "ssd_scan": SSD_SCAN}


def reset_launch_counts() -> None:
    for k in KERNELS.values():
        k.launches = 0


def launch_counts() -> dict:
    return {name: k.launches for name, k in KERNELS.items()}
