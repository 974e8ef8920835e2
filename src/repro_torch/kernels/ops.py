"""One call site per kernel, chosen by where the tensors lie.

A CPU tensor goes to the kernel's plain PyTorch version.  A CUDA tensor
goes to the hand-written kernel, which raises on anything it does not
take: there is no global switch and no fallback.
"""
from __future__ import annotations

from repro_torch.kernels.decode_attention import (decode_attention_cuda,
                                                  decode_attention_plain)
from repro_torch.kernels.monitor_combine import (monitor_combine_cuda,
                                                 monitor_combine_plain)


def decode_attention(q, k_cache, v_cache, pos):
    if q.device.type == "cpu":
        return decode_attention_plain(q, k_cache, v_cache, pos)
    return decode_attention_cuda(q, k_cache, v_cache, pos)


def monitor_combine(u, v, f, *, s: float, threshold: float = 0.0,
                    margin: float = 0.25):
    if u.device.type == "cpu":
        return monitor_combine_plain(u, v, f, s=s, threshold=threshold,
                                     margin=margin)
    return monitor_combine_cuda(u, v, f, s=s, threshold=threshold,
                                margin=margin)
