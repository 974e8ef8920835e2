"""PyTorch/CUDA port of the collaborative monitoring system.

The JAX package ``repro`` is the reference; this package imports nothing
of it (and no JAX).  Plain tensor code is PyTorch; each Pallas TPU kernel
on a ported path is a hand-written Hopper kernel (``kernels/csrc``) with a
plain PyTorch version beside it for CPU tensors.  Entry points run on the
card unless the caller passes ``device="cpu"``.
"""
