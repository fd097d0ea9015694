"""sln_tpu_torch — the scene-layout framework in PyTorch for NVIDIA Hopper.

A port of `sln_tpu` (JAX on a TPU). Module paths mirror `sln_tpu` so each
counterpart is easy to find. Plain tensor code is PyTorch; the soft
rasterizer's forward and backward, which `sln_tpu` wrote as Pallas
kernels, are CUDA C++ kernels in `csrc/`, built with `nvcc` at first use
(`sln_tpu_torch.kernels`).

This package imports nothing of JAX or of `sln_tpu`; it keeps its own
copies of the host-side modules it needs.
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"


def resolve_device(name: str = "cuda") -> torch.device:
    """Entry points run on the card unless the caller asks for the CPU.

    Raises when CUDA is asked for and there is none: nothing falls back to
    the CPU silently."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is "
            "False (pass device='cpu' / --device cpu to run on the CPU)")
    return device
