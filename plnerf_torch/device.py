"""Device resolution for the port's entry points.

An entry point called without ``device`` runs on the CUDA device and
raises where there is none: the port never falls back to the CPU on its
own.  The CPU is used only when the caller asks for it.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means the current CUDA device; raises without CUDA.

    On a CUDA device float32 matmuls are pinned to true fp32 (no TF32),
    the counterpart of the JAX package's ``Precision.HIGHEST``, and bf16
    matmuls sum in fp32 (no reduced-precision reductions in cuBLAS), as
    the JAX package's bf16 dots do.  cuDNN's convolutions (the LPIPS
    trunk, ``eval/lpips.py``) are pinned to fp32 the same way.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run on the CPU")
        device = torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device} requested but CUDA is "
                               "not available")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
            False
        torch.backends.cudnn.allow_tf32 = False
    elif device.type != "cpu":
        raise ValueError(f"unsupported device {device}")
    return device


def make_generator(seed: int, device: DeviceLike) -> torch.Generator:
    """A seeded generator on ``device`` (the port's stand-in for a
    ``jax.random`` key; its draws differ from JAX's)."""
    g = torch.Generator(device=torch.device(device))
    g.manual_seed(int(seed))
    return g


def as_tensor(x, device: torch.device, dtype=torch.float32) -> torch.Tensor:
    """numpy array / tensor / scalar -> tensor on ``device``."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype)
    return torch.as_tensor(x, dtype=dtype, device=device)


def module_device(module: Optional[torch.nn.Module]) -> torch.device:
    return next(module.parameters()).device
