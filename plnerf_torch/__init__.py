"""PyTorch port of plnerf for NVIDIA Hopper.

The JAX package ``plnerf`` is the reference; this package mirrors its
layout (``core/encoding.py``, ``core/mlp.py``, ...) module for module and
imports neither ``jax`` nor anything of ``plnerf``.  Entry points run on
the CUDA device unless the caller passes ``device="cpu"``
(``plnerf_torch.device.resolve_device``); the fused MLP's hand-written
CUDA kernel lives in ``plnerf_torch/kernels``.
"""
