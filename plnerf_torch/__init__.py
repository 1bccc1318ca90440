"""PyTorch port of plnerf for NVIDIA Hopper.

The JAX package ``plnerf`` is the reference; this package mirrors its
layout (``core/encoding.py``, ``core/mlp.py``, ...) module for module and
imports neither ``jax`` nor anything of ``plnerf``.  Entry points run on
the CUDA device unless the caller passes ``device="cpu"``
(``plnerf_torch.device.resolve_device``); the hand-written CUDA kernels
(the fused MLP, the dot-walk probes) live in ``plnerf_torch/kernels``, the
probe tools and the profilers in ``plnerf_torch/tools``, the train / test
drivers in ``plnerf_torch/cli``.
"""
