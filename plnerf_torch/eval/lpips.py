"""LPIPS with the AlexNet trunk (port of ``plnerf/eval/lpips.py``).

The reference evaluates LPIPS with the ``lpips`` pip package
(run_plnerf.py:22,1163: ``lpips.LPIPS(net="alex")`` called with
``normalize=True`` at :340).  Here the same computation runs as a
``torch.nn.Module`` on the driver's device, NCHW activations on OIHW
weights through ``torch.nn.functional.conv2d`` (the counterpart of the
JAX package's ``lax.conv_general_dilated``; no hand-written kernel is
involved).  On a CUDA device ``device.resolve_device`` pins cuDNN to fp32
(no TF32), so the card's metric agrees with the CPU's to ~1e-6.

Pipeline (lpips v0.1 semantics):
  x in [0,1] -> 2x-1 -> (x - shift)/scale -> AlexNet relu1..relu5 features
  -> channelwise unit-normalize -> squared diff -> 1x1 "lin" conv (no bias)
  -> spatial mean -> sum over the 5 stages.

Weights: the torch-free ``.npz`` that the JAX package's
``tools/export_lpips_weights.py`` writes on a machine with network access
(keys ``conv{i}_w`` HWIO, ``conv{i}_b``, ``lin{i}_w`` [C, 1]; that tool
imports ``lpips`` and ``torchvision`` to fetch the pretrained weights and
is not ported), or a torch state dict in any of the three key layouts of
``from_torch_state_dict``.  The HWIO tensors are transposed once, at
load.  Without pretrained weights the metric is not meaningful: the tests
use seeded random weights (``init_random``).
"""
from __future__ import annotations

import os
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..device import DeviceLike, resolve_device

# torchvision AlexNet feature extractor: (out_ch, kernel, stride, pad),
# with max-pools after stages 1 and 2
_ALEX = [
    (64, 11, 4, 2),
    (192, 5, 1, 2),
    (384, 3, 1, 1),
    (256, 3, 1, 1),
    (256, 3, 1, 1),
]
_POOL_AFTER = {0, 1}
_CHANNELS = [64, 192, 384, 256, 256]

_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


def _keys():
    for i in range(len(_ALEX)):
        yield from (f"conv{i}_w", f"conv{i}_b", f"lin{i}_w")


def _unit_normalize(f: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    norm = torch.sqrt(torch.sum(f * f, dim=1, keepdim=True))
    return f / (norm + eps)


class LPIPS(torch.nn.Module):
    """``lp(img_hw3, ref_hw3) -> float``; ``distance`` takes NCHW
    batches.  Holds ``conv{i}_w`` [O, I, k, k], ``conv{i}_b`` [O] and
    ``lin{i}_w`` [1, C, 1, 1] as buffers."""

    def __init__(self, params: Dict[str, torch.Tensor]):
        super().__init__()
        for k in _keys():
            self.register_buffer(k, params[k].to(torch.float32).contiguous())
        self.register_buffer(
            "shift", torch.tensor(_SHIFT, dtype=torch.float32).view(
                1, 3, 1, 1))
        self.register_buffer(
            "scale", torch.tensor(_SCALE, dtype=torch.float32).view(
                1, 3, 1, 1))

    @property
    def device(self) -> torch.device:
        return self.shift.device

    def _features(self, x: torch.Tensor):
        """relu1..relu5 feature maps of the AlexNet trunk."""
        feats = []
        h = x
        for i, (_, _, stride, pad) in enumerate(_ALEX):
            h = F.relu(F.conv2d(h, getattr(self, f"conv{i}_w"),
                                getattr(self, f"conv{i}_b"), stride, pad))
            feats.append(h)
            if i in _POOL_AFTER:
                h = F.max_pool2d(h, 3, 2)
        return feats

    @torch.no_grad()
    def distance(self, img: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
        """img, ref: [N, 3, H, W] in [0, 1].  Returns [N] distances."""
        def prep(x):
            return (2.0 * x - 1.0 - self.shift) / self.scale

        total = 0.0
        for i, (a, b) in enumerate(zip(self._features(prep(img)),
                                       self._features(prep(ref)))):
            d = (_unit_normalize(a) - _unit_normalize(b)) ** 2
            val = F.conv2d(d, getattr(self, f"lin{i}_w"))
            total = total + torch.mean(val, dim=(1, 2, 3))
        return total

    def forward(self, img, ref) -> float:
        """img, ref: [H, W, 3] arrays or tensors in [0, 1]."""
        def nchw(x):
            x = torch.as_tensor(np.asarray(x, np.float32)
                                if not isinstance(x, torch.Tensor) else x)
            return x.to(self.device, torch.float32).permute(2, 0, 1)[None]

        return float(self.distance(nchw(img), nchw(ref))[0])

    # ---- constructors ----

    @classmethod
    def init_random(cls, generator: torch.Generator) -> "LPIPS":
        """Random weights on the generator's device: architecture and
        shape testing only."""
        dev = generator.device
        params = {}
        in_ch = 3
        for i, (out_ch, k, _, _) in enumerate(_ALEX):
            params[f"conv{i}_w"] = torch.randn(
                (out_ch, in_ch, k, k), generator=generator, device=dev) * (
                1.0 / np.sqrt(k * k * in_ch))
            params[f"conv{i}_b"] = torch.zeros(out_ch, device=dev)
            in_ch = out_ch
        for i, c in enumerate(_CHANNELS):
            params[f"lin{i}_w"] = torch.abs(torch.randn(
                (1, c, 1, 1), generator=generator, device=dev)) / c
        return cls(params)

    @classmethod
    def from_torch_state_dict(cls, sd: Dict[str, Any]) -> "LPIPS":
        """Build from torch tensors / ndarrays.

        Accepts torchvision naming (``features.{0,3,6,8,10}.weight/bias``),
        lpips-package naming (``net.slice{1..5}.*`` merged in), and heads as
        ``lin{0..4}.model.1.weight`` / ``lins.{i}.model.1.weight``.
        """
        def to_t(v):
            return torch.as_tensor(np.asarray(
                v.detach().cpu().numpy() if hasattr(v, "detach") else v,
                np.float32))

        params: Dict[str, torch.Tensor] = {}
        conv_idx = [0, 3, 6, 8, 10]  # positions in torchvision features
        for i, ci in enumerate(conv_idx):
            cands = [
                f"features.{ci}.weight",
                f"net.features.{ci}.weight",
                f"net.slice{i + 1}.{ci}.weight",
            ]
            wk = next((c for c in cands if c in sd), None)
            if wk is None:
                raise KeyError(f"AlexNet conv {i} weights not found "
                               f"(tried {cands})")
            params[f"conv{i}_w"] = to_t(sd[wk])                 # OIHW
            params[f"conv{i}_b"] = to_t(sd[wk.replace("weight", "bias")])
        for i, c in enumerate(_CHANNELS):
            cands = [
                f"lin{i}.model.1.weight",
                f"lins.{i}.model.1.weight",
                f"lin{i}.weight",
            ]
            wk = next((k for k in cands if k in sd), None)
            if wk is None:
                raise KeyError(f"LPIPS lin head {i} not found (tried {cands})")
            params[f"lin{i}_w"] = to_t(sd[wk]).reshape(1, c, 1, 1)
        return cls(params)

    @classmethod
    def from_npz(cls, path: str) -> "LPIPS":
        """Load the torch-free ``.npz`` (keys exactly ``conv{i}_w`` HWIO,
        ``conv{i}_b``, ``lin{i}_w`` [C, 1]), transposed to OIHW here."""
        with np.load(path) as z:
            raw = {k: np.asarray(z[k], np.float32) for k in z.files}
        for k in _keys():
            if k not in raw:
                raise KeyError(f"{path}: missing LPIPS tensor {k}")
        params = {}
        for i, c in enumerate(_CHANNELS):
            params[f"conv{i}_w"] = torch.from_numpy(np.ascontiguousarray(
                raw[f"conv{i}_w"].transpose(3, 2, 0, 1)))
            params[f"conv{i}_b"] = torch.from_numpy(raw[f"conv{i}_b"])
            params[f"lin{i}_w"] = torch.from_numpy(np.ascontiguousarray(
                raw[f"lin{i}_w"].T)).reshape(1, c, 1, 1)
        return cls(params)

    @classmethod
    def from_file(cls, path: str) -> "LPIPS":
        """An exported ``.npz``, else a torch state dict (``state_dict``
        unwrapped where the file nests it)."""
        if path.endswith(".npz"):
            return cls.from_npz(path)
        sd = torch.load(path, map_location="cpu", weights_only=True)
        if isinstance(sd, dict) and "state_dict" in sd:
            sd = sd["state_dict"]
        return cls.from_torch_state_dict(sd)


def default_weights_path() -> Optional[str]:
    """Documented weights locations, first hit wins:
    ``$PLNERF_LPIPS_WEIGHTS`` then ``<repo>/weights/lpips_alex.npz``."""
    env = os.environ.get("PLNERF_LPIPS_WEIGHTS")
    if env and os.path.isfile(env):
        return env
    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    cand = os.path.join(repo, "weights", "lpips_alex.npz")
    return cand if os.path.isfile(cand) else None


def load_lpips(weights_path: Optional[str],
               device: DeviceLike = None) -> Optional[LPIPS]:
    """The drivers' helper: the metric on ``device`` (default the CUDA
    device, which must exist), or None when there is no weights file (the
    eval then writes the ``lpips: UNAVAILABLE`` note into metrics.txt).
    With no explicit path, ``default_weights_path()``."""
    path = weights_path or default_weights_path()
    if not path:
        return None
    return LPIPS.from_file(path).to(resolve_device(device)).eval()
