"""Checkpoint save / restore (port of ``plnerf/checkpoint/io.py``).

Checkpoints live in ``<ckpt_dir>/<expname>/``, one file per checkpoint
named ``{step:06d}.ckpt``; resume picks the highest step (a numeric sort:
a lexical one puts 1000000 before 900000) unless ``--no_reload``, and
``--ft_path`` loads a given file (reference run_plnerf.py:453-471,
1324-1332).  As in the JAX package every optimizer state is saved (the
reference saves no coarse Adam state).

Format: ``torch.save`` of a ``state_dict`` holding only tensors, ints,
floats and strings (``train.state.TrainState.state_dict``), written to a
``.tmp`` file first and moved into place with ``os.replace``, so a reader
never sees half a file.  ``restore_checkpoint`` loads with
``weights_only=True`` onto the device asked for: a checkpoint written on
the card restores on the CPU and back.
"""
from __future__ import annotations

import os
import re
from typing import Any, Optional

import torch

CKPT_RE = re.compile(r"^(\d+)\.ckpt$")


def _save(path: str, obj: Any) -> str:
    tmp = path + ".tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)
    return path


def save_checkpoint(ckpt_dir: str, step: int, state_dict: dict) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    return _save(os.path.join(ckpt_dir, f"{step:06d}.ckpt"), state_dict)


def list_checkpoints(ckpt_dir: str):
    if not os.path.isdir(ckpt_dir):
        return []
    found = []
    for name in os.listdir(ckpt_dir):
        m = CKPT_RE.match(name)
        if m:
            found.append((int(m.group(1)), name))
    return [os.path.join(ckpt_dir, n) for _, n in sorted(found)]


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    ckpts = list_checkpoints(ckpt_dir)
    return ckpts[-1] if ckpts else None


def restore_checkpoint(path: str, target, device):
    """Load ``path`` into ``target`` (an object with ``state_dict`` /
    ``load_state_dict``, e.g. a ``TrainState`` already on ``device``) and
    return it.

    Forward compatibility: a field of ``target`` that the checkpoint
    predates keeps its fresh initialization, and a non-None one is named
    in a note."""
    state_dict = torch.load(path, map_location=device, weights_only=True)
    for k, v in target.state_dict().items():
        if k not in state_dict and v is not None:
            print(f"NOTE: checkpoint {os.path.basename(path)} predates "
                  f"state field '{k}' — keeping its fresh initialization")
    target.load_state_dict(state_dict)
    return target
