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

Sidecars share a checkpoint's step stem (``aux_path``): the occupancy
grid trained beside the parameters is ``{step:06d}.occ``, a dict of
tensors written the same way.

The JAX package's files (flax msgpack state dicts) are read too:
``restore_checkpoint`` and ``restore_aux`` tell them from the port's by
their first bytes (a ``torch.save`` file is a zip archive, a flax file
starts with a msgpack map), read them with ``flax_msgpack`` and map a JAX
``TrainState`` into the port's with ``convert_jax.train_state_dict``, so
``--ft_path`` may name a checkpoint that the JAX package trained.  A
reference ``.tar`` (``convert_torch``) restores through the same path.
"""
from __future__ import annotations

import os
import re
from typing import Any, Optional

import torch

from . import convert_jax, convert_torch, flax_msgpack

CKPT_RE = re.compile(r"^(\d+)\.ckpt$")


def _save(path: str, obj: Any) -> str:
    tmp = path + ".tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)
    return path


def save_checkpoint(ckpt_dir: str, step: int, state_dict: dict) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    return _save(os.path.join(ckpt_dir, f"{step:06d}.ckpt"), state_dict)


def aux_path(ckpt_path: str, suffix: str) -> str:
    """The sidecar of a checkpoint: 000100.ckpt -> 000100.<suffix>."""
    return os.path.splitext(ckpt_path)[0] + "." + suffix


def save_aux(ckpt_path: str, suffix: str, tensors: dict) -> str:
    """Write the dict of tensors ``tensors`` as ``ckpt_path``'s sidecar."""
    return _save(aux_path(ckpt_path, suffix), tensors)


def restore_aux(path: str, template: dict, device) -> dict:
    """A sidecar written by ``save_aux``, on ``device``, holding exactly
    the keys of ``template`` with its shapes and dtypes (raises
    otherwise).  A JAX package sidecar (flax) loads the same way."""
    if flax_msgpack.is_flax_file(path):
        loaded = {k: torch.as_tensor(v, device=device)
                  for k, v in flax_msgpack.read_state(path).items()}
    else:
        loaded = torch.load(path, map_location=device, weights_only=True)
    if set(loaded) != set(template):
        raise ValueError(f"{path}: keys {sorted(loaded)}, expected "
                         f"{sorted(template)}")
    for k, v in template.items():
        if loaded[k].shape != v.shape or loaded[k].dtype != v.dtype:
            raise ValueError(f"{path}: {k} is {loaded[k].dtype} "
                             f"{tuple(loaded[k].shape)}, expected {v.dtype} "
                             f"{tuple(v.shape)}")
    return loaded


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
    in a note.  A JAX package checkpoint (flax) or a reference ``.tar`` is
    mapped into ``target``'s form first (``convert_jax.train_state_dict``,
    ``convert_torch.train_state_dict``)."""
    if flax_msgpack.is_flax_file(path):
        state_dict = convert_jax.train_state_dict(
            flax_msgpack.read_state(path), target, device)
    else:
        state_dict = torch.load(path, map_location=device, weights_only=True)
        if convert_torch.is_reference_checkpoint(state_dict):
            state_dict = convert_torch.train_state_dict(state_dict, target)
    for k, v in target.state_dict().items():
        if k not in state_dict and v is not None:
            print(f"NOTE: checkpoint {os.path.basename(path)} predates "
                  f"state field '{k}' — keeping its fresh initialization")
    target.load_state_dict(state_dict)
    return target
