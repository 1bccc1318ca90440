"""Carry weights between the JAX package's param pytrees and the port's
``NeRF`` modules, and a JAX train state's other fields into the port's.

Own copy of the mapping in ``plnerf/checkpoint/convert_torch.py``: JAX
stores weights ``[fan_in, fan_out]`` (``x @ w``), torch ``nn.Linear``
stores ``[out, in]``, so every weight is transposed.  The depth trainer's
per-image tensors and optax Adam moments (``mu``, ``nu``, ``count``) load
as they are, so the two packages can start, or resume, from one state.
Inputs are numpy arrays (or anything ``np.asarray`` takes); nothing here
imports JAX.  ``train_state_dict`` maps a whole JAX ``TrainState``, as
``checkpoint.flax_msgpack`` reads it from a JAX checkpoint, into the
port's ``TrainState.state_dict`` form.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..core.mlp import NeRF


def params_to_state_dict(params: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """JAX-layout params (numpy leaves) -> ``NeRF`` state_dict arrays."""
    sd: Dict[str, np.ndarray] = {}

    def put(name, layer):
        sd[f"{name}.weight"] = np.asarray(layer["w"], np.float32).T
        sd[f"{name}.bias"] = np.asarray(layer["b"], np.float32)

    for i, layer in enumerate(params["pts_linears"]):
        put(f"pts_linears.{i}", layer)
    if "feature_linear" in params:
        for name in ("feature_linear", "alpha_linear", "rgb_linear"):
            put(name, params[name])
        for i, layer in enumerate(params["views_linears"]):
            put(f"views_linears.{i}", layer)
    else:
        put("output_linear", params["output_linear"])
    return sd


def state_dict_to_params(state_dict: Dict[str, Any]) -> Dict[str, Any]:
    """``NeRF`` state_dict (tensors or arrays) -> JAX-layout numpy params."""
    def to_np(v):
        if isinstance(v, torch.Tensor):
            v = v.detach().cpu().numpy()
        return np.asarray(v, np.float32)

    sd = {k: to_np(v) for k, v in state_dict.items()}

    def get(name):
        return {"w": sd[f"{name}.weight"].T, "b": sd[f"{name}.bias"]}

    def count(prefix):
        return len({k.split(".")[1] for k in sd if k.startswith(prefix)})

    params: Dict[str, Any] = {
        "pts_linears": [get(f"pts_linears.{i}")
                        for i in range(count("pts_linears."))]}
    if "feature_linear.weight" in sd:
        for name in ("feature_linear", "alpha_linear", "rgb_linear"):
            params[name] = get(name)
        params["views_linears"] = [get(f"views_linears.{i}")
                                   for i in range(count("views_linears."))]
    else:
        params["output_linear"] = get("output_linear")
    return params


def load_jax_params(module: NeRF, params: Dict[str, Any]) -> NeRF:
    """Copy JAX-layout params into ``module`` in place (on its device)."""
    sd = {k: torch.from_numpy(np.ascontiguousarray(v))
          for k, v in params_to_state_dict(params).items()}
    module.load_state_dict(sd, strict=True)
    return module


def params_leaves(module: NeRF, params: Dict[str, Any]) -> List[np.ndarray]:
    """JAX-layout params, or Adam moments of their shape, as arrays in the
    order of ``module.parameters()``."""
    sd = params_to_state_dict(params)
    return [sd[name] for name, _ in module.named_parameters()]


def load_adam_state(opt: torch.optim.Adam, mu: Sequence[Any],
                    nu: Sequence[Any], count: int) -> None:
    """Set an Adam's moments from optax's: ``mu`` / ``nu`` one array per
    parameter in the optimizer's order (torch layout), ``count`` the
    updates made.  The update count goes to ``opt.count`` where the
    optimizer keeps one (``train.optim.ScheduledAdam``)."""
    params = [p for group in opt.param_groups for p in group["params"]]
    if not len(params) == len(mu) == len(nu):
        raise ValueError(f"{len(params)} parameters, {len(mu)} / {len(nu)} "
                         "moments")
    for p, m, v in zip(params, mu, nu):
        opt.state[p] = {
            "step": torch.tensor(float(count), dtype=torch.float32),
            "exp_avg": torch.as_tensor(np.asarray(m, np.float32),
                                       device=p.device).reshape(p.shape),
            "exp_avg_sq": torch.as_tensor(np.asarray(v, np.float32),
                                          device=p.device).reshape(p.shape)}
    if hasattr(opt, "count"):
        opt.count = int(count)


def load_depth_fields(state, depth_scales: Optional[Any] = None,
                      depth_shifts: Optional[Any] = None,
                      cam_embeddings: Optional[Any] = None) -> None:
    """Copy a JAX depth ``TrainState``'s per-image tensors (numpy) into
    ``state``'s, in place, so the optimizers holding them keep them."""
    for name, value in (("depth_scales", depth_scales),
                        ("depth_shifts", depth_shifts),
                        ("cam_embeddings", cam_embeddings)):
        if value is None:
            continue
        tensor = getattr(state, name)
        with torch.no_grad():
            tensor.copy_(torch.as_tensor(np.asarray(value, np.float32)
                                         ).reshape(tensor.shape))


def find_adam(node: Any) -> Optional[dict]:
    """The optax ``ScaleByAdamState`` ({count, mu, nu}) inside a JAX
    optimizer state read from a checkpoint (the JAX package's
    ``tools/export_reference_ckpt._find_adam``)."""
    if isinstance(node, dict):
        if {"count", "mu", "nu"} <= set(node):
            return node
        children = node.values()
    elif isinstance(node, list):
        children = node
    else:
        return None
    for v in children:
        found = find_adam(v)
        if found is not None:
            return found
    return None


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.float().numpy()
    return np.asarray(x, np.float32)


def train_state_dict(raw: Dict[str, Any], target, device) -> Dict[str, Any]:
    """A JAX ``TrainState`` read from a checkpoint (digit-keyed dicts as
    lists) -> the port's ``TrainState.state_dict`` form on ``device``, for
    ``target`` (a port ``TrainState``, whose modules give the parameter
    order): params transposed, each optimizer's Adam moments in its
    parameters' order (the joint optimizer's coarse then fine; the depth
    Adam's scales then shifts), the depth fields as they are."""
    def t(a):
        return torch.as_tensor(_f32(a), device=device)

    out: Dict[str, Any] = {"step": int(np.asarray(raw["step"]))}
    for name in ("params_coarse", "params_fine"):
        if raw.get(name) is not None:
            out[name] = {k: t(v) for k, v in
                         params_to_state_dict(raw[name]).items()}
    for name in ("depth_scales", "depth_shifts", "cam_embeddings"):
        if raw.get(name) is not None:
            out[name] = t(raw[name])

    def leaves(name, mu):
        if name in ("opt_coarse", "opt_fine"):
            trees = mu if isinstance(mu, list) else [mu]
            fine = (target.params_coarse if target.params_fine is None
                    or name == "opt_coarse" else target.params_fine)
            mods = ([target.params_coarse, target.params_fine]
                    if len(trees) == 2 else [fine])
            return [a for m, tr in zip(mods, trees)
                    for a in params_leaves(m, tr)]
        return list(mu) if isinstance(mu, list) else [mu]

    for name in ("opt_coarse", "opt_fine", "opt_ss", "opt_latent"):
        adam = find_adam(raw.get(name))
        if adam is None:
            continue
        count = int(np.asarray(adam["count"]))
        state = {}
        if count:
            state = {str(i): {"step": float(count), "exp_avg": t(m),
                              "exp_avg_sq": t(v)}
                     for i, (m, v) in enumerate(zip(
                         leaves(name, adam["mu"]), leaves(name, adam["nu"])))}
        out[name] = {"count": count, "state": state}
    return out
