"""Carry weights between the JAX package's param pytrees and the port's
``NeRF`` modules, and a JAX train state's other fields into the port's.

Own copy of the mapping in ``plnerf/checkpoint/convert_torch.py``: JAX
stores weights ``[fan_in, fan_out]`` (``x @ w``), torch ``nn.Linear``
stores ``[out, in]``, so every weight is transposed.  The depth trainer's
per-image tensors and optax Adam moments (``mu``, ``nu``, ``count``) load
as they are, so the two packages can start, or resume, from one state.
Inputs are numpy arrays (or anything ``np.asarray`` takes); nothing here
imports JAX.
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
