"""The reference's ``.tar`` checkpoints, both ways (port of
``plnerf/checkpoint/convert_torch.py``).

The reference saves ``torch.save`` dicts with ``global_step``,
``network_fn_state_dict``, ``network_fine_state_dict`` and
``optimizer_state_dict`` (run_plnerf.py:1324-1332; the depth script adds
``depth_shifts`` / ``depth_scales``).  Its ``NeRF`` has the port's
parameter names and ``[out, in]`` layout, so the state dicts carry over
as they are, with no transpose.  Only the Adam state needs an order: the
reference's optimizer lists a network's parameters in its module
registration order (pts_linears, views_linears, feature, alpha, rgb;
run_nerf_helpers.py:88-101), the port's ``NeRF`` registers feature and
alpha before views_linears.

``load_reference_checkpoint`` loads with ``weights_only=True`` and says
which global stopped it when that fails; it never unpickles code.
"""
from __future__ import annotations

import pickle
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from ..device import DeviceLike, resolve_device

StateDict = Dict[str, torch.Tensor]
_EXTRAS = ("depth_scales", "depth_shifts")


def _state_dict(params) -> StateDict:
    if isinstance(params, torch.nn.Module):
        params = params.state_dict()
    return {k: v.detach().to("cpu", torch.float32).contiguous().clone()
            for k, v in params.items()}


def reference_order(sd: StateDict) -> List[str]:
    """The parameter names of a network in the reference's registration
    order; only the viewdirs topology maps one to one (the reference
    registers ``views_linears`` even without viewdirs)."""
    if "feature_linear.weight" not in sd:
        raise ValueError("the reference parameter order needs the viewdirs "
                         "topology")

    def layers(prefix):
        n = len({k.split(".")[1] for k in sd if k.startswith(prefix + ".")})
        return [f"{prefix}.{i}.{w}" for i in range(n)
                for w in ("weight", "bias")]

    return (layers("pts_linears") + layers("views_linears")
            + [f"{m}.{w}" for m in ("feature_linear", "alpha_linear",
                                    "rgb_linear") for w in ("weight", "bias")])


def adam_moments(opt_state: Dict[str, Any], sds: Sequence[StateDict]
                 ) -> Optional[Tuple[Any, Any, int]]:
    """A port optimizer's saved state (``train.state._optimizer_state``:
    ``count`` and per-parameter-index moments) over the networks ``sds``
    in its order -> ``(mu, nu, count)`` keyed by parameter name (a
    ``(coarse, fine)`` pair of dicts for two networks), or None before the
    first update."""
    state = opt_state.get("state") or {}
    if not state:
        return None
    names = [(j, k) for j, sd in enumerate(sds) for k in sd]
    mu: List[StateDict] = [{} for _ in sds]
    nu: List[StateDict] = [{} for _ in sds]
    for i, (j, k) in enumerate(names):
        s = state[str(i)]
        mu[j][k], nu[j][k] = s["exp_avg"], s["exp_avg_sq"]
    if len(sds) == 1:
        return mu[0], nu[0], int(opt_state["count"])
    return tuple(mu), tuple(nu), int(opt_state["count"])


def save_reference_checkpoint(path: str, step: int, params_coarse,
                              params_fine=None, fine_adam=None,
                              lr: float = 5e-4, joint: bool = False,
                              extras: Optional[Dict[str, Any]] = None) -> str:
    """Write a reference-loadable ``.tar``; returns what Adam state it holds.

    ``params_*``: ``NeRF`` modules or their state dicts.  The optimizer
    state covers the fine network only, like run_plnerf's saved Adam, or
    with ``joint`` coarse then fine, like run_nerf_vanilla's single Adam
    (run_nerf_vanilla.py:365-380).  ``fine_adam``: ``(mu, nu, count)``
    with ``mu`` / ``nu`` keyed by parameter name (a ``(coarse, fine)``
    pair when ``joint``; ``adam_moments`` makes them from a port state)
    writes the real moments in the reference's parameter order; without it
    a fresh (pre-first-step) Adam state is written.  The non-viewdirs
    topology has no reference parameter order and gets a placeholder
    state.  ``extras``: the depth script's ``depth_scales`` /
    ``depth_shifts``, written after the four keys."""
    sd_c = _state_dict(params_coarse)
    sd_f = _state_dict(params_fine) if params_fine is not None else None
    nets = [sd_c, sd_f] if joint else [sd_f if sd_f is not None else sd_c]
    nets = [sd for sd in nets if sd is not None]
    try:
        orders = [reference_order(sd) for sd in nets]
    except ValueError:
        orders = None

    if orders is not None:
        dummies = [torch.nn.Parameter(torch.zeros(sd[k].shape))
                   for sd, order in zip(nets, orders) for k in order]
        osd = torch.optim.Adam(dummies, lr=lr, betas=(0.9, 0.999)).state_dict()
        if fine_adam is not None and sd_f is not None:
            mu, nu, count = fine_adam
            mus = [mu] if len(nets) == 1 else list(mu)
            nus = [nu] if len(nets) == 1 else list(nu)
            flat = [(m[k], v[k]) for m, v, order in zip(mus, nus, orders)
                    for k in order]
            osd["state"] = {
                i: {"step": torch.tensor(float(count)),
                    "exp_avg": m.detach().to("cpu", torch.float32).clone(),
                    "exp_avg_sq": v.detach().to("cpu", torch.float32).clone()}
                for i, (m, v) in enumerate(flat)}
    else:
        osd = {"state": {}, "param_groups": [
            {"lr": lr, "betas": (0.9, 0.999), "eps": 1e-8,
             "weight_decay": 0, "amsgrad": False, "params": []}]}

    ckpt = {"global_step": int(step), "network_fn_state_dict": sd_c,
            "network_fine_state_dict": sd_f, "optimizer_state_dict": osd}
    for k in _EXTRAS:
        if extras and extras.get(k) is not None:
            ckpt[k] = torch.as_tensor(extras[k]).detach().cpu().clone()
    torch.save(ckpt, path)
    if orders is None:
        return ("placeholder Adam state (non-viewdirs topology: torch "
                "param order is ambiguous)")
    if osd["state"]:
        return "real Adam moments"
    return "fresh Adam state"


def _load(path: str, device: torch.device) -> Dict[str, Any]:
    try:
        return torch.load(path, map_location=device, weights_only=True)
    except pickle.UnpicklingError as e:
        raise ValueError(f"{path}: not a weights-only reference checkpoint; "
                         f"the unpickler stopped at: {e}") from None


def load_reference_checkpoint(path: str, device: DeviceLike = None
                              ) -> Dict[str, Any]:
    """A reference ``.tar`` on ``device`` (default the CUDA device, which
    must exist): ``step``, ``params_coarse`` / ``params_fine`` (``NeRF``
    state dicts; ``params_fine`` None without a fine network) and, where
    the file has them, ``depth_shifts`` / ``depth_scales``."""
    ckpt = _load(path, resolve_device(device))
    out = {"step": int(ckpt.get("global_step", 0)),
           "params_coarse": dict(ckpt["network_fn_state_dict"]),
           "params_fine": None}
    if ckpt.get("network_fine_state_dict") is not None:
        out["params_fine"] = dict(ckpt["network_fine_state_dict"])
    for k in _EXTRAS:
        if k in ckpt:
            out[k] = ckpt[k]
    return out


def is_reference_checkpoint(ckpt: Dict[str, Any]) -> bool:
    return isinstance(ckpt, dict) and "network_fn_state_dict" in ckpt


def train_state_dict(ckpt: Dict[str, Any], target) -> Dict[str, Any]:
    """A loaded reference ``.tar`` -> the port's ``TrainState.state_dict``
    form for ``target`` (a port ``TrainState``): the networks, the step,
    the depth extras and, for the viewdirs topology, the saved Adam's
    moments moved from the reference's parameter order to the port
    optimizer's (``opt_fine``: the fine network, or coarse then fine for
    the joint optimizer).  The reference saves no coarse Adam; that one
    keeps its fresh state."""
    sd_c = dict(ckpt["network_fn_state_dict"])
    sd_f = ckpt.get("network_fine_state_dict")
    out: Dict[str, Any] = {"step": int(ckpt.get("global_step", 0)),
                           "params_coarse": sd_c}
    if sd_f is not None:
        out["params_fine"] = dict(sd_f)
    for k in _EXTRAS:
        if ckpt.get(k) is not None:
            out[k] = ckpt[k]
    state = (ckpt.get("optimizer_state_dict") or {}).get("state") or {}
    if not state or "feature_linear.weight" not in sd_c:
        return out
    mods = [target.params_fine] if target.opt_coarse is not None else [
        m for m in (target.params_coarse, target.params_fine) if m is not None]
    ref = [(j, k) for j, m in enumerate(mods)
           for k in reference_order(m.state_dict())]
    at = {jk: i for i, jk in enumerate(ref)}
    port = [(j, k) for j, m in enumerate(mods)
            for k, _ in m.named_parameters()]
    moved = {str(i): {"step": float(state[at[jk]]["step"]),
                      "exp_avg": state[at[jk]]["exp_avg"],
                      "exp_avg_sq": state[at[jk]]["exp_avg_sq"]}
             for i, jk in enumerate(port)}
    out["opt_fine"] = {"count": int(float(state[0]["step"])),
                       "state": moved}
    return out
