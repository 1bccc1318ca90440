"""The work of the NeRF MLP from its shapes: FLOPs and bytes per point,
the points a train step or a render request gives the MLP, and the
card's peaks.  Everything here is arithmetic on a configuration's
``flags`` (``configs/<name>.json``); nothing reads the program.

Counts are on unpadded widths.  ``folded`` is the fused kernels' head
schedule (the feature layer folded into the views layer, an exact
rewrite that the kernels run); ``split`` the plain topology.
"""
from __future__ import annotations

from typing import Dict, Tuple

# NVIDIA H100 SXM data sheet, dense: FLOP/s of the MLP's operand type
# (float32 outside the tensor cores, bfloat16 on them) and HBM bytes/s
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
HBM_BYTES_PER_S = 3.35e12
ELEMENT_BYTES = {"float32": 4, "bfloat16": 2}


def widths(flags: dict) -> Dict[str, int]:
    """in_ch, views_ch, width, depth and the skip layers of the config's
    MLP (positional encoding of 3 coordinates at ``multires`` bands)."""
    return {"in_ch": 3 + 3 * 2 * int(flags["multires"]),
            "views_ch": 3 + 3 * 2 * int(flags["multires_views"]),
            "width": int(flags["netwidth"]), "depth": int(flags["netdepth"]),
            "skips": tuple(flags.get("skips", (4,)))}


def macs_per_point(flags: dict, head: str = "folded") -> int:
    """Multiply-adds per point of the 8 x 256 viewdirs MLP: the trunk
    (with the skip layer's extra ``in_ch`` rows), then the heads."""
    w = widths(flags)
    W, in_ch, vch = w["width"], w["in_ch"], w["views_ch"]
    macs = in_ch * W + (w["depth"] - 1) * W * W
    macs += sum(in_ch * W for i in range(w["depth"]) if (i - 1) in w["skips"])
    if head == "split":
        # feature W x W, alpha W x 1, views (W + vch) x W/2, rgb W/2 x 3
        return macs + W * (W + 1) + (W + vch) * (W // 2) + (W // 2) * 3
    # folded: feature @ views as one W x W/2 product beside alpha
    return macs + W * (W // 2 + 1) + vch * (W // 2) + (W // 2) * 3


def fwd_flops_per_point(flags: dict, head: str = "folded") -> int:
    return 2 * macs_per_point(flags, head)


def bwd_kernel_flops_per_point(flags: dict, head: str = "folded") -> int:
    """FLOPs per point of the fused backward as designed: it keeps no
    activations from the forward, so every product runs three times (the
    recompute, the data grads, the weight grads), less the two recomputed
    outputs nothing reads (rgb, W/2 x 3, and the alpha column, W x 1)."""
    W = widths(flags)["width"]
    return 2 * (3 * macs_per_point(flags, head) - 3 * (W // 2) - W)


def bwd_model_flops_per_point(flags: dict, head: str = "folded") -> int:
    """FLOPs per point of the backward's work as the function needs it:
    the data and the weight products once each, no recompute."""
    return 2 * fwd_flops_per_point(flags, head)


def model_flops_per_point(flags: dict, train: bool) -> int:
    """The model's FLOPs per point for MFU: the forward once and, in
    training, the backward's data and weight products once each (no
    recompute)."""
    f = fwd_flops_per_point(flags)
    return f + bwd_model_flops_per_point(flags) if train else f


def points_per_ray(flags: dict) -> Tuple[int, int]:
    """(coarse, fine) points a ray gives the MLP: N_samples, then
    N_samples + N_importance."""
    ns, ni = int(flags["N_samples"]), int(flags["N_importance"])
    return ns, ns + ni


def fwd_bytes(flags: dict, n_points: int, n_rays: int) -> float:
    """Bytes a forward call must move: each point's encoded input read
    once in the operand type, each ray's encoded view read once, the
    weights read once, 4 fp32 outputs a point written once."""
    w = widths(flags)
    e = ELEMENT_BYTES[flags.get("mlp_dtype", "float32")]
    weights = macs_per_point(flags) * e
    return (n_points * (w["in_ch"] * e + 16) + n_rays * w["views_ch"] * e
            + weights)


def bwd_bytes(flags: dict, n_points: int, n_rays: int) -> float:
    """Bytes a backward call must move: the forward's inputs and its 4
    fp32 output grads a point read once, the weights read once, an fp32
    grad per weight written once."""
    w = widths(flags)
    e = ELEMENT_BYTES[flags.get("mlp_dtype", "float32")]
    m = macs_per_point(flags)
    return (n_points * (w["in_ch"] * e + 16) + n_rays * w["views_ch"] * e
            + m * e + m * 4)


def bound_s(flops: float, nbytes: float, dtype: str) -> float:
    """The least time the card could take: the larger of the operations
    over the dtype's peak and the bytes over HBM bandwidth."""
    return max(flops / PEAK_FLOPS[dtype], nbytes / HBM_BYTES_PER_S)
