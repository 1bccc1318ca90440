"""The fused backward's share of its roofline in training: the least time
for the traced steps' points (the data and the weight products once
each, ``work.bwd_model_flops_per_point``: the kernels' recompute of the
forward is their design's cost, not the function's work, at the
config's dtype peak, or the bytes at HBM bandwidth), over the device
time of the port's backward kernels (``sgemm_data_kernel`` /
``data_kernel``, ``weight_kernel``, its own ``reduce_kernel``, and the
transposes) in the trace."""
from portbench.lib import work


def read(obs):
    t = obs.get("trace")
    if obs.get("kind") != "train" or t is None or not t["fused_s"]["bwd"]:
        return None
    f = obs["flags"]
    rays = obs["traced_steps"] * obs["rays_per_step"]
    pts = rays * sum(work.points_per_ray(f))
    bound = work.bound_s(pts * work.bwd_model_flops_per_point(f),
                         work.bwd_bytes(f, pts, rays),
                         f["mlp_dtype"])
    return bound / t["fused_s"]["bwd"] * 100.0
