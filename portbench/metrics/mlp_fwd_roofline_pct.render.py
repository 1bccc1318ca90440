"""The fused forward's share of its roofline in serving: the least time
for the points the traced requests' chunks gave the forward calls
(padding included: the kernel computes it), over the device time of the
forward kernels in the trace."""
from portbench.lib import work


def read(obs):
    t = obs.get("trace")
    if obs.get("kind") != "render" or t is None or not t["fused_s"]["fwd"]:
        return None
    f = obs["flags"]
    rays = obs["traced_padded_rays"]
    pts = rays * sum(work.points_per_ray(f))
    bound = work.bound_s(pts * work.fwd_flops_per_point(f),
                         work.fwd_bytes(f, pts, rays),
                         f["mlp_dtype"])
    return bound / t["fused_s"]["fwd"] * 100.0
