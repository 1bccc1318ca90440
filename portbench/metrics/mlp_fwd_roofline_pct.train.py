"""The fused forward's share of its roofline in training: the least time
the card could take for the points the traced steps gave the forward
calls (coarse N_samples and fine N_samples + N_importance a ray, folded
FLOPs at the config's dtype peak, or bytes at HBM bandwidth), over the
device time of the forward kernels (``fp32_kernel``, ``bf16_kernel``) in
the trace."""
from portbench.lib import work


def read(obs):
    t = obs.get("trace")
    if obs.get("kind") != "train" or t is None or not t["fused_s"]["fwd"]:
        return None
    f = obs["flags"]
    rays = obs["traced_steps"] * obs["rays_per_step"]
    pts = rays * sum(work.points_per_ray(f))
    bound = work.bound_s(pts * work.fwd_flops_per_point(f),
                         work.fwd_bytes(f, pts, rays),
                         f["mlp_dtype"])
    return bound / t["fused_s"]["fwd"] * 100.0
