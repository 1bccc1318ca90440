"""The whole train step's share of the card's peak: the model's FLOPs of
the timed window's steps (the MLP's forward, then its data and weight
products, once each per point: no recompute) over the window's wall time
times the config's dtype peak."""
from portbench.lib import work


def read(obs):
    if obs.get("kind") != "train" or not obs["steps"]:
        return None
    f = obs["flags"]
    pts = obs["steps"] * obs["rays_per_step"] * sum(work.points_per_ray(f))
    flops = pts * work.model_flops_per_point(f, train=True)
    return flops / (obs["wall_s"] * work.PEAK_FLOPS[f["mlp_dtype"]]) * 100.0
