"""Serving's share of the card's peak: the forward FLOPs of the rays the
window's requests asked for (no padding) over the window's wall time
times the config's dtype peak."""
from portbench.lib import work


def read(obs):
    if obs.get("kind") != "render" or not obs["rays"]:
        return None
    f = obs["flags"]
    flops = obs["rays"] * sum(work.points_per_ray(f)) \
        * work.model_flops_per_point(f, train=False)
    return flops / (obs["wall_s"] * work.PEAK_FLOPS[f["mlp_dtype"]]) * 100.0
