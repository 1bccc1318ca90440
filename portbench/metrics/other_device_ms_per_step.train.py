"""Device ms per train step of every kernel, copy and memset outside the
fused MLP's kernels: the renderer, samplers, grid, loss and Adam."""


def read(obs):
    t = obs.get("trace")
    if obs.get("kind") != "train" or t is None or not obs["traced_steps"]:
        return None
    return t["other_s"] / obs["traced_steps"] * 1e3
