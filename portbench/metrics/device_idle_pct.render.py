"""The card's idle share of a traced slice of served requests: 1 - the
union of its kernel, copy and memset intervals over the slice's host
time."""


def read(obs):
    t = obs.get("trace")
    if obs.get("kind") != "render" or t is None or not t["window_s"]:
        return None
    return (1.0 - t["busy_s"] / t["window_s"]) * 100.0
