"""Host ms per train step launching the windows (``window.launch``: a
graph's replay and the host's counters, or the eager body), self time,
over the timed window's steps."""
from portbench.lib import spans


def read(obs):
    roots = spans.timed_of(obs)
    if obs.get("kind") != "train" or roots is None:
        return None
    return spans.self_ms(roots, "window.launch") / obs["steps"]
