"""Host ms per train step staging the windows' per-step values
(``window.stage``: ``train/step.stage_window``, ``Feed.fill``), self
time, over the timed window's steps."""
from portbench.lib import spans


def read(obs):
    roots = spans.timed_of(obs)
    if obs.get("kind") != "train" or roots is None:
        return None
    return spans.self_ms(roots, "window.stage") / obs["steps"]
