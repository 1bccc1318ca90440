"""Host ms per train step: the harness's host clock around each window's
call (``graph.Graphs.run`` with its staging), up to its return and
without a sync, over the timed window's steps."""


def read(obs):
    if obs.get("kind") != "train" or not obs["steps"]:
        return None
    return obs["host_s"] / obs["steps"] * 1e3
