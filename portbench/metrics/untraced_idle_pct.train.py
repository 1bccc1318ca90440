"""The card's idle time between the timed window's training windows,
read without the profiler: 1 - the device ms of its windows (each from
the CUDA event recorded before its launch to the one after its outputs'
copy, ``train/graph.Graphs``) over the window's wall time.  A replayed
window has no host code inside it, so this is the card's idle share
but for the gaps between a graph's own kernels."""
from portbench.lib import spans


def read(obs):
    roots = spans.timed_of(obs)
    busy = None if roots is None else spans.device_ms(roots)
    if obs.get("kind") != "train" or busy is None or not obs["wall_s"]:
        return None
    return (1.0 - busy / 1e3 / obs["wall_s"]) * 100.0
