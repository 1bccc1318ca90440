"""The card's idle time between the timed window's served requests, read
without the profiler: 1 - the device ms of its requests (each from the
CUDA event at ``ServingRenderer.render_image``'s entry to the one after
its maps reach the host) over the window's wall time.  Idle time inside
a request (the host launching a chunk's small ops, its waits on the
card) counts as busy, so with one client sending back to back it reads
the time between two requests."""
from portbench.lib import spans


def read(obs):
    roots = spans.timed_of(obs)
    busy = None if roots is None else spans.device_ms(roots)
    if obs.get("kind") != "render" or busy is None or not obs["wall_s"]:
        return None
    return (1.0 - busy / 1e3 / obs["wall_s"]) * 100.0
