"""The share of the timed requests' device time that pads their rays to
whole chunks (``request.pad``) and joins the chunks' maps
(``request.assemble``), each timed on the card by its own CUDA events."""
from portbench.lib import spans


def read(obs):
    roots = spans.timed_of(obs)
    if obs.get("kind") != "render" or roots is None:
        return None
    total = spans.device_ms(roots)
    parts = [s for r in roots for s in r.spans
             if s.name in ("request.pad", "request.assemble")]
    part = spans.device_ms(parts)
    if not total or part is None:
        return None
    return part / total * 100.0
