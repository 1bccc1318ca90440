"""The share of the rays the timed requests computed that were padding:
the rays ``ServingRenderer`` added to fill each request's last chunk
(the request span's ``padded``) over all it computed (``rays`` +
``padded``)."""
from portbench.lib import spans


def read(obs):
    roots = spans.timed_of(obs)
    if obs.get("kind") != "render" or roots is None:
        return None
    pad = sum(r.fields.get("padded", 0) for r in roots)
    return pad / (obs["rays"] + pad) * 100.0
