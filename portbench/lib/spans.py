"""The program's own spans (``plnerf_torch/utils/profile.py``'s recorder)
as the per-layer readers take them: the timed window's roots.

A run's process holds one recorder.  The timed window runs before the
traced slice, so its roots are the last ones not flagged ``profiled``:
``timed`` takes them from the end until their ``steps`` (training) or
``rays`` (serving) sum to the window's.  A checkout whose program has no
recorder gives None, as does a sum that misses.
"""
from __future__ import annotations

from typing import List, Optional, Sequence


def records() -> Optional[list]:
    """The recorder's roots, oldest first; None where the program has no
    recorder."""
    try:
        from plnerf_torch.utils import profile
    except ImportError:
        return None
    read = getattr(profile, "records", None)
    return None if read is None else read()


def timed(roots: Optional[Sequence], name: str, field: str,
          total) -> Optional[List]:
    """The last roots named ``name`` not flagged ``profiled`` whose
    ``field`` sums to ``total``, oldest first; None where none do."""
    if roots is None or not total:
        return None
    out, acc = [], 0
    for r in reversed(roots):
        if r.name != name or r.profiled:
            continue
        out.append(r)
        acc += r.fields.get(field, 0)
        if acc >= total:
            break
    return out[::-1] if acc == total else None


def timed_of(obs: dict) -> Optional[List]:
    """The timed window's roots of a run's ``obs``: its windows
    (training) or requests (serving)."""
    if obs.get("kind") == "train":
        return timed(records(), "window", "steps", obs.get("steps"))
    if obs.get("kind") == "render":
        return timed(records(), "request", "rays", obs.get("rays"))
    return None


def self_ms(roots: Sequence, name: str) -> float:
    """Host ms of the self time of the spans named ``name`` in
    ``roots``."""
    return sum(s.self_ms for r in roots for s in r.spans if s.name == name)


def device_ms(spans: Sequence) -> Optional[float]:
    """Device ms of ``spans``, None where one has none (not timed on the
    card)."""
    ms = [s.device_ms for s in spans]
    return None if not ms or None in ms else sum(ms)
