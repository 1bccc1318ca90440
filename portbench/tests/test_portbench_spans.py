"""The readers of the program's own spans (``lib/spans.py`` and the
metrics that use it): the timed window's roots taken from the end, on
hand-made records, and a tiny traced run on the CPU, where only the host
spans have something to read."""
from types import SimpleNamespace

import pytest
import torch

from portbench.lib import harness, spans
from portbench.tests.tiny import run_tiny


def root(name, profiled=False, device_ms=None, children=(), **fields):
    return SimpleNamespace(name=name, profiled=profiled, fields=fields,
                           device_ms=device_ms, spans=list(children))


def child(name, self_ms=0.0, device_ms=None):
    return SimpleNamespace(name=name, self_ms=self_ms, device_ms=device_ms)


def test_timed_takes_the_last_unprofiled_roots_that_sum_to_the_window():
    warm = [root("window", steps=8) for _ in range(2)]
    timed = [root("window", steps=8) for _ in range(3)]
    traced = [root("window", profiled=True, steps=8) for _ in range(2)]
    other = root("request.assemble")
    roots = warm + timed[:1] + [other] + timed[1:] + traced
    assert spans.timed(roots, "window", "steps", 24) == timed
    assert spans.timed(roots, "window", "steps", 40) == warm + timed


@pytest.mark.parametrize("total", [20, 48, 0, None])
def test_timed_is_none_where_no_roots_sum_to_the_window(total):
    roots = [root("window", steps=8) for _ in range(5)]
    assert spans.timed(roots, "window", "steps", total) is None
    assert spans.timed(None, "window", "steps", 8) is None


def _read(name, obs):
    return harness.reader(name)(obs)


def test_readers_on_hand_made_requests(monkeypatch):
    reqs = [root("request", device_ms=400.0, rays=640000, padded=15360,
                 children=[child("request.pad", 0.1, 0.5),
                           child("request.assemble", 0.2, 1.5),
                           child("request.fetch", 3.0)])
            for _ in range(2)]
    warm = root("request", device_ms=900.0, rays=640000, padded=15360)
    monkeypatch.setattr(spans, "records", lambda: [warm] + reqs)
    obs = {"kind": "render", "rays": 1280000, "wall_s": 1.0}
    assert _read("padded_ray_pct.render", obs) == pytest.approx(2.34375)
    assert _read("assemble_device_pct.render", obs) == pytest.approx(0.5)
    assert _read("untraced_idle_pct.render", obs) == pytest.approx(20.0)
    assert _read("untraced_idle_pct.train", obs) is None
    # a window that does not sum, or no recorder at all: nothing
    assert _read("padded_ray_pct.render", dict(obs, rays=10)) is None
    monkeypatch.setattr(spans, "records", lambda: None)
    assert _read("untraced_idle_pct.render", obs) is None


def test_readers_on_hand_made_windows(monkeypatch):
    wins = [root("window", device_ms=30.0, steps=8,
                 children=[child("window.stage", 0.04),
                           child("window.launch", 0.4),
                           child("window.outputs", 0.05)])
            for _ in range(4)]
    monkeypatch.setattr(spans, "records", lambda: wins)
    obs = {"kind": "train", "steps": 32, "wall_s": 0.125}
    assert _read("untraced_idle_pct.train", obs) == pytest.approx(4.0)
    assert _read("host_stage_ms_per_step.train", obs) == pytest.approx(0.005)
    assert _read("host_launch_ms_per_step.train", obs) == pytest.approx(0.05)
    wins[1].device_ms = None           # not timed on a card
    assert _read("untraced_idle_pct.train", obs) is None
    assert _read("host_stage_ms_per_step.train", obs) == pytest.approx(0.005)


@pytest.mark.parametrize("workload,host,device", [
    ("linear_train", ["host_stage_ms_per_step.train",
                      "host_launch_ms_per_step.train"],
     ["untraced_idle_pct.train"]),
    ("occ_render", ["padded_ray_pct.render"],
     ["untraced_idle_pct.render", "assemble_device_pct.render"])])
def test_a_tiny_traced_run_reads_the_host_spans(workload, host, device):
    """On the CPU the windows and requests have no device times: the
    readers of those give nothing, those of the host spans a number."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        res = run_tiny(workload, seed=5, seconds=0.3, trace=True)
    finally:
        torch.set_num_threads(n)
    assert res["correct"]
    for m in host:
        assert res["metrics"][m]["value"] >= 0.0, m
    for m in device:
        assert m not in res["metrics"], m
