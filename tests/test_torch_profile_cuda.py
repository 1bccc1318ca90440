"""The span recorder's CUDA events (``plnerf_torch/utils/profile.py``)
on a card: an idle gap put down to the host span that caused it, a
window's event time against its kernels in a profiler's trace, and no
event recorded into a graph's capture.

This file imports neither JAX nor ``plnerf``: ``python -m pytest
--noconftest tests/test_torch_profile_cuda.py``.  Without a card every
test skips."""
import json
import os
import tempfile
import time
from types import SimpleNamespace

import pytest
import torch

from plnerf_torch.train import graph
from plnerf_torch.train.step import stage_window
from plnerf_torch.utils import profile

torch.set_num_threads(1)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the recorder's events time the "
                    "card (python -m pytest --noconftest "
                    "tests/test_torch_profile_cuda.py runs it there)")
    return torch.device("cuda")


def _matmul_body(dev, size=4096, reps=4):
    """A window body of ``reps`` fp32 products of ``size`` square
    matrices (~10 ms on an H100 at 4096) on static tensors."""
    torch.backends.cuda.matmul.allow_tf32 = False
    a = torch.randn(size, size, device=dev) / size ** 0.5
    b = torch.empty_like(a)

    def body(n):
        x = a
        for _ in range(reps):
            torch.mm(x, a, out=b)
            x = b
        return {"loss": b.sum()}
    return body


def _windows(dev, body, n_windows, stage=None, sync=True):
    """``n_windows`` windows of 4 through ``graph.Graphs`` (first,
    capture, replays), each staged (``stage``: a host stall inside the
    ``window.stage`` span instead of ``stage_window``) and followed by a
    sync where ``sync``; returns their records."""
    state = SimpleNamespace(step=0, optimizers=lambda: [
        SimpleNamespace(rates=lambda n: [1e-3] * n)])
    feed = graph.Feed(4, dev, 1)
    g = graph.Graphs(dev, 4)
    since = profile.mark()
    for _ in range(n_windows):
        if g.schedule("a", 4) in graph.STAGED:
            if stage is None:
                stage_window(feed, state, 4)
            else:
                with profile.span("window.stage"):
                    stage()
        g.run("a", body, 4)
        if sync:
            torch.cuda.synchronize(dev)
    torch.cuda.synchronize(dev)
    return profile.records(since)


def test_cuda_a_host_stall_is_put_down_to_its_span(cuda_device):
    """A 2 ms stall inside ``window.stage`` between replays that each end
    in a sync: the card's gap before each window holds it, put down to
    ``window.stage`` within 0.2 ms of the stall's host time."""
    wins = _windows(cuda_device, _matmul_body(cuda_device, 1024, 2), 8,
                    stage=lambda: time.sleep(0.002))
    assert [w.fields["kind"] for w in wins] == (
        ["first", "capture"] + ["replay"] * 6)
    for w in wins[2:]:
        (stall,) = [s for s in w.spans if s.name == "window.stage"]
        assert stall.self_ms >= 2.0
        assert w.gap_ms >= stall.self_ms
        assert abs(w.idle["window.stage"] - stall.self_ms) <= 0.2, w.idle
        assert max(w.idle, key=w.idle.get) == "window.stage"
        assert sum(w.idle.values()) == pytest.approx(w.gap_ms, abs=1e-3)


def _union_ms(trace):
    spans = sorted((e["ts"], e["ts"] + e["dur"])
                   for e in trace["traceEvents"] if e.get("ph") == "X"
                   and e.get("cat") in ("kernel", "gpu_memcpy",
                                        "gpu_memset"))
    total, end = 0.0, None
    for a, b in spans:
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total / 1e3


def test_cuda_window_event_time_matches_its_kernels(cuda_device):
    """One replayed window alone in a profiler session: its events' device
    ms within 5% of the union of the card's intervals in the trace."""
    body = _matmul_body(cuda_device)
    state = SimpleNamespace(step=0, optimizers=lambda: [
        SimpleNamespace(rates=lambda n: [1e-3] * n)])
    feed = graph.Feed(4, cuda_device, 1)
    g = graph.Graphs(cuda_device, 4)
    for _ in range(3):
        if g.schedule("a", 4) in graph.STAGED:
            stage_window(feed, state, 4)
        g.run("a", body, 4)
    torch.cuda.synchronize(cuda_device)
    since = profile.mark()
    assert g.schedule("a", 4) == "replay"
    stage_window(feed, state, 4)
    prof = profile.start_trace(cuda_device)
    g.run("a", body, 4)
    profile.end_trace(prof, cuda_device)
    (w,) = profile.records(since)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    union = _union_ms(trace)
    assert w.profiled and w.device_ms > 5.0
    assert abs(w.device_ms - union) <= 0.05 * union, (w.device_ms, union)


def test_cuda_no_event_is_recorded_into_a_capture(cuda_device,
                                                  monkeypatch):
    """The window body inside a span timed on the card, through the
    drivers' windows (first, capture, two replays, the last traced): the
    span inside the capture records no event and has no device time,
    every window has, and the traced replay runs the fused kernels of the
    traced eager window."""
    from plnerf_torch.train.step import MultiTrainStep
    from test_torch_kernel_cuda import GRAPH_N, _graph_run

    body = MultiTrainStep.window

    def timed(self, *a, **kw):
        with profile.span("window.body", cuda_device):
            return body(self, *a, **kw)
    monkeypatch.setattr(MultiTrainStep, "window", timed)
    since = profile.mark()
    *_, graphs, counts = _graph_run(cuda_device, "sampled", True,
                                    keys="vvvv", trace_from=3)
    wins = profile.records(since)
    *_, eager_counts = _graph_run(cuda_device, "sampled", False,
                                  keys="vvvv", trace_from=3)
    assert [w.fields["kind"] for w in wins] == ["first", "capture",
                                                "replay", "replay"]
    assert all(w.device_ms > 0 for w in wins)
    assert [w.profiled for w in wins] == [False, False, False, True]
    inner = {w.fields["kind"]: [s for s in w.spans
                                if s.name == "window.body"] for w in wins}
    assert inner["first"][0].device_ms > 0
    (captured,) = inner["capture"]
    assert captured.device_ms is None
    assert [s.name for s in wins[1].spans if s.id == captured.parent] == [
        "window.capture"]
    assert inner["replay"] == []
    assert counts == eager_counts and counts["weight_kernel"] == 2 * GRAPH_N
