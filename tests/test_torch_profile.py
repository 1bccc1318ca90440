"""The port's profiling path: ``plnerf_torch/utils/profile.py`` on
hand-built profiler events, and ``tools/profile_step.py`` and
``tools/bench_kernel.py`` end to end on the CPU at a tiny MLP (depth 4,
width 64)."""
import json
from types import SimpleNamespace

import pytest
import torch

from plnerf_torch.core.config import ModelConfig
from plnerf_torch.tools import bench_kernel, profile_step
from plnerf_torch.utils import profile

torch.set_num_threads(1)

CUDA, CPU = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
TINY = ModelConfig(netdepth=4, netwidth=64, skips=(2,), multires=6,
                   multires_views=2)


def _ev(key, device_type, device_us=0.0, cpu_us=0.0):
    return SimpleNamespace(key=key, device_type=device_type,
                           self_device_time_total=device_us,
                           self_cpu_time_total=cpu_us)


EVENTS = [
    _ev("void (anonymous namespace)::data_kernel<1>(...)", CUDA, 5300.0),
    _ev("void (anonymous namespace)::bf16_kernel<1>(...)", CUDA, 1500.0),
    _ev("void (anonymous namespace)::fp32_kernel<1>(...)", CUDA, 500.0),
    _ev("void (anonymous namespace)::weight_kernel(...)", CUDA, 1900.0),
    _ev("ampere_sgemm_128x64_nn", CUDA, 200.0),
    _ev("ampere_sgemm_128x64_nn", CUDA, 100.0),
    _ev("aten::mm", CPU, 0.0, 800.0),        # a CPU op: never device time
    _ev("aten::cat", CPU, 0.0, 1200.0),
    _ev("cudaLaunchKernel", CPU, 0.0, 50.0),
    _ev("idle_kernel", CUDA, 0.0),
]


def test_op_durations_sum_device_events_by_name():
    d = profile.op_durations(EVENTS)
    assert d["ampere_sgemm_128x64_nn"] == pytest.approx(0.3)
    assert "aten::mm" not in d and "idle_kernel" not in d
    assert sum(d.values()) == pytest.approx(9.5)


def test_top_device_ops_rank_largest_first():
    top = profile.top_device_ops(EVENTS, k=3)
    assert [name.split("::")[-1][:11] for name, _ in top] == \
        ["data_kernel", "weight_kern", "bf16_kernel"]
    assert [ms for _, ms in top] == pytest.approx([5.3, 1.9, 1.5])


def test_top_host_ops_rank_cpu_self_time():
    assert profile.top_host_ops(EVENTS, k=2) == [
        ("aten::cat", pytest.approx(1.2)), ("aten::mm", pytest.approx(0.8))]


REDUCES = [
    _ev("void (anonymous namespace)::reduce_kernel(float const*, float*)",
        CUDA, 400.0),
    _ev("void at::native::reduce_kernel<512, 1, at::native::ReduceOp<"
        "float>>(at::native::ReduceOp<float>)", CUDA, 700.0),
]


@pytest.mark.parametrize("events,reduce,other", [
    (EVENTS, 0.0, 0.3), (EVENTS + REDUCES, 0.4, 1.0)],
    ids=["port", "torch_reduce"])
def test_group_ms_splits_kernels_and_other(events, reduce, other):
    """The fused MLP's kernels by their names in the port
    (``FUSED_MLP_KERNELS``); PyTorch's own ``reduce_kernel`` is other."""
    ms = profile.group_ms(profile.op_durations(events))
    assert ms == pytest.approx({"fused_mlp_fwd": 2.0,
                                "fused_mlp_bwd_data": 5.3,
                                "fused_mlp_bwd_weight": 1.9,
                                "fused_mlp_bwd_reduce": reduce,
                                "other": other})


def test_profile_steps_on_cpu_reports_no_device_time():
    x = torch.randn(64, 64)
    out = profile.profile_steps(lambda: x @ x, 2, torch.device("cpu"),
                                top=3)
    assert out["device"] == "cpu" and out["steps"] == 2
    assert out["device_ms_per_step"] is None and out["top_device_ops"] == []
    assert out["wall_ms_per_step"] > 0
    assert any("mm" in name for name, _ in out["top_host_ops"])


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_profile_step_runs_on_cpu(fused):
    setup = profile_step.make_setup("linear", grad_accum=2,
                                    mlp_dtype="float32", fused=fused,
                                    mcfg=TINY)
    assert setup.accum_chunks == 2 and setup.rcfg.use_fused_mlp == fused
    res = profile_step.profile(setup, rays=16, steps=2, device="cpu", top=5)
    assert res["steps"] == 2 and res["ms_per_step"] > 0
    assert torch.isfinite(torch.tensor(res["loss"]))
    assert len(res["profile"]["top_host_ops"]) == 5


def test_profile_step_runs_the_occupancy_grid_step_on_cpu():
    """``--occ``: 32 guided coarse samples on a 128^3 grid with 96
    candidates, the grid updated every step, ``occ_ray_frac`` reported
    (the fresh grid is all occupied inside its box)."""
    setup = profile_step.make_setup("linear", mlp_dtype="float32",
                                    fused=True, mcfg=TINY, occ=True)
    assert setup.rcfg.n_samples == 32 and setup.rcfg.occ.resolution == 128
    assert setup.rcfg.occ.candidates == 96
    res = profile_step.profile(setup, rays=16, steps=2, device="cpu", top=5)
    assert res["steps"] == 2 and torch.isfinite(torch.tensor(res["loss"]))
    assert 0.0 < res["occ_ray_frac"] <= 1.0


def test_bench_kernel_runs_on_cpu():
    res = bench_kernel.run(TINY, 256, "cpu")
    labels = [r["label"] for r in res]
    assert labels == [f"{p} {k}" for p in ("unfused", "fused fold=0",
                                           "fused fold=1")
                      for k in ("fwd", "fwdbwd")]
    val = {r["label"]: r["value"] for r in res}
    # the fused paths compute the unfused MLP's function in bf16
    for p in ("fused fold=0", "fused fold=1"):
        for k in ("fwd", "fwdbwd"):
            ref = val[f"unfused {k}"]
            assert abs(val[f"{p} {k}"] - ref) <= 2e-2 * max(1.0, abs(ref))


def test_bench_kernel_bwd_ways_needs_a_card():
    """The fp32 backward's two ways (saved activations, recompute) are
    the kernel's: ``--what bwd`` refuses the CPU instead of timing the
    plain version under the kernel's name."""
    with pytest.raises(ValueError, match="CUDA"):
        bench_kernel.bwd_ways(TINY, "cpu")
    with pytest.raises(ValueError, match="CUDA"):
        bench_kernel.main(["--what", "bwd", "--device", "cpu"])


def _x(cat, name, ts, dur, tid=1):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "tid": tid}


TRACE = {"traceEvents": [
    _x("cpu_op", "CumprodBackward0", 0, 1000),
    _x("cpu_op", "aten::item", 100, 800),
    _x("cuda_runtime", "cudaStreamSynchronize", 200, 500),
    _x("cpu_op", "aten::to", 2000, 300, tid=2),
    _x("cuda_runtime", "cudaStreamSynchronize", 2100, 100, tid=2),
    _x("cuda_runtime", "cudaLaunchKernel", 2250, 10, tid=2),
    _x("cuda_runtime", "cudaStreamSynchronize", 3000, 200),
    _x("kernel", "k0", 0, 1000), _x("kernel", "k1", 1100, 400),
    _x("gpu_memcpy", "Memcpy HtoD", 2000, 50), _x("kernel", "k2", 2300, 700),
    {"ph": "i", "cat": "kernel", "name": "marker", "ts": 5000},
]}


def test_trace_host_syncs_group_by_enclosing_ops():
    assert profile.trace_host_syncs(TRACE) == [
        ("cudaStreamSynchronize < aten::item < CumprodBackward0", 1,
         pytest.approx(0.5)),
        ("cudaStreamSynchronize", 1, pytest.approx(0.2)),
        ("cudaStreamSynchronize < aten::to", 1, pytest.approx(0.1))]


def test_trace_device_gaps_count_idle_time_between_device_spans():
    gaps = profile.trace_device_gaps(TRACE)
    assert gaps["gaps"] == 2          # 0.5 ms and 0.25 ms; not 0.1 ms
    assert gaps["idle_ms"] == pytest.approx(0.75)
    assert gaps["span_ms"] == pytest.approx(3.0)
    assert gaps["largest_ms"] == pytest.approx([0.5, 0.25])


# --- the program's own spans (``profile.Recorder``) ----------------------


def _names(root):
    return [s.name for s in root.spans]


def test_spans_nest_and_self_time_is_less_the_children():
    rec = profile.Recorder()
    with rec.span("request", rays=4) as req:
        with rec.span("request.pad"):
            pass
        with rec.span("request.fetch") as fetch:
            with rec.span("inner"):
                pass
    (root,) = rec.records()
    assert root is req and root.parent is None and root.fields == {"rays": 4}
    assert _names(root) == ["request.pad", "request.fetch", "inner"]
    pad, fetch, inner = root.spans
    assert (pad.parent, fetch.parent, inner.parent) == (req.id, req.id,
                                                        fetch.id)
    assert req.child_ns == (pad.t1 - pad.t0) + (fetch.t1 - fetch.t0)
    assert fetch.self_ms == pytest.approx(fetch.ms - inner.ms)
    assert req.self_ms == pytest.approx(req.ms - pad.ms - fetch.ms)
    assert all(s.t0 >= req.t0 and s.t1 <= req.t1 for s in root.spans)
    assert not req.profiled and req.device_ms is None


def test_spans_of_one_window_share_its_id():
    rec = profile.Recorder()
    roots = []
    for _ in range(2):
        w = rec.open_span("window", kind="replay", steps=8)
        with rec.span("window.stage"):
            pass
        rec.start(w, torch.device("cpu"))
        with rec.span("window.launch"):
            pass
        rec.close(w)
        roots.append(w)
    assert rec.records() == roots and roots[0].id != roots[1].id
    for w in roots:
        assert {s.root for s in w.spans} == {w.id} == {w.root}
        assert _names(w) == ["window.stage", "window.launch"]
    assert rec.mark() == roots[1].id and rec.records(rec.mark()) == []
    assert rec.records(roots[0].id) == roots[1:]


def test_ring_stays_bounded():
    rec = profile.Recorder()
    for i in range(10 ** 5):
        with rec.span("window", steps=1):
            with rec.span("window.launch"):
                pass
    roots = rec.records()
    assert len(roots) == profile.RING == 4096
    assert roots[-1].id == 2 * 10 ** 5 - 1 and not rec._pending
    assert [len(r.spans) for r in roots] == [1] * 4096
    rec.clear()
    assert rec.records() == [] and rec.mark() == 0


class _Event:
    """A stand-in for a timing ``torch.cuda.Event``: the card passes it
    at once, at a clock of its own that each record moves on 1 ms."""
    clock = [0.0]

    def __init__(self):
        self.t = None

    def record(self, stream=None):
        self.clock[0] += 1.0
        self.t = self.clock[0]

    def query(self):
        return True

    def elapsed_time(self, other):
        return other.t - self.t


@pytest.fixture
def fake_card(monkeypatch):
    """A recorder whose spans started on ``cuda:0`` record ``_Event``s
    (the CPU build has no card)."""
    rec = profile.Recorder()
    made = []

    def event(idx):
        free = rec._events[idx]
        if free:
            return free.pop()
        made.append(_Event())
        return made[-1]
    monkeypatch.setattr(rec, "_event", event)
    monkeypatch.setattr(rec, "_stream", lambda idx: None)
    monkeypatch.setattr(torch._C, "_cuda_isCurrentStreamCapturing",
                        lambda: False)
    return rec, made


def test_events_give_device_times_and_gaps(fake_card):
    """Two requests, each with a padding span timed on the card: a span's
    device ms from its start event to its end event, a request's gap from
    the previous request's end event to its start event; the events read
    only at ``records``."""
    rec, made = fake_card
    card = torch.device("cuda", 0)
    for _ in range(2):
        with rec.span("request", card):
            with rec.span("request.pad", card):
                pass
            with rec.span("request.fetch"):
                pass
    assert len(rec._pending) == 4            # read only at ``records``
    a, b = rec.records()
    # start, pad start, pad end, end: 1 ms apart on the fake clock
    assert (a.device_ms, a.spans[0].device_ms) == (3.0, 1.0)
    assert (a.gap_ms, b.gap_ms, b.device_ms) == (None, 1.0, 3.0)
    assert b.spans[1].device_ms is None      # not started on the card
    assert sum(b.idle.values()) == pytest.approx(1.0)
    # every event back in the pool but b's end, which the next gap reads
    assert not rec._pending and (len(made), len(rec._events[0])) == (8, 7)


def test_pending_events_and_their_pool_stay_bounded(fake_card):
    """10^4 windows timed on the card and never read: a root's close
    reads the pending events once more than ``PENDING`` wait, so they and
    the pool of events stay bounded."""
    rec, made = fake_card
    card = torch.device("cuda", 0)
    most = 0
    for _ in range(10 ** 4):
        w = rec.open_span("window", steps=1)
        rec.start(w, card)
        rec.close(w)
        most = max(most, len(rec._pending))
    assert most == profile.PENDING
    assert len(made) <= 2 * profile.PENDING + 4
    wins = rec.records()
    assert not rec._pending and len(wins) == profile.RING
    assert all(w.device_ms == 1.0 and w.gap_ms == 1.0 for w in wins)


def test_span_under_the_profiler_is_flagged_and_traced(tmp_path):
    from torch.profiler import ProfilerActivity, profile as tprofile

    rec = profile.Recorder()
    with rec.span("request"):
        pass
    assert not profile.profiling()
    with tprofile(activities=[ProfilerActivity.CPU]) as prof:
        assert profile.profiling()
        with rec.span("request", rays=2):
            torch.ones(4).sum()
        w = rec.open_span("window")
        rec.start(w, torch.device("cpu"))
        rec.close(w)
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        names = [e["name"] for e in json.load(f)["traceEvents"]
                 if e.get("cat") == "user_annotation"]
    assert [r.profiled for r in rec.records()] == [False, True, True]
    assert names.count("request") == 1 and names.count("window") == 1


def test_a_span_opened_before_the_profiler_is_flagged_at_its_close():
    """A window opened before a trace starts (the drivers' ``--profile``)
    is flagged and traced from its ``start``, whose profiler it closes
    under."""
    from torch.profiler import ProfilerActivity, profile as tprofile

    rec = profile.Recorder()
    w = rec.open_span("window", steps=4)
    with tprofile(activities=[ProfilerActivity.CPU]):
        rec.start(w, torch.device("cpu"))
        rec.close(w)
    assert w.profiled


MS = 1_000_000   # ns


@pytest.mark.parametrize("gap,want", [
    (3.0, {"caller": 1.5, "window": 0.5, "window.stage": 1.0}),
    (4.5, {"window": 1.5, "caller": 2.0, "window.stage": 1.0}),
    (0.0, {"caller": 0.0})], ids=["host", "tail", "none"])
def test_a_gap_goes_to_the_host_spans_before_the_start_event(gap, want):
    """A window [0, 10] ms, the caller's code to 12, the next window from
    12 with its staging [12.2, 13.2] and its start event at 13.5: the gap
    before it put down to the host spans over the gap's length before
    13.5 (the first window's tail when it is longer than 3.5 ms)."""
    rec = profile.Recorder()
    a = rec.open_span("window")
    rec.close(a)
    b = rec.open_span("window")
    with rec.span("window.stage") as stage:
        pass
    rec.close(b)
    a.t0, a.t1 = 0, 10 * MS
    b.t0, b.t1, b.t_dev = 12 * MS, 14 * MS, int(13.5 * MS)
    stage.t0, stage.t1 = int(12.2 * MS), int(13.2 * MS)
    b.gap_ms = gap
    idle = rec.records()[1].idle
    assert idle == pytest.approx(want)
    assert sum(idle.values()) == pytest.approx(gap)


def test_window_report_on_host_spans_alone():
    from plnerf_torch.train import graph

    rec = profile.Recorder()
    for kind in ("first", "replay"):
        w = rec.open_span("window", kind=kind, steps=4)
        with rec.span("window.stage"):
            pass
        with rec.span("window.launch"):
            pass
        rec.close(w)
    roots = rec.records()
    text = graph.window_report(roots, 1.0)
    stage = sum(r.spans[0].self_ms for r in roots) / 8
    assert text.startswith(f"host ms/step stage {stage:.4f} launch ")
    assert "idle" not in text                      # no card, no idle share
    assert graph.window_report([], 1.0) == ""


def test_an_eager_window_through_graphs_leaves_one_window_record():
    """Graphs on the CPU: a window of kind first, then a staged one (kind
    capture, run eagerly here): each one ``window`` record with the right
    steps, the staged one with its ``window.stage`` and ``window.launch``
    spans."""
    from plnerf_torch.train import graph
    from plnerf_torch.train.step import stage_window

    state = SimpleNamespace(step=0, optimizers=lambda: [
        SimpleNamespace(rates=lambda n: [1e-3] * n)])
    feed = graph.Feed(4, "cpu", 1)
    g = graph.Graphs(torch.device("cpu"), 4)
    profile.RECORDER.clear()
    for _ in range(2):
        if g.schedule("a", 4) in graph.STAGED:
            stage_window(feed, state, 4)
        g.run("a", lambda n: {"loss": torch.zeros(())}, 4)
    first, staged = profile.records()
    assert [r.name for r in (first, staged)] == [graph.WINDOW_SPAN] * 2
    assert first.fields == {"kind": "first", "steps": 4}
    assert staged.fields == {"kind": "capture", "steps": 4}
    assert _names(first) == ["window.launch"]
    assert _names(staged) == ["window.stage", "window.launch"]
    assert all(s.root == staged.id for s in staged.spans)
    assert not profile.RECORDER._stack


def test_a_served_request_records_its_rays_padding_and_phases():
    """``ServingRenderer.render_image`` on the CPU: one ``request``
    record with the rays asked for and the padding to whole chunks, and
    its pad, assembly and fetch spans; an eval render of the same rays
    outside a request leaves no span."""
    from plnerf_torch.core.config import RenderConfig
    from plnerf_torch.core.mlp import NeRF
    from plnerf_torch.eval.images import render_image, test_render_config
    from plnerf_torch.serving.runtime import ServingRenderer

    nets = [NeRF(TINY, torch.Generator().manual_seed(i), "cpu")
            for i in range(2)]
    rcfg = test_render_config(RenderConfig(n_samples=8, n_importance=8),
                              perturb=False)
    srv = ServingRenderer.from_params(nets[0], nets[1], TINY, rcfg,
                                      chunk=16, device="cpu")
    profile.RECORDER.clear()
    K = [[5.0, 0, 3.0], [0, 5.0, 3.0], [0, 0, 1]]
    c2w = torch.eye(4)[:3].numpy()
    c2w[2, 3] = 4.0
    out = srv.render_image(c2w, (6, 6, 5.0), K)
    assert out["rgb_map"].shape == (6, 6, 3)
    (req,) = profile.records()
    assert req.name == "request" and req.fields == {"rays": 36, "padded": 12}
    assert _names(req) == ["request.pad", "request.assemble",
                           "request.fetch"]
    render_image(nets[0], nets[1], c2w, (6, 6, 5.0), K, TINY, rcfg,
                 chunk=16)
    assert profile.records(req.id) == [] and not profile.RECORDER._stack
