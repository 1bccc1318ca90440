"""The port's profiling path: ``plnerf_torch/utils/profile.py`` on
hand-built profiler events, and ``tools/profile_step.py`` and
``tools/bench_kernel.py`` end to end on the CPU at a tiny MLP (depth 4,
width 64)."""
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


def test_group_ms_splits_kernels_and_other():
    ms = profile.group_ms(profile.op_durations(EVENTS),
                          profile.FUSED_MLP_GROUPS)
    assert ms == pytest.approx({"fused_mlp_fwd": 2.0,
                                "fused_mlp_bwd_data": 5.3,
                                "fused_mlp_bwd_weight": 1.9,
                                "fused_mlp_bwd_reduce": 0.0, "other": 0.3})


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
