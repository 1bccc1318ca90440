"""The trace reader on a small hand-made Chrome trace."""
import pytest

from portbench.lib import trace


def ev(name, ts, dur, cat="kernel", tid=7):
    return {"ph": "X", "name": name, "ts": ts, "dur": dur, "cat": cat,
            "tid": tid}


FWD = "void (anonymous namespace)::fp32_kernel<8>(float const*)"
DATA = "void (anonymous namespace)::sgemm_data_kernel(float*)"
OWN_REDUCE = "(anonymous namespace)::reduce_kernel(float const*, float*)"
TORCH_REDUCE = ("void at::native::reduce_kernel<512, 1, at::native::"
                "ReduceOp<float>>(at::native::ReduceOp<float>)")


def test_fused_groups_match_only_the_ports_kernels():
    assert trace.fused_group(FWD) == "fwd"
    assert trace.fused_group("(anonymous namespace)::bf16_kernel") == "fwd"
    assert trace.fused_group(DATA) == "bwd"
    assert trace.fused_group(OWN_REDUCE) == "bwd"
    assert trace.fused_group(TORCH_REDUCE) is None
    assert trace.fused_group("void at::native::vectorized_elementwise_"
                             "kernel<4>") is None


def test_summary_busy_union_groups_and_breakdown():
    t = {"traceEvents": [
        ev(FWD, 1000, 300),
        ev(TORCH_REDUCE, 1200, 200),        # overlaps the forward
        ev(DATA, 2000, 500),
        ev("Memcpy HtoD", 3000, 100, cat="gpu_memcpy"),
        ev(OWN_REDUCE, 3100, 100),
        ev("portbench.window", 900, 3000, cat="user_annotation"),
        ev("aten::copy_", 1350, 700, cat="cpu_op"),
        {"ph": "i", "name": "marker", "ts": 0},
    ]}
    s = trace.summarize(t, window_s=0.004)
    # union: [1000, 1400] + [2000, 2500] + [3000, 3200] = 1100 us
    assert s["busy_s"] == pytest.approx(1100e-6)
    assert s["fused_s"]["fwd"] == pytest.approx(300e-6)
    assert s["fused_s"]["bwd"] == pytest.approx(600e-6)
    assert s["other_s"] == pytest.approx(300e-6)
    assert s["n_device_ops"] == 5
    ops = s["breakdown"]["device_ops"]
    assert ops[0] == [DATA, pytest.approx(500e-6)]
    assert len(ops) == 5
    gaps = s["breakdown"]["idle_gaps"]
    # the longest gap (1400 -> 2000) began inside aten::copy_, the
    # innermost open span; the next (2500 -> 3000) inside the window only
    assert gaps[0] == ["aten::copy_", pytest.approx(600e-6)]
    assert gaps[1] == ["portbench.window", pytest.approx(500e-6)]
    assert len(gaps) == 2


def test_breakdown_holds_at_most_ten_entries():
    t = {"traceEvents": [ev(f"k{i}", i * 100, 10) for i in range(30)]}
    s = trace.summarize(t, window_s=0.01)
    assert len(s["breakdown"]["device_ops"]) == 10
    assert len(s["breakdown"]["idle_gaps"]) == 10
    assert s["breakdown"]["idle_gaps"][0][0] == "no host span"
