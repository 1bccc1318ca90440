"""Device time by kernel from a ``torch.profiler`` run, and a timer.

The counterpart of the JAX package's ``utils/xplane.py`` (``op_durations``,
``top_device_ops``), which reads a TPU profile's xplane file.  Here the
input is what ``torch.profiler.profile(...).key_averages()`` returns, or
any iterable of objects with its event fields (``key``, ``device_type``,
``self_device_time_total``, ``self_cpu_time_total``, times in us).

Only device-side events count as device time: a CPU op's entry repeats
the time of the kernels it launched.  ``profile_steps`` runs a few steps
under the profiler and splits device time into named kernel groups, the
rest and the device's busy share of the wall time.  ``trace_host_syncs``
and ``trace_device_gaps`` read the Chrome trace such a run exports: where
the host waits on the device, and how long the device idles between its
kernels.
"""
from __future__ import annotations

import statistics
import time
from collections import defaultdict
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import torch

# kernel-name patterns of the fused MLP's CUDA kernels
FUSED_MLP_GROUPS: Dict[str, Tuple[str, ...]] = {
    "fused_mlp_fwd": ("fp32_kernel", "bf16_kernel"),
    "fused_mlp_bwd_data": ("data_kernel",),
    "fused_mlp_bwd_weight": ("weight_kernel",),
    "fused_mlp_bwd_reduce": ("reduce_kernel",),
}


def _is_device(e) -> bool:
    return (e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0)


def op_durations(events: Iterable) -> Dict[str, float]:
    """{kernel name: device ms}, summed over the events."""
    out: Dict[str, float] = defaultdict(float)
    for e in events:
        if _is_device(e):
            out[e.key] += e.self_device_time_total / 1e3
    return dict(out)


def top_device_ops(events: Iterable, k: int = 25) -> List[Tuple[str, float]]:
    """Top-k (kernel name, device ms), largest first."""
    return sorted(op_durations(events).items(), key=lambda kv: -kv[1])[:k]


def top_host_ops(events: Iterable, k: int = 25) -> List[Tuple[str, float]]:
    """Top-k (CPU op name, self host ms), largest first: where the host
    spends the time between kernels."""
    out: Dict[str, float] = defaultdict(float)
    for e in events:
        if (e.device_type == torch.autograd.DeviceType.CPU
                and e.self_cpu_time_total > 0):
            out[e.key] += e.self_cpu_time_total / 1e3
    return sorted(out.items(), key=lambda kv: -kv[1])[:k]


def group_ms(durations: Dict[str, float],
             groups: Dict[str, Sequence[str]]) -> Dict[str, float]:
    """Device ms by group (a kernel joins the first group with a pattern in
    its name) and ``other`` for the rest."""
    ms = dict.fromkeys(list(groups) + ["other"], 0.0)
    for name, t in durations.items():
        ms[next((g for g, pats in groups.items()
                 if any(p in name for p in pats)), "other")] += t
    return ms


_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
GAP_MS = 0.2       # shorter device gaps are launch latency, not host work


def _spans(trace: dict, cats) -> List[dict]:
    return [e for e in trace["traceEvents"]
            if e.get("ph") == "X" and e.get("cat") in cats]


def trace_host_syncs(trace: dict) -> List[Tuple[str, int, float]]:
    """Every host wait on the device in a Chrome trace (a CUDA runtime
    ``*Synchronize`` call), grouped by the CPU ops of its thread that
    enclose it, innermost first: (op chain, count, ms), most ms first."""
    ops = _spans(trace, ("cpu_op",))
    count: Dict[str, int] = defaultdict(int)
    ms: Dict[str, float] = defaultdict(float)
    for s in _spans(trace, ("cuda_runtime",)):
        if "Synchronize" not in s["name"]:
            continue
        outer = sorted((o for o in ops if o.get("tid") == s.get("tid")
                        and o["ts"] <= s["ts"]
                        and o["ts"] + o["dur"] >= s["ts"] + s["dur"]),
                       key=lambda o: o["dur"])
        chain = " < ".join([s["name"]] + [o["name"] for o in outer[:5]])
        count[chain] += 1
        ms[chain] += s["dur"] / 1e3
    return sorted(((c, count[c], ms[c]) for c in count),
                  key=lambda t: -t[2])


def trace_device_gaps(trace: dict) -> dict:
    """Device idle time in a Chrome trace: the gaps longer than ``GAP_MS``
    between one kernel, copy or memset ending and the next starting, their
    count and ms, against the span from the first start to the last end."""
    spans = sorted(_spans(trace, _DEVICE_CATS), key=lambda e: e["ts"])
    gaps, end = [], None
    for e in spans:
        if end is not None and e["ts"] - end > GAP_MS * 1e3:
            gaps.append((e["ts"] - end) / 1e3)
        end = e["ts"] + e["dur"] if end is None else max(end,
                                                         e["ts"] + e["dur"])
    span = (end - spans[0]["ts"]) / 1e3 if spans else 0.0
    return {"gaps": len(gaps), "idle_ms": sum(gaps), "span_ms": span,
            "largest_ms": sorted(gaps, reverse=True)[:10]}


def profile_steps(run_step: Callable[[], object], n_steps: int,
                  device: torch.device, top: int = 12,
                  trace_path: Optional[str] = None) -> dict:
    """Run ``run_step`` ``n_steps`` times under ``torch.profiler``: device
    ms per step by group (``FUSED_MLP_GROUPS``), the device total, wall ms
    per step (profiler overhead included), the device's busy share of it,
    and the top device and host ops per step.  On the CPU no device time exists: those
    entries are None and the lists empty.  ``trace_path`` writes a Chrome
    trace."""
    from torch.profiler import ProfilerActivity, profile

    cuda = device.type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    sync()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            run_step()
        sync()
        wall_ms = (time.perf_counter() - t0) * 1e3
    if trace_path:
        prof.export_chrome_trace(trace_path)
    events = prof.key_averages()
    host = [[k[:60], ms / n_steps] for k, ms in top_host_ops(events, top)]
    out = {"device": device.type, "steps": n_steps,
           "wall_ms_per_step": wall_ms / n_steps, "top_host_ops": host}
    if not cuda:
        out.update(ms_per_step=None, device_ms_per_step=None,
                   device_busy_share=None, top_device_ops=[])
        return out
    durations = op_durations(events)
    total = sum(durations.values())
    out.update(
        ms_per_step={k: v / n_steps
                     for k, v in group_ms(durations,
                                          FUSED_MLP_GROUPS).items()},
        device_ms_per_step=total / n_steps, device_busy_share=total / wall_ms,
        top_device_ops=[[k[:60], ms / n_steps]
                        for k, ms in top_device_ops(events, top)])
    return out


def timed_ms(fn: Callable[[], object], device: torch.device,
             reps: int = 5) -> float:
    """Median time of ``fn`` in ms after one warm-up call: CUDA events on a
    CUDA device, the host clock on the CPU (a CPU time, never a device
    metric)."""
    fn()
    if device.type != "cuda":
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)
