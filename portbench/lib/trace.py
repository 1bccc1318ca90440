"""A traced slice of a run and what the per-layer readers take from it.

``Session`` brackets a slice with ``torch.profiler`` the way the
program's ``utils/profile.start_trace`` / ``end_trace`` do: a sync before
the session opens and ``MARGIN_S`` of host time before the first launch,
a sync and the same margin before it closes, so no device record that the
profiler stamps early or late falls outside it.  The Chrome trace goes to
a temporary file under ``TMPDIR``, is read, and is deleted.

``summarize`` turns a Chrome trace into what the readers need: the union
of the device's busy intervals, device seconds by kernel, the fused MLP's
kernels by group (matched by the port's own names only: PyTorch's
``at::native::reduce_kernel`` is no fused kernel), the ``breakdown`` of
the result line (top device operations, longest idle gaps labelled by
the host span that was open when each began).
"""
from __future__ import annotations

import json
import os
import re
import tempfile
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

MARGIN_S = 0.05
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# the fused MLP's kernels by their names in a Chrome trace: they live in
# an anonymous namespace of csrc/fused_mlp_fwd.cu and fused_mlp_bwd.cu
FUSED_MLP = re.compile(
    r"\(anonymous namespace\)::(fp32_kernel|bf16_kernel|sgemm_data_kernel|"
    r"data_kernel|weight_kernel|reduce_kernel|transpose_kernel|"
    r"cot_data_kernel)\b")
FWD_KERNELS = ("fp32_kernel", "bf16_kernel")
BREAKDOWN_ENTRIES = 10
# host spans of the harness that label the device's idle gaps
HOST_CATS = ("user_annotation", "cpu_op", "python_function")


def fused_group(name: str) -> Optional[str]:
    """"fwd" or "bwd" for a fused-MLP kernel's name, else None."""
    m = FUSED_MLP.search(name)
    if m is None:
        return None
    return "fwd" if m.group(1) in FWD_KERNELS else "bwd"


class Session:
    """``with Session(device) as s: ...``; then ``s.summary`` (None on
    a device other than CUDA, where no device trace exists)."""

    def __init__(self, device):
        self.device = device
        self.summary: Optional[dict] = None

    def __enter__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        self.cuda = self.device.type == "cuda"
        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if self.cuda else [])
        if self.cuda:
            torch.cuda.synchronize(self.device)
        self.prof = profile(activities=acts)
        self.prof.start()
        if self.cuda:
            time.sleep(MARGIN_S)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        import torch

        if self.cuda:
            torch.cuda.synchronize(self.device)
        window_s = time.perf_counter() - self.t0
        if self.cuda:
            time.sleep(MARGIN_S)
        self.prof.stop()
        if exc[0] is not None or not self.cuda:
            return False
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                trace = json.load(f)
        finally:
            os.remove(path)
        self.summary = summarize(trace, window_s)
        return False


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _short(name: str, n: int = 120) -> str:
    return name if len(name) <= n else name[:n]


def summarize(trace: dict, window_s: float) -> dict:
    """What the readers take from a Chrome trace of a slice that lasted
    ``window_s`` host seconds: ``busy_s`` (the union of the device's
    kernel, copy and memset intervals), ``window_s``, ``kernel_s`` {name:
    device s}, ``fused_s`` {"fwd", "bwd": device s}, ``other_s`` (device
    s of every other kernel, copy and memset), ``n_device_ops``, and
    ``breakdown`` (``device_ops``, ``idle_gaps``: at most
    ``BREAKDOWN_ENTRIES`` each, seconds as measured)."""
    events = [e for e in trace.get("traceEvents", []) if e.get("ph") == "X"]
    dev = [e for e in events if e.get("cat") in DEVICE_CATS]
    kernel_s: Dict[str, float] = defaultdict(float)
    fused = {"fwd": 0.0, "bwd": 0.0}
    other = 0.0
    for e in dev:
        s = e["dur"] / 1e6
        kernel_s[e["name"]] += s
        g = fused_group(e["name"]) if e["cat"] == "kernel" else None
        if g is None:
            other += s
        else:
            fused[g] += s
    busy = _union([(e["ts"], e["ts"] + e["dur"]) for e in dev])
    busy_s = sum(b - a for a, b in busy) / 1e6
    gaps = [(busy[i][1], busy[i + 1][0]) for i in range(len(busy) - 1)]
    gaps.sort(key=lambda g: g[0] - g[1])
    host = [e for e in events if e.get("cat") in HOST_CATS]
    idle = []
    for a, b in gaps[:BREAKDOWN_ENTRIES]:
        # the innermost host span open when the gap began
        open_ = [h for h in host if h["ts"] <= a <= h["ts"] + h["dur"]]
        label = (min(open_, key=lambda h: h["dur"])["name"] if open_
                 else "no host span")
        idle.append([_short(label), (b - a) / 1e6])
    top = sorted(kernel_s.items(), key=lambda kv: -kv[1])
    return {"busy_s": busy_s, "window_s": window_s,
            "kernel_s": dict(kernel_s), "fused_s": fused, "other_s": other,
            "n_device_ops": len(dev),
            "breakdown": {
                "device_ops": [[_short(k), v]
                               for k, v in top[:BREAKDOWN_ENTRIES]],
                "idle_gaps": idle}}
