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
kernels; ``trace_kernel_counts`` counts its kernels by name.
``start_trace`` / ``stop_trace`` (or ``end_trace``) bracket a window of
a training loop (the drivers' ``--profile N``).

The program's own spans, always on and timed without the profiler
(``Recorder``, one per process: ``RECORDER``, and its methods ``span``,
``open_span``, ``start``, ``close``, ``records``, ``mark``): a span at
each dispatch window (``train/graph.Graphs``) and served request
(``serving/runtime.ServingRenderer``) and at the phases inside them, and
on the card a pair of CUDA events around each window, request, padding
and chunk assembly, which give its device time and the card's idle time
before it, put down to what the host was doing then.
"""
from __future__ import annotations

import itertools
import json
import os
import re
import statistics
import time
from collections import defaultdict, deque
from typing import (Callable, Deque, Dict, Iterable, List, Optional,
                    Sequence, Tuple)

import torch

# the fused MLP's kernels by their names in a Chrome trace (group 1 the
# short name): a forward call launches one ``bf16_kernel``, or one
# ``fp32_kernel`` per product and chunk; a backward call one each of
# ``weight_kernel`` and ``reduce_kernel`` and its data pass
# (``data_kernel``, or ``sgemm_data_kernel`` per product);
# ``trace_kernel_counts`` counts them where the wrappers' counters cannot
# (a CUDA graph's replays)
FUSED_MLP_KERNELS = (r"\(anonymous namespace\)::(fp32_kernel|bf16_kernel|"
                     r"sgemm_data_kernel|data_kernel|weight_kernel|"
                     r"reduce_kernel|transpose_kernel|cot_data_kernel)\b")

# the fused MLP's kernels by group, by their short names in
# ``FUSED_MLP_KERNELS`` (PyTorch's own ``at::native::reduce_kernel`` is
# none of them)
FUSED_MLP_GROUPS: Dict[str, Tuple[str, ...]] = {
    "fused_mlp_fwd": ("fp32_kernel", "bf16_kernel"),
    "fused_mlp_bwd_data": ("sgemm_data_kernel", "data_kernel",
                           "cot_data_kernel"),
    "fused_mlp_bwd_weight": ("weight_kernel",),
    "fused_mlp_bwd_reduce": ("reduce_kernel",),
}


def fused_group(name: str,
                groups: Dict[str, Sequence[str]] = FUSED_MLP_GROUPS
                ) -> Optional[str]:
    """The group of ``groups`` that holds the fused-MLP kernel ``name``
    (a kernel's name in a trace), None for any other kernel."""
    m = re.search(FUSED_MLP_KERNELS, name)
    return None if m is None else next(
        (g for g, short in groups.items() if m.group(1) in short), None)


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
             groups: Dict[str, Sequence[str]] = FUSED_MLP_GROUPS
             ) -> Dict[str, float]:
    """Device ms by group of the fused MLP's kernels (``fused_group``)
    and ``other`` for the rest."""
    ms = dict.fromkeys(list(groups) + ["other"], 0.0)
    for name, t in durations.items():
        ms[fused_group(name, groups) or "other"] += t
    return ms


_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
GAP_MS = 0.2       # shorter device gaps are launch latency, not host work
# The profiler keeps only the device records whose stamps fall inside its
# session, and a session's kernel stamps run early against the host's
# clock (on an H100 with torch 2.11 a replayed window lost its first ~370
# kernel records in every session that began just before it, and in one
# of 80 sessions, stamped ~3.4 ms early, its first fused kernels too;
# its copies were stamped on time).  So a session opens, and closes,
# with this much host time in which the device runs nothing, and a
# window's kernels are counted over the whole session (which holds
# nothing else), never cut at a host time.
TRACE_MARGIN_S = 0.05


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


def trace_kernel_counts(trace: dict, pattern: str = FUSED_MLP_KERNELS
                        ) -> Dict[str, int]:
    """{name: count} of the kernels of a Chrome trace whose name matches
    ``pattern`` (a regular expression; the name is its group 1, else the
    whole name): launches as the device ran them, a CUDA graph's
    included.  The device's stamps can run off the host's clock
    (``TRACE_MARGIN_S``), so a window is counted as a whole session that
    holds only it (``start_trace``), never cut at a host time."""
    out: Dict[str, int] = defaultdict(int)
    for e in _spans(trace, ("kernel",)):
        m = re.search(pattern, e["name"])
        if m:
            out[m.group(1) if m.groups() else e["name"]] += 1
    return dict(out)


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
    margin = TRACE_MARGIN_S if cuda else 0.0
    sync()
    with profile(activities=acts) as prof:
        time.sleep(margin)
        t0 = time.perf_counter()
        for _ in range(n_steps):
            run_step()
        sync()
        wall_ms = (time.perf_counter() - t0) * 1e3
        time.sleep(margin)
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


def start_trace(device: torch.device):
    """A running ``torch.profiler`` session (CPU and, on CUDA, the
    device's kernels) for ``stop_trace``.  On CUDA it begins once the
    device has run what was queued before, and ``TRACE_MARGIN_S`` before
    anything is launched: the trace holds only what follows."""
    from torch.profiler import ProfilerActivity, profile

    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    prof = profile(activities=acts)
    prof.start()
    if cuda:
        time.sleep(TRACE_MARGIN_S)
    return prof


def end_trace(prof, device: torch.device) -> None:
    """End ``prof`` once the device has run its queued work and
    ``TRACE_MARGIN_S`` has passed."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        time.sleep(TRACE_MARGIN_S)
    prof.stop()


def stop_trace(prof, trace_path: str, device: torch.device, steps: int,
               top: int = 10) -> dict:
    """End ``prof`` (``end_trace``), write its Chrome trace to
    ``trace_path`` and return the window's top device and host ops in ms
    per step and its device gaps (``trace_device_gaps``; none on the
    CPU)."""
    end_trace(prof, device)
    os.makedirs(os.path.dirname(trace_path) or ".", exist_ok=True)
    prof.export_chrome_trace(trace_path)
    events = prof.key_averages()
    with open(trace_path) as f:
        gaps = trace_device_gaps(json.load(f))
    per = max(steps, 1)
    return {"trace": trace_path, "steps": steps,
            "top_device_ops": [[k, ms / per]
                               for k, ms in top_device_ops(events, top)],
            "top_host_ops": [[k, ms / per]
                             for k, ms in top_host_ops(events, top)],
            "device_gaps": gaps}


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


# ---------------------------------------------------------------------------
# the program's own spans
# ---------------------------------------------------------------------------

# roots (windows, requests) a recorder keeps, each with its spans
RING = 4096
# spans with both events recorded that a root's close lets wait before it
# reads them (``records`` reads them all)
PENDING = 256


# () -> True while a ``torch.profiler`` session records
profiling = torch._C._autograd._profiler_enabled


class Span:
    """One span: ``name``, ``id``, ``parent`` (its id; None for a root,
    a window or a request), ``root`` (the root's id, which every span of
    one window or request shares), host ``t0`` / ``t1`` ns
    (``time.perf_counter_ns``), ``fields``, ``profiled`` (a
    ``torch.profiler`` session recorded when it opened, or for a window
    when it started, so its host times hold the profiler's cost) and
    ``child_ns`` (the host ns its children cover).  A root's ``spans``
    are its descendants in the order they opened.

    A span started on the card (``Recorder.start``) gets, once
    ``Recorder.records`` reads its events, ``device_ms``: its start
    event to its end event.  A root also gets ``gap_ms``, the card's idle
    time from the previous root's end event to its start event, and
    ``idle`` {span name: ms}: that gap put down to the self time of the
    host spans that overlap the host interval of the gap's length ending
    where the start event was recorded (``t_dev``), the rest to
    ``caller``, the code between two calls into the program."""

    __slots__ = ("name", "id", "parent", "root", "t0", "t1", "fields",
                 "profiled", "child_ns", "spans", "device_ms", "gap_ms",
                 "idle", "t_dev", "_up", "_top", "_ev", "_prev", "_dev",
                 "_rf", "_rec")

    def __init__(self, rec: "Recorder", name: str, id: int,
                 up: Optional["Span"], fields: dict):
        self._rec, self.name, self.id, self.fields, self._up = (
            rec, name, id, fields, up)
        if up is None:
            self._top, self.parent, self.root = self, None, id
        else:
            self._top, self.parent, self.root = up._top, up.id, up.root
        self.t0 = self.t1 = self.t_dev = self.device_ms = self.gap_ms = \
            self.idle = self._ev = self._prev = self._dev = self._rf = None
        self.profiled = False
        self.child_ns = 0
        self.spans: List[Span] = []

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, *exc) -> None:
        self._rec.close(self)

    @property
    def ms(self) -> float:
        return (self.t1 - self.t0) / 1e6

    @property
    def self_ms(self) -> float:
        return (self.t1 - self.t0 - self.child_ns) / 1e6


class Recorder:
    """The spans of one thread, the program's: a span opened where none
    is open is a root.  The ring holds the last ``RING`` roots with their
    spans.

    On a CUDA device a started span records a timing event on the
    current stream at its start and one on the same stream at its close
    (never inside a graph capture), taken from a pool; ``records`` reads
    them, and a root's close only once more than ``PENDING`` spans wait,
    each once ``query`` says the card passed it, so no call waits on the
    card.  Under a running ``torch.profiler`` session a span also opens a
    ``record_function`` of its name, on the trace's clock, and is flagged
    ``profiled``."""

    def __init__(self):
        self.clear()

    def clear(self) -> None:
        """Forget every span."""
        self.roots: Deque[Span] = deque(maxlen=RING)
        self._stack: List[Span] = []
        self._ids = itertools.count(1)
        # spans with both events recorded, oldest first
        self._pending: Deque[Span] = deque()
        # free timing events, the last root timed and the current stream
        # (its key and object), per card
        self._events: Dict[int, list] = defaultdict(list)
        self._last: Dict[int, Span] = {}
        self._streams: Dict[int, tuple] = {}

    def _open(self, name: str, fields: dict, annotate: bool) -> Span:
        t0 = time.perf_counter_ns()
        st = self._stack
        s = Span(self, name, next(self._ids), st[-1] if st else None,
                 fields)
        s.t0 = t0
        if s._up is not None:
            s._top.spans.append(s)
        if annotate and profiling():
            s.profiled = True
            s._rf = _annotation(name)
        st.append(s)
        return s

    def open_span(self, name: str, **fields) -> Span:
        """Open a span that another call starts (``start``) and closes
        (``close``): the window, which ``Graphs.schedule`` opens and
        ``Graphs.run`` starts and closes.  Whether a profiler records it
        is asked at ``start``: the calls between may start a trace or
        capture a graph, which waits on the card."""
        return self._open(name, fields, annotate=False)

    def span(self, name: str, device: Optional[torch.device] = None,
             **fields) -> Span:
        """``with span(name, **fields) as s``: a span around the block;
        ``device``: started there on the card at once (``start``)."""
        s = self._open(name, fields, annotate=True)
        if device is not None:
            try:
                self.start(s, device)
            except BaseException:
                self.close(s)
                raise
        return s

    def start(self, s: Span, device: Optional[torch.device]) -> None:
        """Start ``s`` on the card: its start event on the current stream
        of ``device`` (a CUDA device; nothing elsewhere or inside a
        capture), a root's gap read from the previous root's end event
        there.  A span of ``open_span`` shows in a profiler's trace from
        here."""
        if s._rf is None and not s.profiled and profiling():
            s.profiled = True
            s._rf = _annotation(s.name)
        if device is None:
            return
        dev = device if isinstance(device, torch.device) \
            else torch.device(device)
        if dev.type != "cuda" or torch._C._cuda_isCurrentStreamCapturing():
            return
        idx = torch.cuda.current_device() if dev.index is None else dev.index
        ev, stream = self._event(idx), self._stream(idx)
        s._dev, s._ev = idx, [ev, None, stream]
        if s._up is None:
            s._prev = self._last.get(idx)
        s.t_dev = time.perf_counter_ns()
        ev.record(stream)

    def close(self, s: Span) -> None:
        """Close ``s``, and any span still open inside it: its end event
        where it was started on the card."""
        if s.t1 is not None:
            return
        if s._ev is not None:
            end = s._ev[1] = self._event(s._dev)
            end.record(s._ev.pop())
            self._pending.append(s)
        st = self._stack
        if st and st[-1] is s:
            st.pop()
        elif s in st:
            while st[-1] is not s:
                self.close(st[-1])
            st.pop()
        if s._rf is not None:
            s._rf.__exit__(None, None, None)
            s._rf = None
        if s._up is None:
            self.roots.append(s)
            if s._ev is not None:
                self._last[s._dev] = s
                if len(self._pending) > PENDING:
                    self._resolve()
        else:
            s._top.profiled |= s.profiled
        # the recorder's own work counts in the span it serves
        t1 = s.t1 = time.perf_counter_ns()
        if s._up is not None:
            s._up.child_ns += t1 - s.t0

    def mark(self) -> int:
        """The latest root's id (0: none): ``records(mark())`` holds the
        roots that close from here on."""
        return self.roots[-1].id if self.roots else 0

    def records(self, since: int = 0) -> List[Span]:
        """The ring's roots with ids above ``since``, oldest first, their
        events read as far as the card has run them (all of them after
        the caller's sync) and their gaps put down to host spans."""
        self._resolve()
        roots, out = list(self.roots), []
        for i, r in enumerate(roots):
            if r.id > since:
                out.append(r)
                if r.idle is None and r.gap_ms is not None:
                    r.idle = self._idle(roots, i)
        return out

    def _event(self, idx: int) -> "torch.cuda.Event":
        free = self._events[idx]
        return free.pop() if free else torch.cuda.Event(enable_timing=True)

    def _stream(self, idx: int) -> "torch.cuda.Stream":
        """The current stream of card ``idx`` (``torch.cuda.current_stream``
        without building its object anew each call)."""
        key = torch._C._cuda_getCurrentStream(idx)
        got = self._streams.get(idx)
        if got is None or got[0] != key:
            got = self._streams[idx] = (key, torch.cuda.Stream(
                stream_id=key[0], device_index=key[1], device_type=key[2]))
        return got[1]

    def _resolve(self) -> None:
        """Read the times of the oldest pending spans whose end events the
        card has passed and free their events, but a root's end event,
        which the next root's gap reads."""
        while self._pending and self._pending[0]._ev[1].query():
            s = self._pending.popleft()
            free = self._events[s._dev]
            start, end = s._ev
            s.device_ms = start.elapsed_time(end)
            p, s._prev = s._prev, None
            if p is not None and p._ev is not None:
                s.gap_ms = max(p._ev[1].elapsed_time(start), 0.0)
                free.append(p._ev[1])
                p._ev = None
            free.append(start)
            if s._up is None:
                s._ev = [None, end]
            else:
                free.append(end)
                s._ev = None

    @staticmethod
    def _idle(roots: List[Span], i: int) -> Dict[str, float]:
        """The gap of ``roots[i]`` put down to host spans (``Span``), in
        ms, from the spans of it and of the roots before it."""
        r = roots[i]
        hi = r.t_dev
        lo = hi - int(r.gap_ms * 1e6)
        by: Dict[str, int] = defaultdict(int)
        for j in range(i, -1, -1):
            root = roots[j]
            if root.t1 <= lo:
                break
            for s in [root] + root.spans:
                ov = min(s.t1 if s.t1 is not None else hi, hi) - max(s.t0, lo)
                if ov > 0:
                    by[s.name] += ov
                    if s._up is not None:
                        by[s._up.name] -= ov
        out = {k: v / 1e6 for k, v in by.items() if v > 0}
        out["caller"] = max(hi - lo - sum(by.values()), 0) / 1e6
        return out


def _annotation(name: str):
    rf = torch.autograd.profiler.record_function(name)
    rf.__enter__()
    return rf


RECORDER = Recorder()
span, open_span, start = RECORDER.span, RECORDER.open_span, RECORDER.start
close, records, mark = RECORDER.close, RECORDER.records, RECORDER.mark
