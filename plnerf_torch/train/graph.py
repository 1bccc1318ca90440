"""A window of train steps as one device program: the port of the JAX
drivers' fused ``lax.scan`` windows (``plnerf/train/step.py``
``make_multi_train_step``; ``run_plnerf._make_sampled_step`` /
``_make_pool_step`` and ``run_depth._make_depth_step`` at ``n_inner > 1``).

On CUDA a full window of ``n_inner`` steps of one variant (a quadrature,
precrop or grid phase) runs as one replay of a CUDA graph.  The
variant's first full window runs eagerly on the capture stream: it builds
the kernels, makes Adam's state and the libraries' handles for that
stream.  Its second is captured and then replayed, and every later one
is replayed.  A window of fewer steps runs the same body eagerly, as
does every window on the CPU.  A capture that fails raises: nothing drops
back to eager steps.

Under data parallelism (``parallel/mesh.py``, NCCL) the window's
collectives are captured with it: the gradients' and metrics' all-reduce,
the space-carving loss's differentiable sum and the grid's max.  A
collective enqueues its work on the capturing stream and returns without
the host waiting, so the graph holds its kernel, and a replay runs it
with no call from the host (NCCL 2.9.6 or later).  The variant's first
window, run eagerly on the capture stream, also runs its collectives
there once before the capture.  Every rank must capture and replay the
same windows in the same order, or one rank replays a collective that
another never joins: the plan depends only on the window's length and
its variant, which every rank derives from the same arguments and host
counters (the occupancy advisory reads all-reduced metrics).  The gloo
group of a CPU run runs every window eagerly, as one device does there.

What a replay reads is static: the parameters, Adam's moments and its
device-side step counts, the rate tensors, the generator's state
(registered with the graph, so each replay's draws continue its stream
as eager steps would), the occupancy grid (written back in place at the
window's end), the ray pool (reshuffled in place) and the ``Feed``: the
per-step values the host knows (each optimizer's rate, the step count,
the pool offset, the image index), staged into device buffers through
pinned memory before each window that captures or replays, with no host
wait.  A window that runs eagerly takes those values from the host
instead.  The host's own counters that a replay skips (the state's step
and each optimizer's update count) advance by what the capture added to
them, once per replay.  The kernels' launch counters count only what
their wrappers launch: a replay's launches show in a device trace
(``utils/profile.trace_kernel_counts``).

The graphs of one run share one memory pool, which holds for graphs
replayed in the order of their captures: a variant's graph replays only
while it is the latest capture, and a variant that comes back after
another was captured (the NVS driver's uniform phase, when the occupancy
advisory drops the grid) is captured anew.  Every result a window leaves
for the next (parameters, Adam's state, the grid) lives outside the
pool, and the metrics a replay returns are copied out of it.
"""
from __future__ import annotations

import time
from collections import defaultdict
from typing import Callable, Dict, Hashable, List, Optional, Sequence, Tuple

import torch

from ..utils import profile


Metrics = Dict[str, torch.Tensor]

# the integer rows of a ``Feed``: the step count before each update, the
# pool offset of each step's batch, the image of each depth step
INT_ROWS = ("step", "offset", "img")


class Feed:
    """Per-step host values of a window in static device buffers:
    ``rates`` [n_rates, n] float64 (the optimizers' rates; float64 so
    that the CPU reads back the schedule's value exactly, the CUDA Adam
    rounds it to its float32 rate as ``fill_`` would) and one [n] int64
    row per name of ``INT_ROWS``."""

    def __init__(self, n: int, device: torch.device, n_rates: int):
        self.n, self.device = n, torch.device(device)
        self.rates = torch.zeros((n_rates, n), dtype=torch.float64,
                                 device=device)
        self.ints = torch.zeros((len(INT_ROWS), n), dtype=torch.int64,
                                device=device)

    def row(self, name: str) -> torch.Tensor:
        return self.ints[INT_ROWS.index(name)]

    def fill(self, rates: Sequence[Sequence[float]],
             **ints: Sequence[int]) -> None:
        """Stage a window's values: ``rates[i]`` and each of ``ints`` (a
        row of ``INT_ROWS``) hold one value per step, at most ``n``; the
        rest of each row and the rows not given read 0.  On CUDA each
        buffer takes one copy from pinned memory that the host does not
        wait for; the pinned block is not reused before its copy has run
        (the caching host allocator records the copy)."""
        rows = [list(r) for r in rates]
        ints_rows = [[int(x) for x in ints.get(name, ())] for name in INT_ROWS]
        if set(ints) - set(INT_ROWS) or len(rows) != self.rates.shape[0]:
            raise ValueError(f"rows {sorted(ints)} / {len(rows)} rates for "
                             f"a feed of {self.rates.shape[0]} rates")
        if any(len(r) > self.n for r in rows + ints_rows):
            raise ValueError(f"a window longer than {self.n} steps")
        for dst, src, dtype in ((self.rates, rows, torch.float64),
                                (self.ints, ints_rows, torch.int64)):
            padded = [r + [0] * (self.n - len(r)) for r in src]
            cuda = self.device.type == "cuda"
            dst.copy_(torch.tensor(padded, dtype=dtype, pin_memory=cuda),
                      non_blocking=cuda)


class _Program:
    """One variant's window: its graph once captured, the metrics' keys
    and static output, and what the capture added to each counter."""

    def __init__(self):
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.keys: List[str] = []
        self.out: Optional[torch.Tensor] = None
        self.delta: List[int] = []


# the kinds of window that read the staged ``Feed``
STAGED = ("capture", "replay")
# each window's span (``utils/profile``), the root of its ``window.stage``
# (``train/step.stage_window``), ``window.capture``, ``window.launch`` and
# ``window.outputs`` spans; in a ``torch.profiler`` trace it covers the
# launch and the outputs
WINDOW_SPAN = "window"


class Graphs:
    """The dispatch windows of one training run on ``device``: per
    variant ``key`` a ``_Program``, captured at the variant's second full
    window of ``n_inner`` steps and replayed from then on.

    Each window is planned (``schedule``: its kind, recorded in ``plan``
    whatever the device), then captured if it is a capture (``prepare``,
    outside any profiler span) and run (``run``).  ``counters``: (object,
    attribute) pairs of host integers a window advances (the state's step,
    the optimizers' counts).  ``generators``: those the steps draw from.
    ``capture`` False plans and runs every window eagerly, the reference
    a replay is held to; the drivers always capture, under a mesh too.
    ``captures``, ``replays`` and ``capture_s`` (the captures' host
    seconds) count what ran.

    ``schedule`` opens the window's span (``WINDOW_SPAN``, fields
    ``kind`` and ``steps``) and ``run`` closes it; on CUDA ``run`` times
    it on the card from just before the launch, after the staging and
    any capture, to after the outputs' copy."""

    def __init__(self, device: torch.device, n_inner: int,
                 counters: Sequence[Tuple[object, str]] = (),
                 generators: Sequence[torch.Generator] = (),
                 capture: bool = True):
        self.device, self.n_inner = torch.device(device), n_inner
        self.counters = list(counters)
        self.generators = [g for g in generators if g is not None]
        # the plan (which windows are graphs) does not depend on the
        # device; only CUDA captures them
        self.graphs = capture and n_inner > 1
        self.capture = self.graphs and self.device.type == "cuda"
        self.programs: Dict[Hashable, _Program] = {}
        self.captures = self.replays = 0
        self.capture_s = 0.0
        # [key, n, kind, repeats] runs of equal windows, kind "eager",
        # "first", "capture" or "replay": what a CUDA run does with each
        # (the CPU runs each one eagerly)
        self.plan: List[list] = []
        # the variant of the latest capture, and the window planned and
        # not yet run: [key, n, kind, captured]
        self.last: Optional[Hashable] = None
        self._next: Optional[list] = None
        self._span: Optional[profile.Span] = None
        self.pool = self.stream = None
        if self.capture:
            self.pool = torch.cuda.graph_pool_handle()
            self.stream = torch.cuda.Stream(self.device)

    def windows(self) -> List[Tuple[Hashable, int, str]]:
        """(key, n, kind) of every window planned, in order."""
        return [(k, n, kind) for k, n, kind, r in self.plan
                for _ in range(r)]

    def schedule(self, key: Hashable, n: int) -> str:
        """Plan the next window, ``n`` steps of variant ``key``: "eager"
        (fewer than ``n_inner`` steps, or no graphs), "first" (the
        variant's first full window), "capture" (its second, or its first
        since another variant was captured: captured, then replayed) or
        "replay".  A window of a kind in ``STAGED`` reads the ``Feed``."""
        if self._next is not None:
            raise RuntimeError(f"window {self._next[:3]} was planned and "
                               "not run")
        if not (self.graphs and n == self.n_inner):
            kind = "eager"
        elif key not in self.programs:
            kind = "first"
            self.programs[key] = _Program()
        elif self.last == key:
            kind = "replay"
        else:
            kind, self.last = "capture", key
        if self.plan and self.plan[-1][:3] == [key, n, kind]:
            self.plan[-1][3] += 1
        else:
            self.plan.append([key, n, kind, 1])
        self._next = [key, n, kind, False]
        self._span = profile.open_span(WINDOW_SPAN, kind=kind, steps=n)
        return kind

    def _planned(self, key: Hashable, n: int) -> list:
        if self._next is None:
            self.schedule(key, n)
        elif self._next[:2] != [key, n]:
            raise RuntimeError(f"window {self._next[:3]} was planned, "
                               f"{[key, n]} run")
        return self._next

    def prepare(self, key: Hashable, body: Callable[[int], Metrics],
                n: int) -> None:
        """Capture the window (planned by ``schedule``, else planned here)
        if it is a capture on CUDA.  A capture records and runs nothing;
        the drivers call this outside any profiler span, before ``run``
        replays it."""
        nxt = self._planned(key, n)
        if self.capture and nxt[2] == "capture" and not nxt[3]:
            with profile.span("window.capture"):
                self._capture(self.programs[key], body, n)
            nxt[3] = True

    def run(self, key: Hashable, body: Callable[[int], Metrics],
            n: int) -> Metrics:
        """The window (planned by ``schedule``, else planned here):
        ``body(n)`` returns the metrics of its last step (0-dim tensors).
        On CUDA a "first" window runs eagerly on the capture stream, a
        "capture" or "replay" one as a replay (captured first where
        ``prepare`` has not); any other window runs eagerly."""
        try:
            self.prepare(key, body, n)
            kind = self._next[2]
            self._next = None
            profile.start(self._span, self.device)
            if self.capture and kind in STAGED:
                return self._replay(self.programs[key])
            with profile.span("window.launch"):
                if self.capture and kind == "first":
                    return self._on_stream(body, n)
                return body(n)
        finally:
            if self._span is not None:
                profile.close(self._span)
                self._span = None

    def _on_stream(self, body, n: int) -> Metrics:
        cur = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(cur)
        with torch.cuda.stream(self.stream):
            out = body(n)
        cur.wait_stream(self.stream)
        for v in out.values():
            v.record_stream(cur)
        return out

    def _capture(self, prog: _Program, body, n: int) -> None:
        t0 = time.perf_counter()
        # an older graph of the variant gives its blocks back to the pool
        prog.graph = prog.out = None
        before = [getattr(o, a) for o, a in self.counters]
        g = torch.cuda.CUDAGraph()
        for gen in self.generators:
            g.register_generator_state(gen)
        try:
            with torch.cuda.graph(g, pool=self.pool, stream=self.stream):
                metrics = body(n)
                keys = list(metrics)
                out = torch.stack([metrics[k].reshape(()).float()
                                   for k in keys])
            prog.delta = [getattr(o, a) - b
                          for (o, a), b in zip(self.counters, before)]
        finally:
            # the capture ran nothing: the host's counters are as before
            for (o, a), b in zip(self.counters, before):
                setattr(o, a, b)
        prog.graph, prog.keys, prog.out = g, keys, out
        self.captures += 1
        self.capture_s += time.perf_counter() - t0

    def _replay(self, prog: _Program) -> Metrics:
        with profile.span("window.launch"):
            prog.graph.replay()
            for (o, a), d in zip(self.counters, prog.delta):
                setattr(o, a, getattr(o, a) + d)
            self.replays += 1
        with profile.span("window.outputs"):
            return dict(zip(prog.keys, prog.out.clone().unbind(0)))


def window_report(roots: Sequence[profile.Span], wall_s: float) -> str:
    """The windows among ``roots`` (``utils/profile.records``) over
    ``wall_s`` host seconds, for the drivers' print: host ms per step
    staging (``window.stage``) and launching (``window.launch``) them,
    and on the card its idle share (1 - their device ms over the wall
    time) and the host span with the most of the gaps before them."""
    wins = [r for r in roots if r.name == WINDOW_SPAN]
    steps = sum(r.fields.get("steps", 0) for r in wins)
    if not steps:
        return ""
    own: Dict[str, float] = defaultdict(float)
    idle: Dict[str, float] = defaultdict(float)
    for r in wins:
        for s in r.spans:
            own[s.name] += s.self_ms
        for k, v in (r.idle or {}).items():
            idle[k] += v
    text = (f"host ms/step stage {own['window.stage'] / steps:.4f} "
            f"launch {own['window.launch'] / steps:.4f}")
    if wall_s > 0 and all(r.device_ms is not None for r in wins):
        busy = sum(r.device_ms for r in wins) / 1e3
        text += f", idle {100.0 * (1.0 - busy / wall_s):.2f}%"
        if idle:
            k, v = max(idle.items(), key=lambda kv: kv[1])
            text += f" (most before windows: {k} {v:.1f} ms)"
    return text
