"""One run of one cell: find the cell's files by the names in
``BENCHMARK.json``, run its traffic's driver, read its metrics, decide
``correct`` and print the result line.

A cell is a configuration (``configs/<config>.json``: the program's
flags, the scene, the sizes assumed) under a traffic mix
(``traffic/<traffic>.json``: the parameters that its ``driver``,
``drivers/<driver>.py``, reads); its limits on the numbers that decide
``correct`` are ``limits/<workload>.json``; a per-layer metric is read by
``metrics/<metric>.py`` (``read(obs) -> float | None``).  Adding a cell,
a mix or a metric adds files and entries, and edits none.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import math
import os
import sys
import time
from typing import Callable, Optional

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)
# modules that must not be loaded in a run's process (top-level names,
# compared whole: the port's name begins with the JAX package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "plnerf")


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


class Cell:
    """The files of one workload of ``BENCHMARK.json``."""

    def __init__(self, name: str, root: str = ROOT):
        self.spec = load_json(os.path.join(root, "BENCHMARK.json"))
        found = [w for w in self.spec["workloads"] if w["name"] == name]
        if not found:
            raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
        self.workload = found[0]
        conf = [c for c in self.spec["configs"]
                if c["name"] == self.workload["config"]][0]
        self.config = load_json(os.path.join(root, conf["file"]))
        self.traffic = load_json(os.path.join(
            HERE, "traffic", self.workload["traffic"] + ".json"))
        self.limits = load_json(os.path.join(HERE, "limits", name + ".json"))
        self.chips = int(self.workload["chips"])

    def end_to_end(self) -> list:
        return [m for m in self.spec["end_to_end"]
                if self.workload["name"] in m.get("workloads", [
                    self.workload["name"]])]

    def per_layer(self) -> list:
        mine = {m["name"] for m in self.end_to_end()}
        name = self.workload["name"]
        return [m for m in self.spec["per_layer"]
                if (name in m["workloads"] if "workloads" in m
                    else m["moves"] in mine)]


def reader(name: str) -> Callable[[dict], Optional[float]]:
    """``read`` of ``metrics/<name>.py`` (the name may hold dots)."""
    path = os.path.join(HERE, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def driver(name: str):
    return importlib.import_module(f"portbench.drivers.{name}")


class Ctx:
    """What a driver is given."""

    def __init__(self, cell: Cell, seed: int, seconds: float, trace: bool,
                 device, t_start: float):
        self.cell, self.seed, self.seconds = cell, int(seed), float(seconds)
        self.trace, self.device, self.t_start = trace, device, t_start
        self.flags = dict(cell.config["flags"])
        self.scene = dict(cell.config["scene"])
        self.traffic = dict(cell.traffic)
        # the reference's view: the flags and the scene's bounds
        self.ref_flags = dict(self.flags, near=self.scene["near"],
                              far=self.scene["far"])

    def program_args(self):
        """The program's parsed flags (its driver's own parser and
        defaults) for this configuration; on the CPU its kernels' plain
        versions."""
        from plnerf_torch.cli.config import config_parser

        argv = []
        for k, v in self.flags.items():
            if v is True:
                argv.append(f"--{k}")
            elif v is not False:
                argv += [f"--{k}", str(v)]
        argv += ["--device", self.device.type]
        if self.device.type == "cpu":
            argv.append("--use_kernel")
        return config_parser().parse_args(argv)


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def run(workload: str, seed: int, seconds: float, trace: bool, device,
        t_start: float, cell: Optional[Cell] = None) -> dict:
    """Run the cell on ``device`` (any: the caller has looked for the
    chip) and return the result line's object."""
    cell = cell or Cell(workload)
    ctx = Ctx(cell, seed, seconds, trace, device, t_start)
    out = driver(cell.traffic["driver"]).run(ctx)
    metrics = {}
    if trace:
        for m in cell.per_layer():
            v = reader(m["name"])(out["obs"])
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in cell.end_to_end():
            if m["name"] in out["e2e"]:
                metrics[m["name"]] = {"value": out["e2e"][m["name"]],
                                      "unit": m["unit"]}
    checks = {k: {"value": out["checks"].get(k, math.nan), "limit": lim}
              for k, lim in cell.limits.items()}
    correct = (out["failed"] == 0 and all(
        math.isfinite(c["value"]) and c["value"] <= c["limit"]
        for c in checks.values()))
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": out["device_kind"], "count": cell.chips,
           "memory_peak_bytes": out["memory_peak_bytes"]}
    res = {"correct": bool(correct), "attempted": out["attempted"],
           "failed": out["failed"], "metrics": metrics, "device": dev}
    summary = out.get("trace")
    if trace and summary is not None:
        dev["busy_s"] = summary["busy_s"]
        dev["window_s"] = summary["window_s"]
        res["breakdown"] = summary["breakdown"]
    res["checks"] = checks
    return res


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv=None, t_start: Optional[float] = None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    cell = Cell(args.workload)

    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        log(f"no result: {cell.chips} CUDA card(s) needed, "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
            " found")
        return 3
    device = torch.device("cuda", 0)
    res = run(args.workload, args.seed, args.seconds, bool(args.trace),
              device, t_start, cell)
    bad = forbidden_modules()
    if bad:
        log(f"no result: the run's process loaded {bad}")
        return 4
    for k, c in res["checks"].items():
        log(f"check {k} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(res), flush=True)
    return 0
