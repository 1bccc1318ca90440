"""Cells of ``BENCHMARK.json`` cut to a size a CPU test can hold: the
widths, samples, rays, chunk, grid and scene made tiny, the rest as the
cell has it."""
from __future__ import annotations

from portbench.lib import harness

TINY_FLAGS = {"netwidth": 32, "netwidth_fine": 32, "N_samples": 8,
              "N_importance": 8, "N_rand": 64, "chunk": 256}
TINY_OCC = {"occ_res": 16, "occ_candidates": 16}
TINY_SCENE = {"n_views": 4, "size": 16}
TINY_TRAFFIC = {"steps_per_dispatch": 4, "warm_windows": 1,
                "pixels_per_request": 16}


def tiny_cell(name: str) -> harness.Cell:
    cell = harness.Cell(name)
    flags = cell.config["flags"]
    flags.update(TINY_FLAGS)
    if flags.get("occ_grid"):
        flags.update(TINY_OCC)
    cell.config["scene"].update(TINY_SCENE)
    for k, v in TINY_TRAFFIC.items():
        if k in cell.traffic:
            cell.traffic[k] = v
    return cell


def run_tiny(name: str, seed: int = 7, seconds: float = 0.5,
             trace: bool = False, cell=None) -> dict:
    import time

    import torch

    cell = cell or tiny_cell(name)
    return harness.run(name, seed, seconds, trace, torch.device("cpu"),
                       time.perf_counter(), cell)
