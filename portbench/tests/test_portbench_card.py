"""On the card only: the control, the reference put in the program's
place and computed in the next precision below the configuration's
(TF32 for float32, float8 e4m3 for bfloat16), comes out not correct
under each cell's limits, at the cell's own size.  Skips without a CUDA
card (decided in a fixture).

    python3 -m pytest -q portbench/tests/test_portbench_card.py
"""
import json
import os
import time

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# requests a serving run compares, about as many as a run answers
REQUESTS = {"occ_render": 48, "linear_render": 5}


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control runs at the cell's size")
    return torch.device("cuda", 0)


def limits(workload):
    with open(os.path.join(BENCH, "limits", workload + ".json")) as f:
        return json.load(f)


@pytest.mark.parametrize("workload", ["linear_train", "occ_train",
                                      "occ_render", "linear_render"])
def test_control_is_not_correct(card, workload):
    from portbench.lib import harness
    from portbench.tools import calibrate

    cell = harness.Cell(workload)
    ctx = harness.Ctx(cell, 2 ** 33 + 1, 1.0, False, card,
                      time.perf_counter())
    ctx.traffic_requests = REQUESTS.get(workload, 0)
    if cell.traffic["driver"] == "train":
        r = calibrate.train_reading(ctx, "control")
    else:
        r = calibrate.render_reading(ctx, "control")
    over = {k: r[k] for k, lim in limits(workload).items() if r[k] > lim}
    assert over, (r, limits(workload))
