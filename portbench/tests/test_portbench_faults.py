"""A run with the timed path broken underneath comes out not correct:
the harness's look for a chip skipped, the rest of a run driven at a tiny
size on the CPU, once for each fault a cell can have: a step that leaves
the state unchanged; half the batch left out with the mean over the
rest; the optimizer steps of the second window (on the card the graph's
first replay) left out; a served answer altered where it is produced.  One card, so no
exchange between chips to leave out."""
import contextlib

import pytest
import torch

from portbench.tests.tiny import run_tiny


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@contextlib.contextmanager
def state_unchanged():
    from plnerf_torch.train import step

    saved = step._update
    step._update = lambda state, opts, inputs: None
    try:
        yield
    finally:
        step._update = saved


@contextlib.contextmanager
def half_batch():
    from plnerf_torch.train import step

    saved = step.MultiTrainStep.window

    def window(self, state, n, batch_of, *a, **kw):
        def half(k):
            b = batch_of(k)
            m = b["rays"].shape[0] // 2
            return {k2: v[:m] for k2, v in b.items()}
        return saved(self, state, n, half, *a, **kw)
    step.MultiTrainStep.window = window
    try:
        yield
    finally:
        step.MultiTrainStep.window = saved


@contextlib.contextmanager
def replay_unchanged():
    # the second window (on the card the graph's first replay) leaves the
    # state unchanged, as a capture without the optimizer steps would
    from plnerf_torch.train import step
    from portbench.drivers import train

    saved_update, saved_step, calls = step._update, train.Loop.step, []

    def loop_step(self):
        calls.append(1)
        if len(calls) == 2:
            step._update = lambda state, opts, inputs: None
        try:
            return saved_step(self)
        finally:
            step._update = saved_update
    train.Loop.step = loop_step
    try:
        yield
    finally:
        train.Loop.step = saved_step


@contextlib.contextmanager
def answer_altered():
    # the serving runtime calls render_chunks by its module's name
    from plnerf_torch.serving import runtime

    saved = runtime.render_chunks

    def altered(*a, **kw):
        out = saved(*a, **kw)
        out["rgb_map"] = out["rgb_map"] + 0.1
        return out
    runtime.render_chunks = altered
    try:
        yield
    finally:
        runtime.render_chunks = saved


def test_a_sound_tiny_run_is_correct_under_the_cell_limits_for_faults():
    # the fault cases below mean something only if the unbroken path
    # reads within the cell's own limits at this size
    res = run_tiny("linear_train", seed=9)
    assert res["correct"], res["checks"]


@pytest.mark.parametrize("workload", ["linear_train", "occ_train"])
@pytest.mark.parametrize("fault", [state_unchanged, half_batch,
                                   replay_unchanged])
def test_train_fault_is_not_correct(workload, fault):
    with fault():
        res = run_tiny(workload, seed=9)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("workload", ["occ_render", "linear_render"])
def test_render_fault_is_not_correct(workload):
    with answer_altered():
        res = run_tiny(workload, seed=9)
    assert not res["correct"], res["checks"]
