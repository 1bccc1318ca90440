"""The plain reference against the program's plain path on the CPU, at
tiny sizes: the first window's checked train steps of each configuration
and a window of served requests, through the harness itself (the chip
check skipped)."""
import pytest
import torch

from portbench.tests.tiny import run_tiny

# float32 round-off of the kernels' plain versions against the
# reference; bfloat16's where the configuration states it
AGREE = {"linear_train": {"loss_gap": 1e-5, "grad_gap": 1e-3,
                          "change_gap": 1e-3, "rgb1_rms": 1e-6,
                          "replay_loss_gap": 1e-5, "replay_change_med": 1e-4},
         "occ_train": {"loss_gap": 1e-3, "grad_med": 0.1,
                       "change_med": 0.1, "rgb1_rms": 1e-3,
                       "replay_loss_gap": 1e-3, "replay_change_med": 0.1},
         "linear_render": {"rgb_rms": 1e-5},
         "occ_render": {"rgb_rms": 1e-3}}


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("workload", sorted(AGREE))
def test_reference_agrees_with_the_plain_path(workload):
    res = run_tiny(workload, seed=2 ** 40 + 3, seconds=0.3)
    assert res["failed"] == 0 and res["attempted"] > 0
    for k, lim in AGREE[workload].items():
        assert res["checks"][k]["value"] <= lim, (k, res["checks"][k])
    names = set(res["metrics"])
    assert "setup_s" in names
    assert names & {"train_rays_per_s", "render_rays_per_s"}
    assert list(res)[-1] == "checks"


def test_same_seed_same_inputs():
    from portbench.lib import scene as S
    from portbench.tests.tiny import tiny_cell

    flags = tiny_cell("occ_train").config["flags"]
    a = S.make_weights(flags, 2 ** 62 + 5, "cpu")
    b = S.make_weights(flags, 2 ** 62 + 5, "cpu")
    c = S.make_weights(flags, 2 ** 62 + 6, "cpu")
    k = "pts_linears.0.weight"
    assert torch.equal(a["fine"][k], b["fine"][k])
    assert not torch.equal(a["fine"][k], c["fine"][k])
    assert not torch.equal(a["fine"][k], a["coarse"][k])
