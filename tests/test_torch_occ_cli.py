"""The occupancy grid through the port's two drivers on the CPU at tiny
size, after the JAX package's driver tests (tests/test_cli.py): the occ
recipe (``configs/blender_linear_occ.txt``) trains, resumes and tests;
the grid is saved as a ``{step:06d}.occ`` sidecar beside each checkpoint;
a restored grid engages at once while a fresh one warms up; an eval task
without its sidecar is refused unless ``--occ_eval_fresh_grid``; the
degenerate-guidance advisory drops the grid (or keeps it with
``--occ_keep_degenerate``); pool mode; the depth driver with
``--occ_grid``; and ``profile_step --occ``."""
import json
import os

import numpy as np
import pytest
import torch

from plnerf_torch.checkpoint import io as ckio
from plnerf_torch.cli import run_depth, run_plnerf
from plnerf_torch.tools import profile_step

from fixtures import make_blender2_scene, make_blender_scene
from test_torch_cli import CPU, REPO, TINY
from test_torch_depth_cli import FLAGS as DEPTH_FLAGS

torch.set_num_threads(1)

OCC_CONFIG = os.path.join(REPO, "configs", "blender_linear_occ.txt")
# the occ recipe cut to tiny size: its flags after the config's
OCC_TINY = TINY + ["--precrop_iters", "3", "--constant_init", "2",
                   "--mlp_dtype", "float32", "--occ_warmup", "6",
                   "--occ_res", "16", "--occ_candidates", "16",
                   "--i_print", "2"]


@pytest.fixture(scope="module")
def scene_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("data") / "tinyscene"
    make_blender_scene(str(d), n_train=3, n_val=1, n_test=1)
    return str(d.parent), "tinyscene"


@pytest.fixture(scope="module")
def depth_scene(tmp_path_factory):
    d = tmp_path_factory.mktemp("ddata") / "depthscene"
    make_blender2_scene(str(d), n_train=3, n_test=2, with_depth=True)
    return str(d.parent), "depthscene"


def _log(exp):
    with open(os.path.join(exp, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _guided_steps(exp):
    return [r["step"] for r in _log(exp) if "train/occ_ray_frac" in r]


def _where(scene_dir, ckpt, name):
    data_dir, scene_id = scene_dir
    return ["--data_dir", data_dir, "--scene_id", scene_id, "--ckpt_dir",
            ckpt, "--expname", name]


def test_occ_config_trains_resumes_and_tests(scene_dir, tmp_path):
    """The occ recipe: 10 steps (warm-up to 6, guided after), a resume to
    14 that restores the step-10 grid and guides from its first step, then
    ``--task test`` with the step-14 grid."""
    ckpt = str(tmp_path / "ck")
    where = _where(scene_dir, ckpt, "occ")
    train = (["--config", OCC_CONFIG, "--task", "train"] + OCC_TINY + CPU
             + where + ["--i_weights", "10"])
    state = run_plnerf.main(train + ["--num_iterations", "10"])
    exp = os.path.join(ckpt, "occ")
    assert state.step == 10
    assert {"000010.ckpt", "000010.occ"} <= set(os.listdir(exp))
    assert _guided_steps(exp) == [8, 10]           # warm-up: 1..6
    grid10 = torch.load(os.path.join(exp, "000010.occ"), weights_only=True)
    assert set(grid10) == {"density", "occ", "aabb_min", "aabb_max"}
    assert grid10["occ"].shape == (16, 16, 16)
    assert float(grid10["aabb_max"][0]) == 1.5     # the config's bound
    # the guided steps updated it
    assert (grid10["density"] != np.float32(0.1)).any()

    run_plnerf.main(train + ["--num_iterations", "14"])
    assert _guided_steps(exp) == [8, 10, 12, 14]   # no second warm-up
    names = sorted(f for f in os.listdir(exp) if f[0].isdigit())
    assert names == ["000010.ckpt", "000010.occ", "000014.ckpt",
                     "000014.occ"]
    assert ckio.aux_path(os.path.join(exp, "000014.ckpt"), "occ") == \
        os.path.join(exp, "000014.occ")

    mm = run_plnerf.main(["--task", "test", "--white_bkgd"] + CPU + where)
    assert np.isfinite(mm.get("psnr"))
    assert os.path.exists(os.path.join(
        exp, f"test_images_linear_8_8{scene_dir[1]}", "metrics.txt"))


def test_fresh_grid_warms_up_again_on_resume_without_sidecar(scene_dir,
                                                             tmp_path):
    ckpt = str(tmp_path / "ck")
    where = _where(scene_dir, ckpt, "w")
    train = (["--config", OCC_CONFIG, "--task", "train"] + OCC_TINY + CPU
             + where + ["--i_weights", "8"])
    run_plnerf.main(train + ["--num_iterations", "8"])
    exp = os.path.join(ckpt, "w")
    os.remove(os.path.join(exp, "000008.occ"))
    run_plnerf.main(train + ["--num_iterations", "16"])
    # warm-up again for 6 steps from 8: guided from 15
    assert [s for s in _guided_steps(exp) if s > 8] == [16]


def test_eval_without_sidecar_is_refused(scene_dir, tmp_path):
    ckpt = str(tmp_path / "ck")
    where = _where(scene_dir, ckpt, "e")
    run_plnerf.main(["--config", OCC_CONFIG, "--task", "train"] + OCC_TINY
                    + CPU + where + ["--num_iterations", "8",
                                     "--i_weights", "8"])
    exp = os.path.join(ckpt, "e")
    os.remove(os.path.join(exp, "000008.occ"))
    test = ["--task", "test", "--white_bkgd"] + CPU + where
    with pytest.raises(FileNotFoundError, match="occ_eval_fresh_grid"):
        run_plnerf.main(test)
    with pytest.raises(FileNotFoundError):
        run_plnerf.main(["--task", "test_samples_error"] + CPU + where)
    mm = run_plnerf.main(test + ["--occ_eval_fresh_grid"])
    assert np.isfinite(mm.get("psnr"))
    # the fresh init has no checkpoint, hence no sidecar to miss
    run_plnerf.main(test + ["--no_reload"])


@pytest.mark.parametrize("keep", [False, True])
def test_degenerate_guidance_falls_back(scene_dir, tmp_path, capsys,
                                        monkeypatch, keep):
    """The guard armed from the first guided step and its threshold at 0
    (the plumbing, not the 0.35 calibration): it prints, logs
    ``occ_auto_fallback`` and drops the grid (uniform steps, no sidecar)
    unless ``--occ_keep_degenerate``."""
    monkeypatch.setattr(run_plnerf, "OCC_ADVISORY_GRACE", 0)
    monkeypatch.setattr(run_plnerf, "OCC_DEGENERATE_RAY_FRAC", 0.0)
    ckpt = str(tmp_path / "ck")
    where = _where(scene_dir, ckpt, "d")
    extra = ["--occ_keep_degenerate"] if keep else []
    run_plnerf.main(["--config", OCC_CONFIG, "--task", "train"] + OCC_TINY
                    + CPU + where + extra + ["--num_iterations", "12",
                                             "--i_weights", "12"])
    out = capsys.readouterr().out
    exp = os.path.join(ckpt, "d")
    assert "DEGENERATE" in out and ("AUTO-FALLBACK" in out) != keep
    fired = [r for r in _log(exp) if "train/occ_auto_fallback" in r]
    assert [r["step"] for r in fired] == [7]
    assert fired[0]["train/occ_auto_fallback"] == float(not keep)
    assert os.path.exists(os.path.join(exp, "000012.occ")) == keep
    assert _guided_steps(exp) == ([7, 8, 10, 12] if keep else [7])


def test_pool_mode_occ_grid(scene_dir, tmp_path):
    """Grid-guided slices of the shuffled ray pool (the occ flags without
    the config, whose ``no_batching`` a command line cannot unset), the
    warm-up boundary inside the run, the sidecar saved."""
    ckpt = str(tmp_path / "ck")
    where = _where(scene_dir, ckpt, "po")
    args = [a for a in OCC_TINY if a != "--no_batching"]
    run_plnerf.main(["--task", "train", "--mode", "linear", "--occ_grid"]
                    + args + CPU + where
                    + ["--num_iterations", "14", "--i_weights", "14"])
    exp = os.path.join(ckpt, "po")
    assert os.path.exists(os.path.join(exp, "000014.occ"))
    assert _guided_steps(exp) == [8, 10, 12, 14]
    assert all(np.isfinite(r["train/loss"]) for r in _log(exp)
               if "train/loss" in r)


def test_depth_driver_occ_grid(depth_scene, tmp_path):
    """``run_depth --occ_grid``: warm-up, guided steps with the space
    carving on, the sidecar, a resume that engages at once, then
    ``test`` and ``test_samples_error`` with the grid; without the
    sidecar ``test`` is refused."""
    data_dir, scene_id = depth_scene
    ckpt = str(tmp_path / "ck")
    where = ["--data_dir", data_dir, "--scene_id", scene_id, "--ckpt_dir",
             ckpt, "--expname", "dg"]
    occ = ["--occ_grid", "--occ_warmup", "4", "--occ_res", "16",
           "--occ_candidates", "16", "--i_print", "2", "--i_weights", "8"]
    train = ["train"] + DEPTH_FLAGS + CPU + where + occ
    run_depth.main(train + ["--num_iterations", "8"])
    exp = os.path.join(ckpt, "dg")
    assert os.path.exists(os.path.join(exp, "000008.occ"))
    assert _guided_steps(exp) == [6, 8]
    run_depth.main(train + ["--num_iterations", "12"])
    assert _guided_steps(exp) == [6, 8, 10, 12]
    recs = [r for r in _log(exp) if "train/space_carving_loss" in r]
    assert all(np.isfinite(r["train/loss"]) for r in recs)
    mm = run_depth.main(["test"] + DEPTH_FLAGS + CPU + where)
    assert np.isfinite(mm.get("depth_rmse"))
    err = run_depth.main(["test_samples_error"] + DEPTH_FLAGS + CPU + where)
    assert np.isfinite(err.get("importance_sampling_error"))
    os.remove(os.path.join(exp, "000012.occ"))
    with pytest.raises(FileNotFoundError):
        run_depth.main(["test"] + DEPTH_FLAGS + CPU + where)


def test_profile_step_occ_cli():
    res = profile_step.main(["--occ", "--device", "cpu", "--rays", "16",
                             "--steps", "1", "--mlp_dtype", "float32",
                             "--top", "3"])
    assert np.isfinite(res["loss"]) and 0.0 < res["occ_ray_frac"] <= 1.0
