"""The port's driver trains as the JAX driver does: both start from one
init and train on the numpy sphere scene (the scene ``chip_smoke.py``'s
driver phase writes, here at 64x64) in pool mode with perturb off, so the
two runs see the same rays in the same order and differ only by
floating-point rounding.  Their losses along the run and their held-out
``--eval_det`` metrics, fine and coarse, are held against each other.

Tolerances: losses 1e-2 relative; held-out PSNR, fine and coarse, within
0.5 dB, SSIM within 0.02, MSE 10% relative.  Rounding sets them: the two
runs' losses start 2e-7 apart at step 1 and their gap doubles about every
two steps (importance sampling moves with the coarse weights), to ~4e-3
at step 60, where the fine PSNRs lie ~0.2 dB apart.  A pass that renders
something else misses by several dB."""
import json
import os

import jax
import numpy as np
import pytest
import torch

import chip_smoke
from plnerf.cli import config as jconfig
from plnerf.cli import run_plnerf as jrun
from plnerf.train import step as jstep
from plnerf_torch.checkpoint import convert_jax
from plnerf_torch.checkpoint import io as ckio
from plnerf_torch.cli import run_plnerf

torch.set_num_threads(1)

STEPS = 60
FLAGS = [
    "--dataset", "blender", "--use_viewdirs", "--white_bkgd",
    "--mode", "linear", "--color_mode", "midpoint", "--constant_init", "20",
    "--N_rand", "256", "--N_samples", "16", "--N_importance", "16",
    "--netdepth", "4", "--netwidth", "32", "--multires", "6",
    "--multires_views", "2", "--chunk", "1024", "--lrate", "5e-3",
    "--lrate_decay", "500", "--perturb", "0", "--i_print", "20",
    "--i_weights", str(STEPS), "--i_img", "1000000",
    "--i_testset", "1000000", "--i_video", "1000000", "--testskip", "1",
    "--no_mesh", "--seed", "0",
]


def _metrics_txt(path):
    out = {}
    for line in open(path):
        k, v = line.split(": ", 1)
        if k != "lpips":
            out[k] = float(v)
    return out


def _losses(exp):
    with open(os.path.join(exp, "metrics.jsonl")) as f:
        return {r["step"]: r["train/loss"] for r in map(json.loads, f)
                if "train/loss" in r}


def test_driver_trains_like_jax(tmp_path):
    data_dir = str(tmp_path / "data")
    chip_smoke.write_sphere_scene(os.path.join(data_dir, "sphere"), 64,
                                  {"train": 8, "val": 1, "test": 2})
    ckpt_dir = str(tmp_path / "ckpt")
    common = FLAGS + ["--data_dir", data_dir, "--scene_id", "sphere",
                      "--ckpt_dir", ckpt_dir]
    train = common + ["--task", "train", "--num_iterations", str(STEPS)]
    jrun.main(train + ["--expname", "jax"])

    # the port starts from the JAX driver's init (PRNGKey(--seed))
    jargs = jconfig.config_parser().parse_args(common + ["--expname", "jax"])
    _, _, jsetup = jrun.build_configs(jargs)
    jinit = jstep.init_state(jax.random.PRNGKey(0), jsetup)
    cpu = ["--device", "cpu", "--expname", "port"]
    state = run_plnerf.main(common + cpu + ["--task", "train",
                                            "--num_iterations", "0"])
    for module, params in ((state.params_coarse, jinit.params_coarse),
                           (state.params_fine, jinit.params_fine)):
        convert_jax.load_jax_params(module, jax.tree.map(np.array, params))
    ckio.save_checkpoint(os.path.join(ckpt_dir, "port"), 0,
                         state.state_dict())
    state = run_plnerf.main(train + cpu)
    assert state.step == STEPS

    got = _losses(os.path.join(ckpt_dir, "port"))
    ref = _losses(os.path.join(ckpt_dir, "jax"))
    assert list(got) == list(ref) == [20, 40, 60]
    for k in ref:
        assert got[k] == pytest.approx(ref[k], rel=1e-2), k
    assert ref[60] < ref[20]

    test = ["--task", "test", "--ckpt_dir", ckpt_dir, "--data_dir", data_dir,
            "--scene_id", "sphere", "--white_bkgd", "--eval_det"]
    jrun.main(test + ["--expname", "jax", "--no_mesh"])
    run_plnerf.main(test + cpu)
    sub = "test_images_linear_16_16sphere"
    got = _metrics_txt(os.path.join(ckpt_dir, "port", sub, "metrics.txt"))
    ref = _metrics_txt(os.path.join(ckpt_dir, "jax", sub, "metrics.txt"))
    assert set(got) == set(ref) == {"img_loss", "psnr", "ssim", "img_loss0",
                                    "psnr0"}
    for k, tol in (("psnr", 0.5), ("psnr0", 0.5), ("ssim", 0.02)):
        assert abs(got[k] - ref[k]) <= tol, (k, got, ref)
    for k in ("img_loss", "img_loss0"):
        assert got[k] == pytest.approx(ref[k], rel=0.1), (k, got, ref)
