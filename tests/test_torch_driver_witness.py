"""The port's driver trains as the JAX driver does: both start from one
init and train on the numpy sphere scene (the scene ``chip_smoke.py``'s
driver phase writes, here at 64x64), and on the forward-facing LLFF
fixture with NDC rays, in pool mode with perturb off, so the two runs see
the same rays in the same order and differ only by floating-point
rounding.  Their losses along the run and their held-out
``--eval_det`` metrics, fine and coarse, are held against each other;
with the occupancy grid, its sidecars too.

Tolerances: losses 1e-2 relative; held-out PSNR, fine and coarse, within
0.5 dB, SSIM within 0.02, MSE 10% relative.  Rounding sets them: the two
runs' losses start 2e-7 apart at step 1 and their gap doubles about every
two steps (importance sampling moves with the coarse weights), to ~4e-3
at step 60, where the fine PSNRs lie ~0.2 dB apart.  A pass that renders
something else misses by several dB.  The grids: ``occ`` equal in all
but 1% of the voxels and the occupied shares within 0.01 (a voxel whose
density EMA sits near the threshold flips with the rounding of the
densities it observed); the density EMA, relative to 1e-3 + |density|,
within 1e-2 at the median voxel and 5e-2 at the 90th percentile (it
holds the MLP's densities, which part like the losses: 0.4% and 3.1%
here, 17% at the 99th); ``occ_ray_frac`` 1e-3.

LPIPS: both drivers' ``--task test`` score it from one seeded weights
file, and the port's test of the JAX driver's own checkpoint (read by
``--ft_path``) gives the JAX driver's LPIPS to 1e-4 relative: the same
weights render the same pixels to ~1e-6 there."""
import json
import os

import jax
import numpy as np
import pytest
import torch

from plnerf.cli import config as jconfig
from plnerf.cli import run_plnerf as jrun
from plnerf.train import step as jstep
from plnerf_torch.checkpoint import convert_jax
from plnerf_torch.checkpoint import io as ckio
from plnerf_torch.cli import run_plnerf
from plnerf_torch.data.synthetic import write_sphere_scene

from test_torch_lpips import write_npz

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


def _train_and_test_both(flags, data_dir, scene, ckpt_dir, steps, test):
    """Train the JAX driver, then the port's from the same init, for
    ``steps`` steps; test both with ``--eval_det``.  Returns (port, JAX)
    losses by step and held-out metrics of the ``test`` result folder."""
    common = flags + ["--data_dir", data_dir, "--scene_id", scene,
                      "--ckpt_dir", ckpt_dir]
    train = common + ["--task", "train", "--num_iterations", str(steps)]
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
    assert state.step == steps

    test = test + ["--task", "test", "--ckpt_dir", ckpt_dir, "--data_dir",
                   data_dir, "--scene_id", scene, "--eval_det"]
    jrun.main(test + ["--expname", "jax", "--no_mesh"])
    run_plnerf.main(test + cpu)
    losses, metrics = [], []
    for who in ("port", "jax"):
        exp = os.path.join(ckpt_dir, who)
        losses.append(_losses(exp))
        sub, = [d for d in os.listdir(exp) if d.startswith("test_images_")]
        metrics.append(_metrics_txt(os.path.join(exp, sub, "metrics.txt")))
    return losses, metrics


def _hold(losses, metrics, steps):
    (got_l, ref_l), (got, ref) = losses, metrics
    assert list(got_l) == list(ref_l) == steps
    for k in ref_l:
        assert got_l[k] == pytest.approx(ref_l[k], rel=1e-2), k
    assert ref_l[steps[-1]] < ref_l[steps[0]]
    assert set(got) == set(ref) == {"img_loss", "psnr", "ssim", "img_loss0",
                                    "psnr0"}
    for k, tol in (("psnr", 0.5), ("psnr0", 0.5), ("ssim", 0.02)):
        assert abs(got[k] - ref[k]) <= tol, (k, got, ref)
    for k in ("img_loss", "img_loss0"):
        assert got[k] == pytest.approx(ref[k], rel=0.1), (k, got, ref)


def _lpips_row(exp):
    sub, = [d for d in os.listdir(exp) if d.startswith("test_images_")]
    rows = dict(line.rstrip("\n").split(": ", 1)
                for line in open(os.path.join(exp, sub, "metrics.txt")))
    return float(rows["lpips"])


def test_driver_trains_like_jax(tmp_path):
    data_dir = str(tmp_path / "data")
    write_sphere_scene(os.path.join(data_dir, "sphere"), 64,
                                  {"train": 8, "val": 1, "test": 2})
    weights = str(tmp_path / "lpips.npz")
    write_npz(weights)
    ckpt = str(tmp_path / "ckpt")
    test = ["--white_bkgd", "--lpips_weights", weights]
    losses, metrics = _train_and_test_both(FLAGS, data_dir, "sphere", ckpt,
                                           STEPS, test)
    _hold(losses, metrics, [20, 40, 60])

    # the port's test of the JAX driver's checkpoint: the JAX LPIPS
    jax_lpips = _lpips_row(os.path.join(ckpt, "jax"))
    run_plnerf.main(test + [
        "--task", "test", "--ckpt_dir", ckpt, "--data_dir", data_dir,
        "--scene_id", "sphere", "--eval_det", "--device", "cpu",
        "--expname", "port", "--ft_path",
        os.path.join(ckpt, "jax", f"{STEPS:06d}.ckpt")])
    assert _lpips_row(os.path.join(ckpt, "port")) == pytest.approx(
        jax_lpips, rel=1e-4)
    assert jax_lpips > 0


def test_llff_driver_trains_like_jax(tmp_path):
    """The LLFF path: the forward-facing fixture (6 views at 48x64,
    llffhold 3), NDC rays from the 12-column pool, 40 steps of the
    llff_linear recipe at tiny widths with its density noise off.  The 4
    training views' 12,288 rays outlast the run's 10,240: a reshuffle
    draws from each package's own generator.  Same tolerances; the losses
    agree to 1e-6 at step 5 and within 0.5% at 40 here."""
    from plnerf_torch.data.synthetic import make_llff_fixture

    data_dir = str(tmp_path / "data")
    make_llff_fixture(os.path.join(data_dir, "ff"), n=6, H=48, W=64)
    flags = [
        "--config", os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "configs", "llff_linear.txt"),
        "--factor", "1", "--llffhold", "3", "--raw_noise_std", "0",
        "--constant_init", "10", "--N_rand", "256", "--N_samples", "16",
        "--N_importance", "16", "--netdepth", "4", "--netwidth", "32",
        "--multires", "6", "--multires_views", "2", "--chunk", "1200",
        "--lrate", "5e-3", "--lrate_decay", "500", "--perturb", "0",
        "--i_print", "20", "--i_weights", "40", "--i_img", "1000000",
        "--i_testset", "1000000", "--i_video", "1000000", "--no_mesh",
        "--seed", "0"]
    losses, metrics = _train_and_test_both(
        flags, data_dir, "ff", str(tmp_path / "ckpt"), 40,
        ["--dataset", "llff"])
    _hold(losses, metrics, [20, 40])


def _grid(path):
    """A sidecar grid of either package as numpy arrays."""
    if path.endswith("occ") and open(path, "rb").read(2) == b"PK":
        return {k: v.numpy() for k, v in torch.load(
            path, weights_only=True).items()}
    import flax.serialization as fser

    with open(path, "rb") as f:
        return {k: np.asarray(v) for k, v in fser.msgpack_restore(
            f.read()).items()}


def test_occ_driver_trains_like_jax(tmp_path):
    """The occupancy-grid path on the sphere: the grid warms up for 20
    steps, then guides 16 coarse samples for 20 (a 32^3 grid, 32
    candidate bins), pool mode, perturb off; both drivers' losses and
    ``occ_ray_frac``, their held-out metrics with each one's own step-40
    grid, and the two grids.  The guided steps part the runs faster than
    uniform ones: past step 40 single losses lie up to 3% apart here while
    ``occ_ray_frac`` still agrees to every digit, so the run stops at
    40 (losses 0.4% apart)."""
    data_dir = str(tmp_path / "data")
    write_sphere_scene(os.path.join(data_dir, "sphere"), 64,
                                  {"train": 8, "val": 1, "test": 2})
    ckpt = str(tmp_path / "ckpt")
    steps = 40
    occ = ["--occ_grid", "--occ_warmup", "20", "--occ_res", "32",
           "--occ_candidates", "32", "--occ_bound", "1.5", "--i_weights",
           str(steps)]
    losses, metrics = _train_and_test_both(
        FLAGS + occ, data_dir, "sphere", ckpt, steps, ["--white_bkgd"])
    _hold(losses, metrics, [20, 40])
    fracs = []
    for who in ("port", "jax"):
        with open(os.path.join(ckpt, who, "metrics.jsonl")) as f:
            fracs.append({r["step"]: r["train/occ_ray_frac"]
                          for r in map(json.loads, f)
                          if "train/occ_ray_frac" in r})
    assert list(fracs[0]) == list(fracs[1]) == [40]
    assert fracs[0][40] == pytest.approx(fracs[1][40], abs=1e-3)
    got, ref = (_grid(os.path.join(ckpt, who, f"{steps:06d}.occ"))
                for who in ("port", "jax"))
    assert set(got) == set(ref)
    for k in ("aabb_min", "aabb_max"):
        np.testing.assert_array_equal(got[k], ref[k])
    assert (got["occ"] != ref["occ"]).mean() <= 0.01
    assert abs(got["occ"].mean() - ref["occ"].mean()) <= 0.01
    # the guided steps moved the density EMA, alike in both
    assert (ref["density"] != np.float32(0.1)).mean() > 0.1
    rel = np.abs(got["density"] - ref["density"]) / (
        1e-3 + np.abs(ref["density"]))
    assert np.median(rel) <= 1e-2 and np.quantile(rel, 0.9) <= 5e-2
