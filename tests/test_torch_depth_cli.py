"""The port's depth driver (``plnerf_torch.cli.run_depth``) against the JAX
package's (``plnerf.cli.run_depth``) on the CPU, on the fixture's
blender2_depth scene: the flag surface and ``build_configs``, the refusals
and the device rule, and a driver witness.  The witness trains both
drivers from one init, each step on every fourth pixel of the image the
shared ``default_rng(seed).choice`` picks (the pixel draw replaced in
both) with perturb off, so the two runs see the same rays and differ only by
rounding; then ``test``, ``test_samples_error`` and (a model with camera
channels) ``test_opt`` with ``--eval_det`` on both (its 100 epochs per
view cut to 10 in both).  Result folders,
metric files and their rows must match; losses within 1e-2 relative,
held-out PSNR within 0.5 dB, SSIM 0.02, depth RMSE and the
importance-sampling error 5% relative."""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from plnerf.cli import run_depth as jrun
from plnerf.train import batching as jbatching
from plnerf.train import step as jstep
from plnerf_torch.checkpoint import convert_jax
from plnerf_torch.checkpoint import io as ckio
from plnerf_torch.cli import run_depth
from plnerf_torch.train import batching

from fixtures import H, W, make_blender2_scene

torch.set_num_threads(1)

STEPS = 20
# the depth recipe (linear, space carving 0.007, white background, near
# 2) at tiny widths; every fourth pixel of a 32x32 view per step
N_RAND = H * W // 4
FLAGS = [
    "--dataset", "blender2_depth", "--mode", "linear", "--N_rand",
    str(N_RAND), "--N_samples", "8", "--N_importance", "8", "--netdepth",
    "2", "--netwidth", "32", "--multires", "4", "--chunk", "512",
    "--lrate", "5e-3", "--i_print", "10", "--set_near_plane", "2.0",
    "--space_carving_weight", "0.007", "--warm_start_nerf", "5",
    "--freeze_ss", "10", "--scaleshift_lr", "1e-3", "--white_bkgd",
    "--perturb", "0", "--random_seed", "0",
]
CPU = ["--device", "cpu"]


@pytest.fixture(scope="module")
def scene_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("ddata") / "depthscene"
    make_blender2_scene(str(d), n_train=3, n_test=2, with_depth=True)
    return str(d.parent), "depthscene"


@pytest.fixture
def every_pixel(monkeypatch):
    """Both drivers' pixel draw replaced by every fourth pixel in row
    order."""
    def jselect(key, h, w, n_rand, precrop, frac):
        i = jnp.arange(0, h * w, 4)
        return i // w, i % w

    def tselect(generator, h, w, n_rand, precrop, frac, device=None):
        i = torch.arange(0, h * w, 4, device=device)
        return i // w, i % w

    monkeypatch.setattr(jbatching, "select_pixels", jselect)
    monkeypatch.setattr(batching, "select_pixels", tselect)


def test_flags_parse_like_jax():
    """Every flag of the JAX driver parses to the same value (the port
    has ``--use_kernel`` / ``--device`` for ``--use_pallas``)."""
    argv = ["test_opt"] + FLAGS + ["--input_ch_cam", "3", "--opt_ch_cam",
                                   "--is_joint", "true"]
    got = vars(run_depth.config_parser().parse_args(argv))
    ref = vars(jrun.config_parser().parse_args(argv))
    assert ref.pop("use_pallas") is False
    assert got.pop("use_kernel") is None and got.pop("device") is None
    assert got == ref


@pytest.mark.parametrize("extra", [[], ["--input_ch_cam", "4",
                                        "--opt_ch_cam", "--N_importance",
                                        "0", "--netwidth_fine", "64"]])
def test_build_configs_matches_jax(extra):
    argv = ["train"] + FLAGS + extra
    jm, jr, js = jrun.build_configs(jrun.config_parser().parse_args(argv))
    tm, tr, ts = run_depth.build_configs(
        run_depth.config_parser().parse_args(argv + CPU))
    assert dataclasses.asdict(tm) == dataclasses.asdict(jm)
    jd, td = dataclasses.asdict(jr), dataclasses.asdict(tr)
    jd["use_fused_mlp"] = jd.pop("use_pallas_mlp")
    jd["fused_fold_heads"] = jd.pop("pallas_fold_heads")
    assert td == jd
    for f in dataclasses.fields(ts):
        got, ref = getattr(ts, f.name), getattr(js, f.name)
        if f.name == "rcfg":
            continue
        if dataclasses.is_dataclass(got):
            got, ref = dataclasses.asdict(got), dataclasses.asdict(ref)
        assert got == ref, f.name
    assert ts.joint_optimizer and ts.grad_clip_value == 0.1


def test_entry_point_needs_cuda_unless_cpu_is_asked(scene_dir, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    data_dir, scene_id = scene_dir
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_depth.main(["train"] + FLAGS + [
            "--data_dir", data_dir, "--scene_id", scene_id, "--ckpt_dir",
            str(tmp_path), "--expname", "e", "--num_iterations", "1"])
    assert not os.path.exists(tmp_path / "e")


@pytest.mark.parametrize("flags, item", [
    (["test", "--lpips_weights", "w.pt"], "ROADMAP A14"),
    (["train", "--steps_per_dispatch", "4"], "steps_per_dispatch 4")])
def test_unported_paths_are_refused(scene_dir, tmp_path, flags, item):
    data_dir, scene_id = scene_dir
    with pytest.raises(SystemExit, match=item):
        run_depth.main(flags + FLAGS + CPU + [
            "--data_dir", data_dir, "--scene_id", scene_id, "--ckpt_dir",
            str(tmp_path), "--expname", "e"])
    assert not os.path.exists(tmp_path / "e")


def _metrics_txt(path):
    """{key: value} of a metrics file (the lpips row is a note)."""
    out = {}
    for line in open(path):
        k, v = line.rstrip("\n").split(": ", 1)
        out[k] = v if k == "lpips" else float(v)
    return out


def _train_both(common, ckpt_dir, steps, n_images):
    """Train the JAX driver, then the port's from the JAX driver's init
    (its ``init_state(PRNGKey(seed), ..., n_images)``, carried into a
    step-0 checkpoint the port resumes from).  Returns the port state."""
    train = ["train"] + common + ["--num_iterations", str(steps)]
    jrun.main(train + ["--expname", "jax"])
    _, _, jsetup = jrun.build_configs(jrun.config_parser().parse_args(
        train + ["--expname", "jax"]))
    jinit = jstep.init_state(jax.random.PRNGKey(0), jsetup,
                             n_images=n_images)
    port = CPU + ["--expname", "port"]
    state = run_depth.main(["train"] + common + port
                           + ["--num_iterations", "0"])
    for module, params in ((state.params_coarse, jinit.params_coarse),
                           (state.params_fine, jinit.params_fine)):
        convert_jax.load_jax_params(module, jax.tree.map(np.array, params))
    ckio.save_checkpoint(os.path.join(ckpt_dir, "port"), 0,
                         state.state_dict())
    state = run_depth.main(train + port)
    assert state.step == steps
    return state


def _losses(exp):
    with open(os.path.join(exp, "metrics.jsonl")) as f:
        return {r["step"]: r for r in map(json.loads, f)
                if "train/loss" in r}


def _both(ckpt_dir, sub, name):
    return [_metrics_txt(os.path.join(ckpt_dir, who, sub, name))
            for who in ("port", "jax")]


def _hold_metrics(got, ref, keys):
    assert list(got) == list(ref), (got, ref)
    for k in keys:
        tol = {"psnr": 0.5, "psnr0": 0.5, "ssim": 0.02, "ssim0": 0.02}
        if k in tol:
            assert abs(got[k] - ref[k]) <= tol[k], (k, got, ref)
        else:
            assert got[k] == pytest.approx(ref[k], rel=0.05), (k, got, ref)


def test_depth_driver_trains_like_jax(scene_dir, tmp_path, every_pixel):
    """20 steps across the warm start (5) and the scale / shift freeze
    (10), then ``test`` and ``test_samples_error``."""
    data_dir, scene_id = scene_dir
    ckpt_dir = str(tmp_path / "ck")
    common = FLAGS + ["--data_dir", data_dir, "--scene_id", scene_id,
                      "--ckpt_dir", ckpt_dir, "--i_weights", str(STEPS)]
    _train_both(common, ckpt_dir, STEPS, 3 + 2 + 40)
    got, ref = (_losses(os.path.join(ckpt_dir, w)) for w in ("port", "jax"))
    assert list(got) == list(ref) == [10, 20]
    for step in ref:
        assert set(got[step]) == set(ref[step])
        for k in ("train/loss", "train/img_loss", "train/img_loss0",
                  "train/space_carving_loss", "train/depth_scale_mean",
                  "train/depth_shift_mean"):
            assert got[step][k] == pytest.approx(ref[step][k], rel=1e-2), k
    assert ref[20]["train/loss"] < ref[10]["train/loss"]

    for who, main in (("jax", jrun.main), ("port", run_depth.main)):
        extra = ["--expname", who, "--eval_det"] + (
            CPU if who == "port" else [])
        main(["test"] + common + extra)
        main(["test_samples_error"] + common + extra)
    for who in ("port", "jax"):
        assert sorted(d for d in os.listdir(os.path.join(ckpt_dir, who))
                      if d.startswith("test_")) == [
            "test_images_linear_8_8depthscene",
            "test_predicted_samples_error_8"]
    got, ref = _both(ckpt_dir, "test_images_linear_8_8depthscene",
                     "metrics.txt")
    assert list(ref) == ["img_loss", "psnr", "ssim", "img_loss0", "psnr0",
                         "depth_rmse", "lpips"]
    _hold_metrics(got, ref, ("psnr", "psnr0", "ssim", "depth_rmse"))
    got, ref = _both(ckpt_dir, "test_predicted_samples_error_8",
                     "metrics_depth_samples.txt")
    _hold_metrics(got, ref, ("importance_sampling_error",))


def test_depth_driver_test_opt_like_jax(scene_dir, tmp_path, every_pixel,
                                       monkeypatch):
    """A model with 2 camera channels (5 steps), then ``test_opt``: each
    held-out view's embedding fitted, the network frozen, for 10 epochs
    (the drivers' 100 cut in both; ``test_torch_depth`` holds the routine
    itself)."""
    import functools

    from plnerf.train import camera_opt as jcamera_opt

    for module in (jcamera_opt, run_depth):
        monkeypatch.setattr(module, "optimize_camera_embedding",
                            functools.partial(
                                module.optimize_camera_embedding,
                                epochs=10))
    data_dir, scene_id = scene_dir
    ckpt_dir = str(tmp_path / "ck")
    common = FLAGS + ["--data_dir", data_dir, "--scene_id", scene_id,
                      "--ckpt_dir", ckpt_dir, "--i_weights", "5",
                      "--input_ch_cam", "2"]
    _train_both(common, ckpt_dir, 5, 3 + 2 + 40)
    jrun.main(["test_opt"] + common + ["--expname", "jax", "--eval_det"])
    run_depth.main(["test_opt"] + common + CPU + ["--expname", "port",
                                                  "--eval_det"])
    sub = "test_images_linear_8_8with_optimization_depthscene"
    got, ref = _both(ckpt_dir, sub, "metrics.txt")
    _hold_metrics(got, ref, ("psnr", "psnr0", "ssim", "depth_rmse"))
