"""The port's camera-path videos (``plnerf_torch.eval.images.render_path``,
``write_video``, ``write_depth_video_frames``, ``eval/turbo.py`` and the
drivers' ``video`` tasks) against the JAX package's on the CPU.

``render_path`` renders the same frames as the JAX function on the same
weights at the render tolerance 1e-4 (perturb off); the frames it writes
decode to ``to8b`` of what it returns.  This box has imageio without an
ffmpeg backend, so the JAX ``write_video`` takes its PNG fallback: the
port's frames equal those frames, decoded.  The depth frames equal the
JAX function's cv2 files, decoded with cv2.  Both drivers' video tasks
(``--task video``, ``--render_only --render_test``, ``--i_video`` inside a
training run, and the depth driver's ``video``) write the same relative
file names as the JAX drivers on the same fixture scenes."""
import os

import cv2
import imageio
import numpy as np
import pytest
import torch

import jax

from plnerf.checkpoint import io as jckio
from plnerf.cli import config as jconfig
from plnerf.cli import run_depth as jrun_depth
from plnerf.cli import run_plnerf as jrun
from plnerf.core.config import ModelConfig as JModelConfig
from plnerf.core.config import RenderConfig as JRenderConfig
from plnerf.eval import images as jimages
from plnerf.train import step as jstep
from plnerf_torch.checkpoint import convert_jax
from plnerf_torch.checkpoint import io as ckio
from plnerf_torch.cli import run_depth, run_plnerf
from plnerf_torch.core.config import ModelConfig, RenderConfig
from plnerf_torch.data import png
from plnerf_torch.eval import images
from plnerf_torch.eval.turbo import TURBO
from plnerf_torch.utils.misc import to8b

from fixtures import make_blender2_scene, make_blender_scene
from test_torch_eval_tasks import _tiny_dataset
from test_torch_mlp import np_params, torch_model

torch.set_num_threads(1)

KW = dict(netdepth=2, netwidth=16, multires=4, multires_views=2)


def _files(root):
    """Every file under ``root``, as sorted paths relative to it."""
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def test_turbo_table_is_cv2s():
    ref = cv2.applyColorMap(np.arange(256, dtype=np.uint8)[:, None],
                            cv2.COLORMAP_TURBO)[..., ::-1]
    assert TURBO.dtype == np.uint8 and TURBO.shape == (256, 3)
    np.testing.assert_array_equal(TURBO, ref[:, 0])


@pytest.mark.parametrize("pixel_center,render_factor", [(False, 0),
                                                        (True, 2)])
def test_render_path_matches_jax(tmp_path, pixel_center, render_factor):
    params_c, params_f = np_params(KW, seed=0), np_params(KW, seed=1)
    for p in (params_c, params_f):             # visible content
        p["alpha_linear"]["b"] = p["alpha_linear"]["b"] + 2.0
    rkw = dict(n_samples=16, n_importance=8, mode="linear", white_bkgd=True,
               perturb=False)
    ds = _tiny_dataset()
    kw = dict(near=2.0, far=6.0, chunk=64, render_factor=render_factor,
              verbose=False, pixel_center=pixel_center)
    ref = jimages.render_path(params_c, params_f, ds.poses, ds.hwf, ds.K,
                              JModelConfig(**KW), JRenderConfig(**rkw),
                              savedir=str(tmp_path / "jax"), **kw)
    got = images.render_path(torch_model(KW, params_c),
                             torch_model(KW, params_f), ds.poses, ds.hwf,
                             ds.K, ModelConfig(**KW), RenderConfig(**rkw),
                             savedir=str(tmp_path / "port"), **kw)
    H, W = (ds.hwf[0] // (render_factor or 1),
            ds.hwf[1] // (render_factor or 1))
    for a, b, shape in zip(got, ref, [(2, H, W, 3), (2, H, W), (2, H, W)]):
        assert a.shape == shape and a.dtype == np.float32
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-4, atol=1e-4)
    assert _files(tmp_path / "port") == _files(tmp_path / "jax") == [
        "000.png", "001.png"]
    for i in range(2):
        frame = png.read_png(str(tmp_path / "port" / f"{i:03d}.png"))
        np.testing.assert_array_equal(frame, to8b(got[0][i]))
        jframe = png.read_png(str(tmp_path / "jax" / f"{i:03d}.png"))
        assert np.abs(frame.astype(int) - jframe.astype(int)).max() <= 1


def test_write_video_writes_the_jax_fallback_frames(tmp_path):
    frames = np.random.default_rng(0).uniform(
        -0.1, 1.1, (3, 6, 7, 3)).astype(np.float32)
    got = images.write_video(str(tmp_path / "port" / "video.mp4"), frames)
    ref = jimages.write_video(str(tmp_path / "jax" / "video.mp4"), frames)
    assert got is False and ref is False        # no ffmpeg on this box
    names = ["video/000.png", "video/001.png", "video/002.png"]
    assert _files(tmp_path / "port") == _files(tmp_path / "jax") == names
    for name in names:
        a = png.read_png(str(tmp_path / "port" / name))
        b = imageio.v2.imread(str(tmp_path / "jax" / name))
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, to8b(frames[int(name[6:9])]))


def test_write_depth_video_frames_match_jax(tmp_path):
    depths = np.random.default_rng(1).uniform(
        0.0, 6.5, (2, 5, 9)).astype(np.float32)
    images.write_depth_video_frames(str(tmp_path / "port"), depths, far=6.0)
    jimages.write_depth_video_frames(str(tmp_path / "jax"), depths, far=6.0)
    names = _files(tmp_path / "jax")
    assert _files(tmp_path / "port") == names == [
        "depth_000.png", "depth_001.png", "depthcolor_000.png",
        "depthcolor_001.png"]
    for name in names:
        a = cv2.imread(str(tmp_path / "port" / name), cv2.IMREAD_UNCHANGED)
        b = cv2.imread(str(tmp_path / "jax" / name), cv2.IMREAD_UNCHANGED)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    d = png.read_png(str(tmp_path / "port" / "depth_001.png"))
    assert d.dtype == np.uint16
    c = png.read_png(str(tmp_path / "port" / "depthcolor_001.png"))
    np.testing.assert_array_equal(c, TURBO[to8b(depths[1] / 6.0)])


TINY = [
    "--dataset", "blender", "--no_batching", "--use_viewdirs",
    "--white_bkgd", "--N_rand", "64", "--N_samples", "8",
    "--N_importance", "8", "--netdepth", "2", "--netwidth", "16",
    "--multires", "4", "--multires_views", "2", "--chunk", "512",
    "--lrate", "5e-3", "--i_print", "5", "--i_img", "1000000",
    "--i_testset", "1000000", "--i_video", "1000000", "--testskip", "1",
    "--mode", "linear", "--constant_init", "3",
]
CPU = ["--device", "cpu"]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """The JAX driver's 4-step checkpoint (experiment ``jax``) and its
    weights in a port checkpoint (``port``): (data_dir, ckpt_dir)."""
    root = tmp_path_factory.mktemp("video")
    data, ckpt_dir = str(root / "data"), str(root / "ck")
    make_blender_scene(os.path.join(data, "scene"), n_train=3, n_val=1,
                       n_test=2)
    common = TINY + ["--data_dir", data, "--scene_id", "scene",
                     "--ckpt_dir", ckpt_dir, "--task", "train"]
    jrun.main(common + ["--expname", "jax", "--num_iterations", "4",
                        "--i_weights", "4"])
    _, _, jsetup = jrun.build_configs(jconfig.config_parser().parse_args(
        common + ["--expname", "jax"]))
    jstate = jckio.restore_checkpoint(
        os.path.join(ckpt_dir, "jax", "000004.ckpt"),
        jstep.init_state(jax.random.PRNGKey(0), jsetup))
    state = run_plnerf.main(common + CPU + ["--expname", "port",
                                            "--num_iterations", "0"])
    for module, p in ((state.params_coarse, jstate.params_coarse),
                      (state.params_fine, jstate.params_fine)):
        convert_jax.load_jax_params(module, jax.tree.map(np.array, p))
    state.step = 4
    ckio.save_checkpoint(os.path.join(ckpt_dir, "port"), 4,
                         state.state_dict())
    return data, ckpt_dir


@pytest.mark.parametrize("flags, folder, n, size", [
    (["--task", "video", "--render_factor", "4"], "renderonly_path_000004",
     40, 8),
    (TINY + ["--render_only", "--render_test"], "renderonly_test_000004", 2,
     32)])
def test_video_tasks_write_the_jax_files(trained, flags, folder, n, size):
    """``--task video`` (the 40 hemisphere poses at render factor 4) and
    ``--render_only --render_test`` (the 2 test views at full size; a train
    invocation, so the training flags come along) on the same weights with
    ``--eval_det``: the JAX driver's file names, and frames within one
    8-bit level of its frames."""
    data, ckpt_dir = trained
    argv = ["--data_dir", data, "--scene_id", "scene", "--ckpt_dir",
            ckpt_dir, "--white_bkgd", "--eval_det"] + flags
    jrun.main(argv + ["--expname", "jax"])
    rgbs = run_plnerf.main(argv + CPU + ["--expname", "port"])
    got = _files(os.path.join(ckpt_dir, "port", folder))
    assert got == _files(os.path.join(ckpt_dir, "jax", folder))
    assert got == [f"{i:03d}.png" for i in range(n)] + [
        f"video/{i:03d}.png" for i in range(n)]
    assert rgbs.shape == (n, size, size, 3)
    for name in (got[0], got[-1]):
        a = png.read_png(os.path.join(ckpt_dir, "port", folder, name))
        b = png.read_png(os.path.join(ckpt_dir, "jax", folder, name))
        np.testing.assert_array_equal(a, to8b(rgbs[int(name[-7:-4])]))
        assert np.abs(a.astype(int) - b.astype(int)).max() <= 1


def test_i_video_fires_inside_training(trained, tmp_path):
    """``--i_video 3`` in a 5-step run fires once, at step 3, in both
    drivers, each from its own init: the same files."""
    data, _ = trained
    argv = TINY + ["--data_dir", data, "--scene_id", "scene", "--ckpt_dir",
                   str(tmp_path), "--task", "train", "--num_iterations",
                   "5", "--i_weights", "5", "--i_video", "3",
                   "--render_factor", "8"]
    jrun.main(argv + ["--expname", "jax"])
    state = run_plnerf.main(argv + CPU + ["--expname", "port"])
    assert state.step == 5
    got = [f for f in _files(tmp_path / "port") if "renderonly" in f]
    assert got == [f for f in _files(tmp_path / "jax") if "renderonly" in f]
    assert got == [f"renderonly_path_000003/{i:03d}.png" for i in range(40)] \
        + [f"renderonly_path_000003/video/{i:03d}.png" for i in range(40)]
    assert png.read_png(str(tmp_path / "port" / got[0])).shape == (4, 4, 3)


def test_depth_video_writes_the_jax_files(tmp_path):
    """``run_depth video`` after 2 training steps of each driver: the 40
    poses of the video split, pixel-centre rays, rgb and 16-bit / Turbo
    depth frames under the JAX driver's names."""
    data = str(tmp_path / "data")
    make_blender2_scene(os.path.join(data, "d"), n_train=3, n_test=2,
                        with_depth=True)
    flags = ["--dataset", "blender2_depth", "--mode", "linear", "--N_rand",
             "64", "--N_samples", "8", "--N_importance", "8", "--netdepth",
             "2", "--netwidth", "16", "--multires", "4", "--chunk", "1024",
             "--set_near_plane", "2.0", "--white_bkgd", "--data_dir", data,
             "--scene_id", "d", "--ckpt_dir", str(tmp_path / "ck")]
    for driver, extra, exp in ((jrun_depth, [], "jax"),
                               (run_depth, CPU, "port")):
        driver.main(["train"] + flags + extra + [
            "--expname", exp, "--num_iterations", "2", "--i_weights", "2",
            "--i_print", "1"])
        out = driver.main(["video"] + flags + extra + ["--expname", exp])
    assert out.shape == (40, 32, 32, 3)
    got = _files(tmp_path / "ck" / "port" / "video")
    assert got == _files(tmp_path / "ck" / "jax" / "video")
    assert got == sorted(
        [f"{i:03d}.png" for i in range(40)]
        + [f"depth_{i:03d}.png" for i in range(40)]
        + [f"depthcolor_{i:03d}.png" for i in range(40)]
        + [f"video/{i:03d}.png" for i in range(40)])
    d = png.read_png(str(tmp_path / "ck" / "port" / "video" / "depth_000.png"))
    assert d.dtype == np.uint16 and d.shape == (32, 32)
