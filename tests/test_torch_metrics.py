"""The port's eval metrics and held-out renderer against the JAX package's
on the CPU: ``psnr`` / ``ssim`` / ``depth_rmse`` and the MSE floor of
``plnerf_torch/eval/metrics.py`` to 1e-12, and
``render_images_with_metrics`` with the same weights, perturb off, to
1e-4, the image writers included."""
import types

import numpy as np
import pytest
import torch

from plnerf.core.config import ModelConfig as JModelConfig
from plnerf.core.config import RenderConfig as JRenderConfig
from plnerf.eval import images as jimages
from plnerf.eval import metrics as jmetrics
from plnerf_torch.core.config import ModelConfig, RenderConfig
from plnerf_torch.data import png, synthetic
from plnerf_torch.eval import images, metrics

from test_torch_mlp import np_params, torch_model

torch.set_num_threads(1)

KW = dict(netdepth=2, netwidth=32, multires=4, multires_views=2)
RKW = dict(n_samples=8, n_importance=8, mode="linear", white_bkgd=True)


def _pair(shape, seed):
    rng = np.random.default_rng(seed)
    gt = rng.random(shape).astype(np.float32)
    img = np.clip(gt + 0.1 * rng.normal(size=shape), 0, 1).astype(np.float32)
    return img, gt


@pytest.mark.parametrize("shape", [(24, 20, 3), (17, 23)])
def test_metrics_match_jax(shape):
    img, gt = _pair(shape, seed=len(shape))
    assert metrics.psnr(img, gt) == pytest.approx(jmetrics.psnr(img, gt),
                                                  rel=1e-12)
    assert metrics.ssim(img, gt) == pytest.approx(jmetrics.ssim(img, gt),
                                                  rel=1e-12)
    valid = np.random.default_rng(2).random(shape[:2]) > 0.3
    assert metrics.depth_rmse(img[..., 0] if img.ndim == 3 else img,
                              gt[..., 0] if gt.ndim == 3 else gt, valid) == \
        pytest.approx(jmetrics.depth_rmse(
            img[..., 0] if img.ndim == 3 else img,
            gt[..., 0] if gt.ndim == 3 else gt, valid), rel=1e-12)


def test_mse_floor_and_empty_depth_mask_match_jax():
    img, _ = _pair((8, 8, 3), seed=3)
    assert metrics.psnr(img, img) == jmetrics.psnr(img, img) == 100.0
    for mse in (0.0, 1e-12, 1e-10, 0.25):
        assert metrics.mse2psnr(mse) == pytest.approx(
            jmetrics.mse2psnr(mse), rel=1e-12)
    none = np.zeros((8, 8), bool)
    assert np.isnan(metrics.depth_rmse(img[..., 0], img[..., 1], none))
    assert np.isnan(jmetrics.depth_rmse(img[..., 0], img[..., 1], none))


def test_render_images_with_metrics_matches_jax(tmp_path):
    images_np, poses, hwf, K = synthetic.make_sphere_dataset(3, 16, 16)
    ds = types.SimpleNamespace(images=images_np, poses=poses, hwf=hwf, K=K,
                               near=2.0, far=6.0, gt_depths=None,
                               intrinsics=None)
    pc, pf = np_params(KW, seed=0), np_params(KW, seed=1)
    for p in (pc, pf):              # visible content
        p["alpha_linear"]["b"] = p["alpha_linear"]["b"] + 2.0
    idx = [0, 2]
    jm, jres = jimages.render_images_with_metrics(
        pc, pf, ds, idx, JModelConfig(**KW),
        jimages.test_render_config(JRenderConfig(**RKW), perturb=False),
        chunk=64, verbose=False)
    tm, tres = images.render_images_with_metrics(
        torch_model(KW, pc), torch_model(KW, pf), ds, idx, ModelConfig(**KW),
        images.test_render_config(RenderConfig(**RKW), perturb=False),
        chunk=64, verbose=False)
    got, ref = tm.as_dict(), jm.as_dict()
    assert set(got) == set(ref) == {"img_loss", "psnr", "ssim", "img_loss0",
                                    "psnr0"}
    for k in ref:
        assert got[k] == pytest.approx(ref[k], rel=1e-4), k
    assert set(tres) == {"rgbs", "target_rgbs", "depths", "rgbs0", "depths0"}
    for k in tres:
        np.testing.assert_allclose(tres[k], jres[k], rtol=1e-4, atol=1e-4,
                                   err_msg=k)
    assert tm.notes["lpips"].startswith("UNAVAILABLE")

    images.write_images_with_metrics(tres, tm, str(tmp_path))
    for n in range(2):
        rgb = png.read_png(str(tmp_path / f"{n}_rgb.png"))
        assert rgb.shape == (16, 16, 3) and rgb.dtype == np.uint8
        assert np.abs(rgb.astype(int) - (255 * tres["rgbs"][n]).astype(
            np.uint8)).max() == 0
        assert png.read_png(str(tmp_path / f"{n}_d.png")).dtype == np.uint16
    text = (tmp_path / "metrics.txt").read_text()
    assert "psnr: " in text and "ssim: " in text
    assert "lpips: UNAVAILABLE" in text
