"""Image-quality metrics (own copy of ``plnerf/eval/metrics.py``): PSNR,
SSIM matching scikit-image's ``structural_similarity`` defaults (the
reference evaluates SSIM with skimage at run_plnerf.py:339), depth RMSE.

All run on the host in numpy and scipy, once per eval image, never in the
training hot path.
"""
from __future__ import annotations

import numpy as np
from scipy import ndimage

# PSNR floor: an exactly-zero MSE (tiny fixture views can render exactly)
# reports 100 dB instead of the reference's inf (mse2psnr(0),
# run_nerf_helpers.py:18), so metrics.txt / jsonl consumers never have to
# parse "inf".
MSE_FLOOR = 1e-10


def mse2psnr(mse: float) -> float:
    """-10*log10(mse) with the MSE floored at MSE_FLOOR (100 dB cap)."""
    return float(-10.0 * np.log10(max(float(mse), MSE_FLOOR)))


def psnr(img, gt) -> float:
    mse = float(np.mean((np.asarray(img) - np.asarray(gt)) ** 2))
    return mse2psnr(mse)


def _ssim_single(x: np.ndarray, y: np.ndarray, data_range: float,
                 win_size: int = 7, K1: float = 0.01, K2: float = 0.03):
    """skimage-compatible SSIM for one 2-D channel (uniform window,
    sample-covariance normalization, edge crop)."""
    x = x.astype(np.float64)
    y = y.astype(np.float64)
    NP = win_size ** x.ndim
    cov_norm = NP / (NP - 1)

    def filt(a):
        return ndimage.uniform_filter(a, size=win_size)

    ux, uy = filt(x), filt(y)
    uxx, uyy, uxy = filt(x * x), filt(y * y), filt(x * y)
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)

    C1 = (K1 * data_range) ** 2
    C2 = (K2 * data_range) ** 2
    A1, A2 = 2 * ux * uy + C1, 2 * vxy + C2
    B1, B2 = ux ** 2 + uy ** 2 + C1, vx + vy + C2
    S = (A1 * A2) / (B1 * B2)

    pad = (win_size - 1) // 2
    return S[pad:-pad, pad:-pad].mean()


def ssim(img, gt, data_range: float = 1.0) -> float:
    """Multichannel SSIM, mean over channels (skimage channel_axis=-1)."""
    img = np.asarray(img)
    gt = np.asarray(gt)
    if img.ndim == 2:
        return float(_ssim_single(img, gt, data_range))
    vals = [
        _ssim_single(img[..., c], gt[..., c], data_range)
        for c in range(img.shape[-1])
    ]
    return float(np.mean(vals))


def depth_rmse(pred_depth, target_depth, valid_mask) -> float:
    """RMSE over valid-depth pixels (reference run_plnerf.py:328)."""
    pred = np.asarray(pred_depth)
    tgt = np.asarray(target_depth)
    m = np.asarray(valid_mask).astype(bool)
    if m.sum() == 0:
        return float("nan")
    return float(np.sqrt(np.mean((pred[m] - tgt[m]) ** 2)))
