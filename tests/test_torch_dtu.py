"""The port's DTU loaders against the JAX package (and PIL and cv2) on the
CPU: ``load_dtu`` / ``load_dtu2`` on ``tests/fixtures.make_dtu_scene`` /
``make_dtu2_scene`` with half_res on and off, the numpy bilinear resize
against PIL's, the RQ decomposition against
``cv2.decomposeProjectionMatrix``, and the driver's DTU bundle with its
split.json dump.

Tolerances: images within 1/255 (they are equal here), K and poses 1e-5;
the resize equal; the decomposition 1e-9."""
import argparse
import json
import os

import cv2
import numpy as np
import pytest
import torch
from PIL import Image

from plnerf.cli import datasets as jdatasets
from plnerf.data import dtu as jdtu
from plnerf_torch.cli import datasets
from plnerf_torch.data import dtu

from fixtures import make_dtu2_scene, make_dtu_scene

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    root = tmp_path_factory.mktemp("dtu")
    return {"DTU": make_dtu_scene(str(root / "dtu"), scene_id=5),
            "DTU2": make_dtu2_scene(str(root / "dtu2"), scene_id=5)}


def _same_tuple(got, ref):
    (gi, gk, gp, grp, ghwf, gsplit, gn, gf, gs) = got
    (ri, rk, rp, rrp, rhwf, rsplit, rn, rf, rs) = ref
    assert gi.shape == ri.shape and gi.dtype == ri.dtype == np.float32
    np.testing.assert_allclose(gi, ri, atol=1.0 / 255 + 1e-7, rtol=0)
    for g, r in ((gk, rk), (gp, rp), (grp, rrp)):
        assert np.asarray(g).shape == np.asarray(r).shape
        np.testing.assert_allclose(g, r, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(ghwf, rhwf, rtol=1e-6)
    for g, r in zip(gsplit, rsplit):
        np.testing.assert_array_equal(g, r)
    assert (gn, gf) == pytest.approx((rn, rf))
    assert [list(x) for x in gs] == [list(x) for x in rs]


@pytest.mark.parametrize("half_res", [True, False])
@pytest.mark.parametrize("which", ["DTU", "DTU2"])
def test_load_dtu_matches_jax(roots, which, half_res):
    split = [i for i in range(49) if i % 7] if which == "DTU" else None
    kw = dict(num_train=42, half_res=half_res, train_split=split)
    mine = dtu.load_dtu if which == "DTU" else dtu.load_dtu2
    ref = jdtu.load_dtu if which == "DTU" else jdtu.load_dtu2
    got = mine(roots[which], 5, **kw)
    _same_tuple(got, ref(roots[which], 5, **kw))
    assert got[0].shape[1:3] == ((16, 16) if half_res else (32, 32))


@pytest.mark.parametrize("shape,size", [((32, 32), (16, 16)),
                                        ((33, 47), (24, 17)),
                                        ((120, 160), (60, 80)),
                                        ((20, 30), (11, 7)),
                                        ((31, 29), (40, 50)),
                                        ((24, 24), (24, 24))])
@pytest.mark.parametrize("gray", [False, True])
def test_bilinear_resize_matches_pil(shape, size, gray):
    rng = np.random.default_rng(1)
    img = rng.integers(0, 256, shape + (() if gray else (3,)),
                       dtype=np.uint8)
    ref = np.array(Image.fromarray(img).resize(size, Image.BILINEAR))
    got = dtu.bilinear_resize(img, size)
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, ref)


def test_bilinear_resize_refuses_alpha():
    with pytest.raises(ValueError, match="gray or RGB"):
        dtu.bilinear_resize(np.zeros((4, 4, 4), np.uint8), (2, 2))


def _projections(n=60, seed=2):
    """Camera matrices P = s K [R | -R c] of both signs of s, and general
    3x4 matrices (every sign pattern of the RQ factors)."""
    rng = np.random.default_rng(seed)
    out = []
    for k in range(n):
        if k % 2:
            out.append(rng.normal(size=(3, 4)) * rng.uniform(0.1, 100))
            continue
        q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        K = np.array([[800, 0.5, 320], [0, 790, 240], [0, 0, 1.0]])
        c = rng.normal(size=3) * 4
        P = K @ np.concatenate([q, -q @ c[:, None]], 1)
        out.append(P * rng.choice([-1.0, 1.0]) * rng.uniform(0.1, 10))
    return out


def test_decompose_projection_matches_cv2():
    for P in _projections():
        K, R, t = cv2.decomposeProjectionMatrix(P)[:3]
        gK, gR, gt = dtu.decompose_projection(P)
        np.testing.assert_allclose(gK / gK[2, 2], K / K[2, 2], rtol=1e-9,
                                   atol=1e-9 * np.abs(K / K[2, 2]).max())
        np.testing.assert_allclose(gR, R, atol=1e-9)
        np.testing.assert_allclose(gt[:3] / gt[3], t[:3] / t[3], rtol=1e-9,
                                   atol=1e-9)
        assert gK[0, 0] > 0 and gK[1, 1] > 0
        assert np.linalg.det(gR) == pytest.approx(1.0)


@pytest.mark.parametrize("which", ["DTU", "DTU2"])
def test_dtu_bundle_and_split_json_match_jax(roots, tmp_path, which):
    bundles = {}
    for who, mod in (("port", datasets), ("jax", jdatasets)):
        os.makedirs(tmp_path / who)
        args = argparse.Namespace(
            data_dir=roots[which], scene_id="", dataset=which,
            dtu_scene_id=5, num_train=42, half_res=True, white_bkgd=False,
            dtu_split=None, expname=who, ckpt_dir=str(tmp_path))
        bundles[who] = mod.load_dataset(args)
    got, ref = bundles["port"], bundles["jax"]
    assert (got.near, got.far, got.ndc) == pytest.approx(
        (ref.near, ref.far, ref.ndc))
    for f in ("i_train", "i_val", "i_test"):
        np.testing.assert_array_equal(getattr(got, f), getattr(ref, f))
    np.testing.assert_allclose(got.data.K, ref.data.K, rtol=1e-6)
    split = [json.load(open(tmp_path / who / "split.json"))
             for who in ("port", "jax")]
    assert split[0].keys() == split[1].keys()
    assert len(split[0]["train_frames"]) == 42
    assert len(split[0]["test_frames"]) == 7
    for key in ("near", "far"):
        assert split[0][key] == pytest.approx(split[1][key])
    for frames in ("train_frames", "test_frames"):
        for g, r in zip(split[0][frames], split[1][frames]):
            assert g["pose_id"] == r["pose_id"]
            for k in ("extrinsic", "intrinsic"):
                np.testing.assert_allclose(g[k], r[k], atol=1e-5)
