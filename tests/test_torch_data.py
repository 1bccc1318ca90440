"""The port's PNG codec and Blender loaders (plnerf_torch/data/) against
cv2, imageio and the JAX package's loaders on the CPU: pixels read and
written bit for bit, the factor-2 resizes against ``cv2.resize``, and
every field of ``SceneData`` / ``DatasetBundle`` on the fixture scenes of
``tests/fixtures.py``."""
import argparse
import struct
import zlib

import cv2
import imageio.v2 as imageio
import numpy as np
import pytest
import torch

from plnerf.cli import datasets as jdatasets
from plnerf.data import blender as jblender
from plnerf_torch.cli import datasets
from plnerf_torch.data import blender, common, png

from fixtures import (make_blender2_scene, make_blender_scene,
                      make_fixed_dist_scene)

torch.set_num_threads(1)


def _image(depth, ch, H=29, W=37, seed=0):
    """Left half noise, right half smooth gradients, so an encoder's
    per-row filter choice varies."""
    rng = np.random.default_rng(seed)
    dtype = np.uint8 if depth == 8 else np.uint16
    top = np.iinfo(dtype).max
    img = rng.integers(0, top + 1, (H, W, ch)).astype(np.float64)
    yy, xx = np.mgrid[0:H, 0:W]
    for c in range(ch):
        img[:, W // 2:, c] = ((np.sin(xx / 5.0 + c) * np.cos(yy / 7.0) + 1)
                              * top / 2)[:, W // 2:]
    return img.astype(dtype)


def _to_cv2(img):
    if img.ndim == 2:
        return img
    code = {3: cv2.COLOR_RGB2BGR, 4: cv2.COLOR_RGBA2BGRA}[img.shape[-1]]
    return cv2.cvtColor(img, code)


def _from_cv2(img):
    if img.ndim == 2:
        return img
    code = {3: cv2.COLOR_BGR2RGB, 4: cv2.COLOR_BGRA2RGBA}[img.shape[-1]]
    return cv2.cvtColor(img, code)


@pytest.mark.parametrize("depth", [8, 16])
@pytest.mark.parametrize("ch", [3, 4])
def test_png_reads_cv2_files_bit_for_bit(tmp_path, depth, ch):
    img = _image(depth, ch)
    path = str(tmp_path / "cv2.png")
    assert cv2.imwrite(path, _to_cv2(img))
    got = png.read_png(path)
    assert got.dtype == img.dtype and np.array_equal(got, img)


@pytest.mark.parametrize("depth", [8, 16])
@pytest.mark.parametrize("ch", [1, 3, 4])
def test_cv2_and_imageio_read_port_files_bit_for_bit(tmp_path, depth, ch):
    img = _image(depth, ch, seed=1)
    img = img[..., 0] if ch == 1 else img
    path = str(tmp_path / "port.png")
    png.write_png(path, img)
    back = _from_cv2(cv2.imread(path, cv2.IMREAD_UNCHANGED))
    assert back.dtype == img.dtype and np.array_equal(back, img)
    if depth == 8 or ch == 1:   # imageio's PIL backend cuts 16-bit color
        assert np.array_equal(imageio.imread(path), img)
    assert np.array_equal(png.read_png(path), img)


def _filter_rows(raw: np.ndarray, bpp: int, types) -> bytes:
    """The PNG row filters, encoded byte by byte (the specification's own
    formulas), row r with filter ``types[r]``."""
    H, n = raw.shape
    out = bytearray()
    for r in range(H):
        t = types[r]
        out.append(t)
        for x in range(n):
            a = int(raw[r, x - bpp]) if x >= bpp else 0
            b = int(raw[r - 1, x]) if r else 0
            c = int(raw[r - 1, x - bpp]) if r and x >= bpp else 0
            if t == 0:
                pred = 0
            elif t == 1:
                pred = a
            elif t == 2:
                pred = b
            elif t == 3:
                pred = (a + b) // 2
            else:
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
            out.append((int(raw[r, x]) - pred) % 256)
    return bytes(out)


def _png_bytes(img, filters, interlace=0, ctype=None):
    H, W, ch = img.shape
    depth = 8 if img.dtype == np.uint8 else 16
    raw = img.astype(">u2" if depth == 16 else np.uint8).reshape(H, -1)
    raw = raw.view(np.uint8).reshape(H, -1)
    ctype = {1: 0, 2: 4, 3: 2, 4: 6}[ch] if ctype is None else ctype
    ihdr = struct.pack(">IIBBBBB", W, H, depth, ctype, 0, 0, interlace)
    data = zlib.compress(_filter_rows(raw, ch * depth // 8, filters))
    return (png.SIGNATURE + png._chunk(b"IHDR", ihdr)
            + png._chunk(b"IDAT", data) + png._chunk(b"IEND", b""))


@pytest.mark.parametrize("depth, ch", [(8, 4), (16, 3), (8, 2), (16, 1)])
@pytest.mark.parametrize("paeth_only", [False, True])
def test_png_undoes_all_five_row_filters(depth, ch, paeth_only):
    """Every filter on every kind of file.  The Paeth-only files hold
    enough random bytes to meet the predictor's one tie that matters
    (|p - b| == |p - c| with b != c, where b must win)."""
    img = _image(depth, ch, H=40, W=33, seed=2)
    filters = [4] * 40 if paeth_only else [r % 5 for r in range(40)][::-1]
    got = png.decode_png(_png_bytes(img, filters))
    assert np.array_equal(got, img[..., 0] if ch == 1 else img)


def test_png_refuses_what_it_does_not_read():
    img = _image(8, 3, H=4, W=4)
    with pytest.raises(ValueError, match="interlaced"):
        png.decode_png(_png_bytes(img, [0] * 4, interlace=1))
    with pytest.raises(ValueError, match="palette"):
        png.decode_png(_png_bytes(img[..., :1], [0] * 4, ctype=3))
    good = _png_bytes(img, [0] * 4)
    with pytest.raises(ValueError, match="CRC"):
        png.decode_png(good[:30] + bytes([good[30] ^ 1]) + good[31:])
    with pytest.raises(ValueError, match="float32"):
        png.encode_png(img.astype(np.float32))


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
def test_downsample_matches_cv2_inter_linear(dtype):
    img = _image(8 if dtype == np.uint8 else 16, 4, H=30, W=38, seed=3)
    ref = cv2.resize(img, (19, 15), interpolation=cv2.INTER_LINEAR)
    assert np.array_equal(common.downsample_2x(img), ref)


def test_downsample_matches_cv2_inter_area_on_floats():
    img = np.random.default_rng(4).random((30, 38, 4)).astype(np.float32)
    ref = cv2.resize(img, (19, 15), interpolation=cv2.INTER_AREA)
    np.testing.assert_allclose(common.downsample_2x(img), ref, rtol=0,
                               atol=1e-6)
    with pytest.raises(ValueError, match="odd"):
        common.downsample_2x(img[:29])


def _same_scene(got, ref, atol=0.0):
    assert got.images.dtype == ref.images.dtype
    np.testing.assert_allclose(got.images, ref.images, rtol=0, atol=atol)
    for f in ("poses", "render_poses", "K", "intrinsics"):
        a, b = getattr(got, f), getattr(ref, f)
        assert (a is None) == (b is None), f
        if a is not None:
            np.testing.assert_array_equal(a, b, err_msg=f)
    assert [float(v) for v in got.hwf] == [float(v) for v in ref.hwf]
    assert len(got.i_split) == len(ref.i_split)
    for a, b in zip(got.i_split, ref.i_split):
        np.testing.assert_array_equal(a, b)
    assert (got.near, got.far) == (ref.near, ref.far)
    for f in ("depths", "valid_depths", "gt_depths", "gt_valid_depths"):
        assert getattr(got, f) is None and getattr(ref, f) is None


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    root = tmp_path_factory.mktemp("scenes")
    return {"blender": make_blender_scene(str(root / "b"), 3, 2, 2),
            "blender2": make_blender2_scene(str(root / "b2"), 3, 2),
            "fixed": make_fixed_dist_scene(str(root / "f"), (0.25, 1.0), 2)}


@pytest.mark.parametrize("half_res", [False, True])
def test_load_blender_matches_jax(scenes, half_res):
    kw = dict(half_res=half_res, testskip=1)
    _same_scene(blender.load_blender(scenes["blender"], **kw),
                jblender.load_blender(scenes["blender"], **kw),
                atol=1e-6 if half_res else 0.0)


@pytest.mark.parametrize("half_res", [False, True])
def test_load_blender2_matches_jax(scenes, half_res):
    _same_scene(blender.load_blender2(scenes["blender2"], half_res),
                jblender.load_blender2(scenes["blender2"], half_res))


@pytest.mark.parametrize("test_dist", [0.25, 1.0])
def test_load_blender_fixed_dist_matches_jax(scenes, test_dist):
    kw = dict(half_res=True, test_dist=test_dist)
    _same_scene(blender.load_blender_fixed_dist(scenes["fixed"], **kw),
                jblender.load_blender_fixed_dist(scenes["fixed"], **kw))


def test_both_packages_refuse_a_depth_scene_with_no_split():
    """The depth loaders (ported with depth supervision) refuse a scene
    with no split to read, as the JAX package's do."""
    for fn, ref in ((blender.load_blender2_depth,
                     jblender.load_blender2_depth),
                    (blender.load_blender_depth,
                     jblender.load_blender_depth)):
        with pytest.raises(ValueError, match="no split"):
            fn("nowhere")
        with pytest.raises(ValueError):
            ref("nowhere")


@pytest.mark.parametrize("dataset, white_bkgd", [
    ("blender", True), ("blender", False), ("blender2", True),
    ("blender_fixeddist", False)])
def test_load_dataset_matches_jax(scenes, dataset, white_bkgd):
    scene = {"blender": scenes["blender"], "blender2": scenes["blender2"],
             "blender_fixeddist": scenes["fixed"]}[dataset]
    args = argparse.Namespace(
        data_dir=scene.rsplit("/", 1)[0], scene_id=scene.rsplit("/", 1)[1],
        dataset=dataset, half_res=dataset != "blender", testskip=1,
        test_dist=1.0, white_bkgd=white_bkgd, set_near_plane=2.0)
    got, ref = datasets.load_dataset(args), jdatasets.load_dataset(args)
    _same_scene(got.data, ref.data)
    assert (got.near, got.far, got.ndc) == (ref.near, ref.far, ref.ndc)
    for f in ("i_train", "i_val", "i_test"):
        np.testing.assert_array_equal(getattr(got, f), getattr(ref, f))

