"""The port's LLFF loader, its area resize, its forward-facing fixture
writer and the driver's llff DatasetBundle against the JAX package (and
cv2) on the CPU.  Scenes: ``tests/fixtures.make_llff_scene`` (the sphere,
32x32) and the forward-facing fixture of both packages at 30x40.

Tolerances: poses, bounds and render poses 1e-6; images equal, except
after a minify, where the port's area resize and cv2's ``INTER_AREA``
agree within one uint8 level.  JPEG sources (a JPEG-only copy of the
forward-facing fixture) are decoded by the port's decoder and by
imageio / cv2, bit-equal."""
import argparse
import os

import cv2
import numpy as np
import pytest
import torch

from plnerf.cli import datasets as jdatasets
from plnerf.data import llff as jllff
from plnerf.data import synthetic as jsynthetic
from plnerf_torch.cli import datasets
from plnerf_torch.data import llff, synthetic
from plnerf_torch.data.png import read_png, write_png

from fixtures import make_llff_scene

torch.set_num_threads(1)

FF = dict(n=6, H=30, W=40)


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    root = tmp_path_factory.mktemp("llff")
    return {"sphere": make_llff_scene(str(root / "sphere")),
            "ff_jax": jsynthetic.make_llff_fixture(str(root / "ff_jax"),
                                                   **FF),
            "ff_port": synthetic.make_llff_fixture(str(root / "ff_port"),
                                                   **FF)}


def test_fixture_writer_matches_jax(scenes):
    names = sorted(os.listdir(os.path.join(scenes["ff_jax"], "images")))
    assert names == sorted(os.listdir(os.path.join(scenes["ff_port"],
                                                   "images")))
    assert len(names) == FF["n"]
    for name in names:
        ref = cv2.cvtColor(cv2.imread(os.path.join(
            scenes["ff_jax"], "images", name)), cv2.COLOR_BGR2RGB)
        got = read_png(os.path.join(scenes["ff_port"], "images", name))
        np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(
        np.load(os.path.join(scenes["ff_port"], "poses_bounds.npy")),
        np.load(os.path.join(scenes["ff_jax"], "poses_bounds.npy")))


def test_fixture_writer_factor_layout(tmp_path):
    """factor 4: the images go to images_4/ and the poses hold the
    full-resolution hwf, which the loader's factor path divides back."""
    d = synthetic.make_llff_fixture(str(tmp_path), n=4, H=8, W=10,
                                    factor=4, workers=2)
    assert sorted(os.listdir(d)) == ["images_4", "poses_bounds.npy"]
    pb = np.load(os.path.join(d, "poses_bounds.npy"))
    np.testing.assert_allclose(pb[:, 4:15:5], [[32, 40, 0.85 * 40]] * 4,
                               rtol=1e-6)
    images, poses, _, _, _ = llff.load_llff_data(d, factor=4)
    assert images.shape == (4, 8, 10, 3)
    np.testing.assert_allclose(poses[0, :, 4], [8, 10, 0.85 * 10],
                               rtol=1e-6)


def _same(got, ref, images_atol=0.0):
    names = ("images", "poses", "bds", "render_poses", "i_test")
    for name, g, r in zip(names, got, ref):
        g, r = np.asarray(g), np.asarray(r)
        assert g.shape == r.shape and g.dtype == r.dtype, name
        atol = images_atol if name == "images" else 1e-6
        np.testing.assert_allclose(g, r, atol=atol, rtol=0, err_msg=name)


@pytest.mark.parametrize("scene", ["sphere", "ff"])
@pytest.mark.parametrize("kw", [
    dict(factor=1), dict(factor=1, recenter=False),
    dict(factor=1, spherify=True), dict(factor=1, path_zflat=True),
    dict(factor=None, height=16), dict(factor=None, width=20),
    dict(factor=2)], ids=lambda kw: "-".join(f"{k}={v}"
                                             for k, v in kw.items()))
def test_load_llff_data_matches_jax(scenes, tmp_path, scene, kw):
    """Each package loads its own copy of the scene (a minify writes
    beside the images)."""
    import shutil

    src = scenes["sphere" if scene == "sphere" else "ff_jax"]
    for who in ("jax", "port"):
        shutil.copytree(src, tmp_path / who)
    ref = jllff.load_llff_data(str(tmp_path / "jax"), **kw)
    got = llff.load_llff_data(str(tmp_path / "port"), **kw)
    resized = kw.get("factor") != 1
    _same(got, ref, images_atol=1.0 / 255 + 1e-6 if resized else 0.0)
    if resized:
        sub = next(d for d in os.listdir(tmp_path / "port")
                   if d.startswith("images_"))
        assert os.path.isdir(tmp_path / "jax" / sub)


@pytest.mark.parametrize("shape,size", [((30, 40), (20, 15)),
                                        ((97, 131), (50, 40)),
                                        ((64, 64), (32, 32)),
                                        ((50, 60), (59, 49))])
@pytest.mark.parametrize("channels", [1, 3, 4])
def test_area_resize_matches_cv2(shape, size, channels):
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, shape + (channels,), dtype=np.uint8)
    if channels == 1:
        img = img[..., 0]
    got = llff.area_resize(img, size)
    ref = cv2.resize(img, size, interpolation=cv2.INTER_AREA)
    assert got.shape == ref.shape and got.dtype == np.uint8
    assert np.abs(got.astype(int) - ref.astype(int)).max() <= 1


def test_area_resize_halves_a_source_sized_view_exactly():
    """A 1008x756 view (a capture's ``images/``) to 504x378, as ``--factor
    2`` minifies it: the 2x2 box mean, rounded half to even, and quick (one
    three-operand einsum took minutes at this size)."""
    img = np.random.default_rng(1).integers(0, 256, (756, 1008, 3),
                                            dtype=np.uint8)
    box = img.reshape(378, 2, 504, 2, 3).astype(np.float64).mean((1, 3))
    np.testing.assert_array_equal(llff.area_resize(img, (504, 378)),
                                  np.rint(box).astype(np.uint8))


def test_area_resize_refuses_to_enlarge():
    with pytest.raises(ValueError, match="shrinks only"):
        llff.area_resize(np.zeros((4, 4, 3), np.uint8), (5, 4))


def _to_jpeg(d: str) -> None:
    """Replace each ``images/*.png`` of an LLFF scene by a q90 JPEG (even
    views baseline, odd views progressive)."""
    names = sorted(os.listdir(os.path.join(d, "images")))
    for k, name in enumerate(names):
        path = os.path.join(d, "images", name)
        params = [cv2.IMWRITE_JPEG_QUALITY, 90]
        if k % 2:
            params += [cv2.IMWRITE_JPEG_PROGRESSIVE, 1]
        cv2.imwrite(path[:-4] + ".jpg", cv2.imread(path), params)
        os.remove(path)


@pytest.fixture(scope="module")
def jpeg_scene(scenes, tmp_path_factory):
    """The forward-facing fixture with JPEG sources only."""
    import shutil

    d = tmp_path_factory.mktemp("llff_jpeg") / "ff"
    shutil.copytree(scenes["ff_jax"], d)
    _to_jpeg(str(d))
    return str(d)


@pytest.mark.parametrize("kw", [
    dict(factor=1), dict(factor=2), dict(factor=None, height=16),
    dict(factor=None, width=20)],
    ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()))
def test_jpeg_capture_loads_as_jax(jpeg_scene, tmp_path, kw):
    """A JPEG-only capture: the images equal the JAX package's at factor
    1 (the port's decoder and imageio's are bit-equal); after a minify
    within one level (area_resize against cv2's INTER_AREA), with the
    written PNGs held the same way; poses, bounds, render poses and
    i_test as ``test_load_llff_data_matches_jax``."""
    import shutil

    for who in ("jax", "port"):
        shutil.copytree(jpeg_scene, tmp_path / who)
    ref = jllff.load_llff_data(str(tmp_path / "jax"), **kw)
    got = llff.load_llff_data(str(tmp_path / "port"), **kw)
    resized = kw.get("factor") != 1
    _same(got, ref, images_atol=1.0 / 255 + 1e-6 if resized else 0.0)
    subs = sorted(d for d in os.listdir(tmp_path / "port")
                  if d.startswith("images_"))
    assert subs == sorted(d for d in os.listdir(tmp_path / "jax")
                          if d.startswith("images_"))
    assert len(subs) == (1 if resized else 0)
    for sub in subs:
        names = sorted(os.listdir(tmp_path / "port" / sub))
        assert names == sorted(os.listdir(tmp_path / "jax" / sub))
        for name in names:
            a = read_png(str(tmp_path / "port" / sub / name)).astype(int)
            b = cv2.imread(str(tmp_path / "jax" / sub / name))[..., ::-1]
            assert np.abs(a - b).max() <= 1, name


def test_jpeg_source_minifies_as_jax(tmp_path):
    """A folder holding one JPEG among PNGs minifies as the JAX package
    minifies it, and a minified PNG folder already beside the JPEGs is
    used as it is."""
    import shutil

    d = synthetic.make_llff_fixture(str(tmp_path / "port"), n=2, H=8, W=10)
    img = os.path.join(d, "images", "000.png")
    cv2.imwrite(img[:-4] + ".jpg", cv2.imread(img))
    os.remove(img)
    shutil.copytree(d, tmp_path / "jax")
    got = llff.load_llff_data(d, factor=2)
    ref = jllff.load_llff_data(str(tmp_path / "jax"), factor=2)
    _same(got, ref, images_atol=1.0 / 255 + 1e-6)
    assert got[0].shape == (2, 4, 5, 3)
    # the minified PNG folder beside the JPEGs is used as it is
    shutil.rmtree(os.path.join(d, "images_2"))
    os.makedirs(os.path.join(d, "images_2"))
    for name in ("000", "001"):
        write_png(os.path.join(d, "images_2", name + ".png"),
                  np.zeros((4, 5, 3), np.uint8))
    images = llff.load_llff_data(d, factor=2)[0]
    assert images.shape == (2, 4, 5, 3) and not images.any()


def test_image_shape_reads_png_and_jpeg_headers(tmp_path):
    write_png(str(tmp_path / "a.png"), np.zeros((7, 9, 3), np.uint8))
    cv2.imwrite(str(tmp_path / "b.jpg"), np.zeros((11, 13, 3), np.uint8))
    assert llff._image_shape(str(tmp_path / "a.png")) == (7, 9)
    assert llff._image_shape(str(tmp_path / "b.jpg")) == (11, 13)


def _bulky_jpeg(path: str, img: np.ndarray) -> None:
    """A cv2 JPEG of ``img`` with three 60 KB APP1 segments spliced in
    after SOI, so that its SOF lies past the first 64 KiB (as a phone's
    EXIF thumbnail, XMP or MPF segments can put it)."""
    import struct

    ok, buf = cv2.imencode(".jpg", img[..., ::-1])
    assert ok
    b = buf.tobytes()
    payload = b"PLNERF\0" + bytes(60000 - 7)
    seg = b"\xff\xe1" + struct.pack(">H", len(payload) + 2) + payload
    with open(path, "wb") as f:
        f.write(b[:2] + 3 * seg + b[2:])


def test_image_shape_seeks_past_large_app_segments(tmp_path):
    """The SOF of a 60x40 JPEG behind 180 KB of APP1 segments: the size
    equals imageio's, and the decoder reads the file as imageio does."""
    import imageio.v2 as imageio

    from plnerf_torch.data.jpeg import read_jpeg

    img = np.random.default_rng(0).integers(0, 256, (40, 60, 3), np.uint8)
    path = str(tmp_path / "bulky.jpg")
    _bulky_jpeg(path, img)
    with open(path, "rb") as f:
        assert f.read().find(b"\xff\xc0") > 1 << 16
    ref = imageio.imread(path)
    assert llff._image_shape(path) == ref.shape[:2] == (40, 60)
    np.testing.assert_array_equal(read_jpeg(path), ref)


@pytest.mark.parametrize("kw", [dict(factor=None, height=20),
                                dict(factor=None, width=30)],
                         ids=["height=20", "width=30"])
def test_bulky_jpeg_capture_loads_as_jax(tmp_path, kw):
    """A capture of such files through the height / width branch (which
    reads the first source's size): the loaders agree as in
    ``test_jpeg_capture_loads_as_jax``."""
    import shutil

    d = jsynthetic.make_llff_fixture(str(tmp_path / "src"), n=4, H=40, W=60)
    for name in sorted(os.listdir(os.path.join(d, "images"))):
        path = os.path.join(d, "images", name)
        _bulky_jpeg(path[:-4] + ".jpg", read_png(path))
        os.remove(path)
    for who in ("jax", "port"):
        shutil.copytree(d, tmp_path / who)
    ref = jllff.load_llff_data(str(tmp_path / "jax"), **kw)
    got = llff.load_llff_data(str(tmp_path / "port"), **kw)
    _same(got, ref, images_atol=1.0 / 255 + 1e-6)
    assert got[0].shape == (4, 20, 30, 3)


@pytest.mark.parametrize("no_ndc", [False, True])
@pytest.mark.parametrize("llffhold", [8, 0])
def test_llff_bundle_matches_jax(scenes, no_ndc, llffhold):
    root, sid = os.path.split(scenes["ff_port"])
    args = argparse.Namespace(data_dir=root, scene_id=sid, dataset="llff",
                              factor=1, spherify=False, llffhold=llffhold,
                              no_ndc=no_ndc)
    got, ref = datasets.load_dataset(args), jdatasets.load_dataset(args)
    assert (got.near, got.far, got.ndc) == (ref.near, ref.far, ref.ndc)
    assert got.ndc is not no_ndc
    for f in ("i_train", "i_val", "i_test"):
        np.testing.assert_array_equal(getattr(got, f), getattr(ref, f))
    for f in ("images", "poses", "render_poses", "K"):
        np.testing.assert_allclose(getattr(got.data, f), getattr(ref.data, f),
                                   atol=1e-6, err_msg=f)
    assert list(got.data.hwf) == list(ref.data.hwf)
    assert (got.data.near, got.data.far) == (ref.data.near, ref.data.far)
