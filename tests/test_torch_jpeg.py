"""The port's JPEG decoder (``plnerf_torch/data/jpeg.py`` and its native
entropy decoder) against cv2 and imageio on the CPU, and the LLFF driver
on a JPEG-only capture.

Tolerance: none.  The oracles are ``cv2.imread(IMREAD_UNCHANGED)`` with
its channels reversed and ``imageio.v2.imread``, which both wrap
libjpeg-turbo with its defaults; the decoder must equal both bit for bit
on every file: the grid of sampling factors (4:4:4, 4:2:2, 4:2:0, 4:4:0,
4:1:1, gray), baseline and progressive, restart intervals, optimised
Huffman tables, qualities 10 to 100 and sizes down to 1x1, encoded here
with cv2, and the committed fixtures of ``tests/data/torch_jpeg/``
against their manifest's digests.  Each variant the decoder refuses
raises a ``ValueError`` naming the file and the feature."""
import io
import json
import os
import shutil

import cv2
import imageio.v2 as imageio
import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from plnerf_torch.cli import run_plnerf
from plnerf_torch.data import jpeg, llff, synthetic
from plnerf_torch.data.png import encode_png, read_png

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "data", "torch_jpeg")
with open(os.path.join(FIXTURES, "manifest.json")) as _f:
    MANIFEST = json.load(_f)["files"]

SAMPLING = {"444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
            "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
            "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
            "440": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440,
            "411": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411}
SIZES = [(1, 1), (7, 9), (17, 33), (61, 83)]
QUALITIES = [10, 50, 95, 100]


def encode(img, quality=90, sampling="420", progressive=False, restart=0,
           optimize=False) -> bytes:
    params = [cv2.IMWRITE_JPEG_QUALITY, quality]
    if img.ndim == 3:
        params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling]]
    if progressive:
        params += [cv2.IMWRITE_JPEG_PROGRESSIVE, 1]
    if restart:
        params += [cv2.IMWRITE_JPEG_RST_INTERVAL, restart]
    if optimize:
        params += [cv2.IMWRITE_JPEG_OPTIMIZE, 1]
    ok, out = cv2.imencode(".jpg", img, params)
    assert ok
    return out.tobytes()


def oracle(buf: bytes) -> np.ndarray:
    img = cv2.imdecode(np.frombuffer(buf, np.uint8), cv2.IMREAD_UNCHANGED)
    return img[..., ::-1] if img.ndim == 3 else img


def image(h, w, channels, seed, contrast=False):
    """0/255 noise (``contrast``) or ramps and a checker under noise."""
    rng = np.random.default_rng(seed)
    shape = (h, w, channels) if channels > 1 else (h, w)
    if contrast:
        return (rng.integers(0, 2, shape) * 255).astype(np.uint8)
    y, x = np.mgrid[:h, :w]
    base = (x * 7 + y * 3 + ((x // 4 + y // 4) % 2) * 90) % 256
    base = base[..., None] if channels > 1 else base
    return np.clip(base + rng.normal(0, 30, shape), 0, 255).astype(np.uint8)


def assert_decodes_as_oracles(buf: bytes):
    got = jpeg.decode_jpeg(buf)
    ref = oracle(buf)
    assert got.dtype == np.uint8 and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, imageio.imread(io.BytesIO(buf)))


@pytest.mark.parametrize("progressive", [False, True],
                         ids=["baseline", "progressive"])
@pytest.mark.parametrize("sampling", list(SAMPLING) + ["gray"])
def test_grid_bit_equal_to_cv2_and_imageio(sampling, progressive):
    """Sizes 1x1 to 61x83 x qualities 10-100 (0/255 noise at 10 and 100)
    x restart intervals 0, 1 and 3."""
    channels = 1 if sampling == "gray" else 3
    for h, w in SIZES:
        for q in QUALITIES:
            img = image(h, w, channels, h * w + q, contrast=q in (10, 100))
            for restart in (0, 1, 3):
                assert_decodes_as_oracles(encode(
                    img, q, "420" if sampling == "gray" else sampling,
                    progressive, restart))


@pytest.mark.parametrize("sampling", list(SAMPLING))
def test_optimized_tables_bit_equal(sampling):
    assert_decodes_as_oracles(encode(image(40, 56, 3, 1), 75, sampling,
                                     optimize=True))
    assert_decodes_as_oracles(encode(image(40, 56, 3, 2), 75, sampling,
                                     progressive=True, optimize=True))


@settings(max_examples=40, deadline=None, derandomize=True,
          suppress_health_check=[HealthCheck.too_slow])
@given(h=st.integers(1, 48), w=st.integers(1, 48),
       quality=st.integers(1, 100),
       sampling=st.sampled_from(list(SAMPLING) + ["gray"]),
       progressive=st.booleans(), restart=st.integers(0, 4),
       optimize=st.booleans(), contrast=st.booleans(),
       seed=st.integers(0, 2 ** 16))
def test_random_files_bit_equal(h, w, quality, sampling, progressive,
                                restart, optimize, contrast, seed):
    img = image(h, w, 1 if sampling == "gray" else 3, seed, contrast)
    assert_decodes_as_oracles(encode(
        img, quality, "420" if sampling == "gray" else sampling,
        progressive, restart, optimize))


def test_exif_orientation_is_not_applied():
    """Neither oracle rotates by the EXIF tag under IMREAD_UNCHANGED /
    imageio, so neither does the port."""
    from PIL import Image

    exif = Image.Exif()
    exif[0x0112] = 6
    out = io.BytesIO()
    Image.fromarray(image(61, 83, 3, 5)).save(out, "JPEG", quality=90,
                                              exif=exif.tobytes())
    buf = out.getvalue()
    assert jpeg.decode_jpeg(buf).shape == (61, 83, 3)
    assert_decodes_as_oracles(buf)


def test_int64_idct_path_is_the_same(monkeypatch):
    """The IDCT runs a pass in int32 only where that is exact; forced to
    int64 everywhere (libjpeg's JLONG) it returns the same pixels."""
    bufs = [encode(image(61, 83, 3, 9, contrast=True), q, s)
            for q in (10, 100) for s in ("420", "444")]
    fast = [jpeg.decode_jpeg(b) for b in bufs]
    monkeypatch.setattr(jpeg, "_INT32_INPUT", -1)
    for b, f in zip(bufs, fast):
        np.testing.assert_array_equal(jpeg.decode_jpeg(b), f)


def _segments(buf: bytes):
    """[(marker, payload)] up to and including SOS, and the bytes after
    the SOS header."""
    out, pos = [], 2
    while True:
        marker = buf[pos + 1]
        n = int.from_bytes(buf[pos + 2:pos + 4], "big")
        out.append((marker, buf[pos + 4:pos + 2 + n]))
        pos += 2 + n
        if marker == 0xDA:
            return out, buf[pos:]


def _join(segs, rest: bytes) -> bytes:
    out = b"\xff\xd8"
    for marker, payload in segs:
        out += bytes([0xFF, marker]) + (len(payload) + 2).to_bytes(
            2, "big") + payload
    return out + rest


def _patched(buf: bytes, fn) -> bytes:
    segs, rest = _segments(buf)
    return _join([fn(m, p) for m, p in segs], rest)


def test_16_bit_tables_and_extended_sequential():
    """SOF1 with 16-bit quantization tables decodes as cv2 decodes it."""
    def widen(marker, payload):
        if marker == 0xC0:
            return 0xC1, payload
        if marker != 0xDB:
            return marker, payload
        out, p = b"", 0
        while p < len(payload):
            tq = payload[p] & 15
            vals = np.frombuffer(payload[p + 1:p + 65], np.uint8)
            out += bytes([0x10 | tq]) + vals.astype(">u2").tobytes()
            p += 65
        return marker, out

    buf = _patched(encode(image(30, 41, 3, 4), 60), widen)
    assert b"\xff\xc1" in buf
    assert_decodes_as_oracles(buf)


@pytest.mark.parametrize("how", ["adobe0", "adobe1", "adobe2", "rgb_ids",
                                 "odd_ids"])
def test_colour_space_as_libjpeg_guesses_it(how):
    """jdapimin.c default_decompress_parms without a JFIF marker: Adobe
    transform 0 means RGB (no conversion), 1 and others YCbCr; component
    ids 'R', 'G', 'B' mean RGB, other ids YCbCr."""
    adobe = b"Adobe\x00\x64\x00\x00\x00\x00" + bytes(
        [int(how[-1])] if how.startswith("adobe") else b"")
    ids = {"rgb_ids": b"RGB", "odd_ids": b"\x05\x06\x07"}.get(how)

    def fix(marker, payload):
        if marker == 0xE0 and how.startswith("adobe"):
            return 0xEE, adobe
        if marker == 0xE0:
            return 0xFE, b"a comment"
        if ids and marker == 0xC0:
            p = bytearray(payload)
            for i in range(3):
                p[6 + 3 * i] = ids[i]
            return marker, bytes(p)
        if ids and marker == 0xDA:
            p = bytearray(payload)
            for i in range(3):
                p[1 + 2 * i] = ids[i]
            return marker, bytes(p)
        return marker, payload

    buf = _patched(encode(image(24, 40, 3, 6), 90, "444"), fix)
    assert b"JFIF" not in buf
    assert_decodes_as_oracles(buf)


def _sof(marker, payload, **kw):
    p = bytearray(payload)
    if "precision" in kw:
        p[0] = kw["precision"]
    if "height" in kw:
        p[1:3] = kw["height"].to_bytes(2, "big")
    return kw.get("sof", marker), bytes(p)


@pytest.mark.parametrize("case,match", [
    (dict(sof=0xC9), "arithmetic coding"),
    (dict(sof=0xCA), "arithmetic coding"),
    (dict(sof=0xC3), "lossless"),
    (dict(sof=0xC5), "hierarchical"),
    (dict(precision=12), "12-bit sample precision"),
    (dict(height=0), "DNL"),
], ids=["arithmetic", "arithmetic_progressive", "lossless", "hierarchical",
        "12_bit", "height_from_dnl"])
def test_refused_frames_name_the_file_and_feature(tmp_path, case, match):
    buf = _patched(encode(image(16, 16, 3, 0)), lambda m, p: _sof(
        m, p, **case) if m == 0xC0 else (m, p))
    path = str(tmp_path / "refused.jpg")
    with open(path, "wb") as f:
        f.write(buf)
    with pytest.raises(ValueError, match=match) as e:
        jpeg.read_jpeg(path)
    assert path in str(e.value)


def test_refuses_cmyk(tmp_path):
    from PIL import Image

    path = str(tmp_path / "cmyk.jpg")
    Image.new("CMYK", (16, 8), (10, 20, 30, 40)).save(path, "JPEG")
    with pytest.raises(ValueError, match=f"{path}: four components"):
        jpeg.read_jpeg(path)


def test_refuses_dnl_marker_and_truncated_data(tmp_path):
    buf = encode(image(32, 32, 3, 3))
    dnl = buf[:-2] + b"\xff\xdc\x00\x04\x00\x20" + buf[-2:]
    with pytest.raises(ValueError, match="x.jpg: a DNL marker"):
        jpeg.decode_jpeg(dnl, "x.jpg")
    with pytest.raises(ValueError, match="truncated"):
        jpeg.decode_jpeg(buf[:len(buf) // 2], "x.jpg")
    with pytest.raises(ValueError, match="x.png: not a JPEG"):
        jpeg.decode_jpeg(encode_png(np.zeros((2, 2, 3), np.uint8)), "x.png")


def test_a_failed_build_raises(monkeypatch, tmp_path):
    """No fallback: a source g++ cannot compile raises with its output,
    and leaves no library behind."""
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(jpeg, "SRC", str(bad))
    monkeypatch.setattr(jpeg, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(jpeg, "_lib", None)
    with pytest.raises(RuntimeError, match="jpeg_entropy: g\\+\\+ failed"):
        jpeg.decode_jpeg(encode(image(8, 8, 3, 0)))
    assert os.listdir(tmp_path / "build") == []


@pytest.mark.parametrize("name", sorted(
    f for f in MANIFEST if not f.startswith("capture/")))
def test_committed_fixture_matches_manifest(name):
    path = os.path.join(FIXTURES, name)
    got = jpeg.read_jpeg(path)
    assert list(got.shape) == MANIFEST[name]["shape"]
    assert jpeg.digest(got) == MANIFEST[name]["digest"], name
    if not name.startswith("big"):
        np.testing.assert_array_equal(got, oracle(open(path, "rb").read()))


def test_committed_capture_matches_manifest():
    """Each view's decode, and its 504x378 area resize (what ``--factor
    2`` writes to ``images_2/``)."""
    views = sorted(f for f in MANIFEST if f.startswith("capture/"))
    assert len(views) == 20
    for name in views:
        got = jpeg.read_jpeg(os.path.join(FIXTURES, name))
        assert jpeg.digest(got) == MANIFEST[name]["digest"], name
        assert jpeg.digest(llff.area_resize(got, (504, 378))) == \
            MANIFEST[name]["images_2_digest"], name
    pb = np.load(os.path.join(FIXTURES, "capture", "poses_bounds.npy"))
    assert pb.shape == (20, 17)
    np.testing.assert_allclose(pb[:, 4:15:5], [[756, 1008, 0.85 * 1008]]
                               * 20, rtol=1e-6)


def jpeg_capture(d: str, n: int, H: int, W: int) -> str:
    """An LLFF capture with only ``images/NNN.jpg`` at (2H, 2W) (even views
    baseline, odd progressive) and a full-resolution hwf: the
    forward-facing fixture rendered at H x W and enlarged 2x."""
    synthetic.make_llff_fixture(d, n=n, H=H, W=W, factor=2, n_march=48)
    os.makedirs(os.path.join(d, "images"))
    for k in range(n):
        small = read_png(os.path.join(d, "images_2", f"{k:03d}.png"))
        big = cv2.resize(small[..., ::-1], (2 * W, 2 * H),
                         interpolation=cv2.INTER_LINEAR)
        with open(os.path.join(d, "images", f"{k:03d}.jpg"), "wb") as f:
            f.write(encode(big, 90, progressive=bool(k % 2)))
    shutil.rmtree(os.path.join(d, "images_2"))
    return d


def test_llff_driver_trains_resumes_and_tests_from_jpeg(tmp_path):
    """``--config configs/llff_linear.txt --factor 2`` on a JPEG-only
    capture at tiny widths: the loader writes ``images_2/`` from the
    JPEGs, trains, resumes and tests."""
    data = tmp_path / "data"
    jpeg_capture(str(data / "ff"), n=5, H=12, W=16)
    common = ["--config", os.path.join(REPO, "configs", "llff_linear.txt"),
              "--data_dir", str(data), "--scene_id", "ff",
              "--ckpt_dir", str(tmp_path / "ck"), "--expname", "j",
              "--factor", "2", "--dataset", "llff", "--llffhold", "4",
              "--device", "cpu"]
    tiny = ["--N_rand", "64", "--N_samples", "8", "--N_importance", "8",
            "--netdepth", "2", "--netwidth", "16", "--multires", "4",
            "--multires_views", "2", "--chunk", "512", "--i_print", "3",
            "--i_img", "1000000", "--i_testset", "1000000",
            "--i_video", "1000000", "--constant_init", "3"]
    state = run_plnerf.main(common + tiny + ["--num_iterations", "6",
                                             "--i_weights", "6"])
    assert state.step == 6
    small = sorted(os.listdir(data / "ff" / "images_2"))
    assert small == [f"{k:03d}.png" for k in range(5)]
    for k, name in enumerate(small):
        src = jpeg.read_jpeg(str(data / "ff" / "images" / f"{k:03d}.jpg"))
        np.testing.assert_array_equal(
            read_png(str(data / "ff" / "images_2" / name)),
            llff.area_resize(src, (16, 12)))
    state = run_plnerf.main(common + tiny + ["--num_iterations", "9",
                                             "--i_weights", "9"])
    assert state.step == 9
    mm = run_plnerf.main(common + ["--task", "test"])
    assert np.isfinite(mm.get("psnr"))
    sub = tmp_path / "ck" / "j" / "test_images_linear_8_8ff"
    assert read_png(str(sub / "0_rgb.png")).shape == (12, 16, 3)
