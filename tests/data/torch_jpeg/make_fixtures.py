"""Write the JPEG fixtures of the port's decoder and their manifest.

    python tests/data/torch_jpeg/make_fixtures.py [--workers N]

Run from the repository root on a machine with cv2 and PIL (the card's
machine has neither, so the files are committed).  Writes beside this
script:

- ``conformance/*.jpg``: small files over the grid the decoder is held
  to (sampling 4:4:4 / 4:2:2 / 4:2:0 / 4:4:0 / 4:1:1 and gray,
  progressive, restart intervals 1 and 3, optimised Huffman tables,
  quality 10 / 50 / 95 / 100 on noise with strong contrast, sizes 1x1 to
  61x83, an EXIF orientation tag of 6 written with PIL);
- ``big_4032x3024_q90.jpg``: a 12 MP photo-sized file for the decode time;
- ``capture/``: a 20-view LLFF capture, ``images/NNN.jpg`` at 1008x756
  (q90, even views baseline, odd views progressive) and
  ``poses_bounds.npy``: the port's forward-facing scene rendered at
  504x378 and enlarged 2x;
- ``manifest.json``: for each file, ``plnerf_torch.data.jpeg.digest`` of
  cv2's decode (``cv2.IMREAD_UNCHANGED``, channels reversed to RGB) and
  what it exercises; for each capture view also the digest of that decode
  shrunk to 504x378 by the port's ``area_resize`` (what ``--factor 2``
  writes to ``images_2/``).

pytest does not collect this file; it is the only code that imports cv2
for these fixtures.  Re-running it rewrites every file; cv2's encoder is
deterministic, so the files only change with cv2 or PIL.
"""
from __future__ import annotations

import argparse
import io
import json
import os
import shutil
import sys
import tempfile

import cv2
import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(HERE))))

from plnerf_torch.data import jpeg, synthetic  # noqa: E402
from plnerf_torch.data.llff import area_resize  # noqa: E402
from plnerf_torch.data.png import read_png  # noqa: E402

SAMPLING = {"444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
            "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
            "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
            "440": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440,
            "411": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411}
CAPTURE_VIEWS, CAPTURE_HW, CAPTURE_MARCH = 20, (378, 504), 96
BIG_HW = (3024, 4032)


def encode(img: np.ndarray, quality: int = 90, sampling: str = "420",
           progressive: bool = False, restart: int = 0,
           optimize: bool = False) -> bytes:
    """cv2's JPEG of an RGB (or gray) uint8 image."""
    params = [cv2.IMWRITE_JPEG_QUALITY, quality,
              cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling]]
    if progressive:
        params += [cv2.IMWRITE_JPEG_PROGRESSIVE, 1]
    if restart:
        params += [cv2.IMWRITE_JPEG_RST_INTERVAL, restart]
    if optimize:
        params += [cv2.IMWRITE_JPEG_OPTIMIZE, 1]
    bgr = img[..., ::-1] if img.ndim == 3 else img
    ok, out = cv2.imencode(".jpg", np.ascontiguousarray(bgr), params)
    assert ok
    return out.tobytes()


def cv2_decode(buf: bytes) -> np.ndarray:
    """The oracle: cv2.imread(IMREAD_UNCHANGED), channels reversed."""
    img = cv2.imdecode(np.frombuffer(buf, np.uint8), cv2.IMREAD_UNCHANGED)
    return img[..., ::-1] if img.ndim == 3 else img


def textured(h: int, w: int, seed: int) -> np.ndarray:
    """Smooth colour ramps with a checker and noise on top."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[:h, :w].astype(np.float64)
    base = np.stack([x / max(w - 1, 1), y / max(h - 1, 1),
                     ((x // 5 + y // 5) % 2) * 0.6 + 0.2], -1) * 200
    return np.clip(base + rng.normal(0, 25, base.shape), 0, 255).astype(
        np.uint8)


def contrast_noise(h: int, w: int, seed: int) -> np.ndarray:
    """Pixels of 0 or 255, each channel on its own."""
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 2, (h, w, 3)) * 255).astype(np.uint8)


def exif_orientation_6(img: np.ndarray) -> bytes:
    from PIL import Image

    exif = Image.Exif()
    exif[0x0112] = 6
    out = io.BytesIO()
    Image.fromarray(img).save(out, "JPEG", quality=90, exif=exif.tobytes())
    return out.getvalue()


def conformance():
    """{file name: (bytes, what it exercises)}."""
    t = textured(61, 83, 0)
    files = {}
    for s in SAMPLING:
        files[f"s{s}_61x83.jpg"] = (encode(t, sampling=s),
                                    f"baseline, sampling {s}, q90")
    files["gray_61x83.jpg"] = (encode(t[..., 0]), "one component, q90")
    files["gray_progressive_61x83.jpg"] = (
        encode(t[..., 1], progressive=True), "one component, progressive")
    for s in ("420", "444"):
        files[f"progressive_s{s}_61x83.jpg"] = (
            encode(t, sampling=s, progressive=True),
            f"progressive (DC first and refine, AC first with EOB runs, AC "
            f"refine), sampling {s}")
    for r in (1, 3):
        files[f"restart{r}_s420_61x83.jpg"] = (
            encode(t, restart=r), f"restart interval {r} MCUs, sampling 420")
    files["progressive_restart2_s420_61x83.jpg"] = (
        encode(t, progressive=True, restart=2),
        "progressive with restart interval 2 (EOB runs reset)")
    files["optimized_s420_61x83.jpg"] = (
        encode(t, optimize=True), "optimised Huffman tables, sampling 420")
    for q in (10, 50, 95, 100):
        files[f"q{q}_noise_s420_33x17.jpg"] = (
            encode(contrast_noise(33, 17, q), quality=q),
            f"quality {q} on 0/255 noise, sampling 420")
    for h, w in ((1, 1), (7, 9), (17, 33), (61, 83)):
        for s in ("420", "422", "411"):
            files[f"size{h}x{w}_s{s}.jpg"] = (
                encode(textured(h, w, h * w), sampling=s),
                f"{h}x{w}, sampling {s} (edge blocks, fancy or plain "
                f"upsampling)")
    files["exif_orientation6_61x83.jpg"] = (
        exif_orientation_6(t), "EXIF orientation 6 (PIL), decoded unrotated")
    return files


def write_capture(out: str, workers: int) -> dict:
    """The 20-view capture; returns its manifest entries."""
    H, W = CAPTURE_HW
    tmp = tempfile.mkdtemp()
    try:
        synthetic.make_llff_fixture(tmp, n=CAPTURE_VIEWS, H=H, W=W,
                                    factor=2, workers=workers,
                                    n_march=CAPTURE_MARCH)
        img_dir = os.path.join(out, "images")
        os.makedirs(img_dir)
        shutil.copy(os.path.join(tmp, "poses_bounds.npy"), out)
        entries = {}
        for k in range(CAPTURE_VIEWS):
            small = read_png(os.path.join(tmp, "images_2", f"{k:03d}.png"))
            big = cv2.resize(small, (2 * W, 2 * H),
                             interpolation=cv2.INTER_CUBIC)
            buf = encode(big, progressive=bool(k % 2))
            with open(os.path.join(img_dir, f"{k:03d}.jpg"), "wb") as f:
                f.write(buf)
            ref = cv2_decode(buf)
            entries[f"capture/images/{k:03d}.jpg"] = {
                "digest": jpeg.digest(ref), "shape": list(ref.shape),
                "images_2_digest": jpeg.digest(area_resize(ref, (W, H))),
                "exercises": ("LLFF source view, 1008x756, q90, "
                              + ("progressive" if k % 2 else "baseline"))}
        return entries
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workers", type=int, default=4)
    args = ap.parse_args(argv)
    for sub in ("conformance", "capture"):
        shutil.rmtree(os.path.join(HERE, sub), ignore_errors=True)
    os.makedirs(os.path.join(HERE, "conformance"))
    files = {}
    for name, (buf, what) in conformance().items():
        with open(os.path.join(HERE, "conformance", name), "wb") as f:
            f.write(buf)
        ref = cv2_decode(buf)
        files[f"conformance/{name}"] = {
            "digest": jpeg.digest(ref), "shape": list(ref.shape),
            "exercises": what}
    files.update(write_capture(os.path.join(HERE, "capture"), args.workers))
    # the 12 MP file: view 0 of the capture enlarged 4x
    with open(os.path.join(HERE, "capture", "images", "000.jpg"), "rb") as f:
        view = cv2_decode(f.read())
    big = cv2.resize(view, BIG_HW[::-1], interpolation=cv2.INTER_CUBIC)
    buf = encode(big)
    name = "big_4032x3024_q90.jpg"
    with open(os.path.join(HERE, name), "wb") as f:
        f.write(buf)
    ref = cv2_decode(buf)
    files[name] = {"digest": jpeg.digest(ref), "shape": list(ref.shape),
                   "exercises": "4032x3024 (fern's source size), q90, "
                                "baseline 4:2:0: the decode time"}
    manifest = {
        "digest": "plnerf_torch.data.jpeg.digest: sha256 of the decoded "
                  "array's dtype, shape and bytes",
        "oracle": f"cv2 {cv2.__version__} imread(IMREAD_UNCHANGED), "
                  "channels reversed to RGB",
        "files": files}
    with open(os.path.join(HERE, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
        f.write("\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
