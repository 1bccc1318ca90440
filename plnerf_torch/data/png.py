"""PNG reading and writing in numpy and the standard library's ``zlib``.

The JAX package reads and writes its images with ``cv2`` and ``imageio``
(``plnerf/data/blender.py:64``, ``plnerf/data/common.py:48-57``,
``plnerf/eval/images.py:410-416``); the port depends on neither.

* ``read_png``: 8- and 16-bit gray, gray + alpha, RGB and RGBA, not
  interlaced, any of the five row filters.  Returns ``uint8`` or
  ``uint16`` pixels in the file's channel order (RGB(A), as ``imageio``
  reads them), ``[H, W]`` for gray and ``[H, W, C]`` otherwise.  Palette
  and interlaced files, other bit depths, bad checksums and unknown
  critical chunks raise ``ValueError``.
* ``write_png``: ``uint8`` or ``uint16`` arrays of 1-4 channels, every row
  with filter 0 (none), zlib-compressed.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# color type -> channels (3, the palette type, is not supported)
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}
_COLOR_TYPE = {c: t for t, c in _CHANNELS.items()}


def _chunks(buf: bytes):
    """(type, data) of every chunk, checksums verified."""
    if buf[:8] != SIGNATURE:
        raise ValueError("not a PNG file")
    pos = 8
    while pos + 12 <= len(buf):
        n, = struct.unpack(">I", buf[pos:pos + 4])
        kind = buf[pos + 4:pos + 8]
        data = buf[pos + 8:pos + 8 + n]
        crc, = struct.unpack(">I", buf[pos + 8 + n:pos + 12 + n])
        if len(data) != n or zlib.crc32(kind + data) != crc:
            raise ValueError(f"PNG chunk {kind!r}: truncated or bad CRC")
        yield kind, data
        pos += 12 + n
        if kind == b"IEND":
            return
    raise ValueError("PNG file ends before its IEND chunk")


def _unfilter(rows: np.ndarray, bpp: int) -> np.ndarray:
    """Undo the per-row filters: rows [H, 1 + W * bpp] -> bytes [H, W, bpp].

    A filtered byte depends on its left, upper and upper-left neighbours,
    so the bytes are rebuilt one anti-diagonal of pixels at a time (all the
    pixels of a diagonal at once): H + W - 1 vector steps per image."""
    H = rows.shape[0]
    ftype = rows[:, 0]
    filt = rows[:, 1:].reshape(H, -1, bpp)
    W = filt.shape[1]
    if ftype.max(initial=0) > 4:
        raise ValueError(f"PNG row filter {int(ftype.max())} is not 0-4")
    if not ftype.any():
        return filt
    # padded by one zero row above and one zero column on the left
    out = np.zeros((H + 1, W + 1, bpp), np.int32)
    filt = filt.astype(np.int32)
    for d in range(H + W - 1):
        r = np.arange(max(0, d - W + 1), min(H - 1, d) + 1)
        x = d - r
        a, b, c = out[r + 1, x], out[r, x + 1], out[r, x]
        t = ftype[r][:, None]
        pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        pred = np.select([t == 1, t == 2, t == 3, t == 4],
                         [a, b, (a + b) >> 1, paeth], 0)
        out[r + 1, x + 1] = (filt[r, x] + pred) & 0xFF
    return out[1:, 1:].astype(np.uint8)


def decode_png(buf: bytes) -> np.ndarray:
    header, idat = None, []
    for kind, data in _chunks(buf):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", data)
        elif kind == b"IDAT":
            idat.append(data)
        elif kind == b"PLTE" or (kind[0] & 0x20) == 0 and kind != b"IEND":
            raise ValueError(f"PNG chunk {kind!r} is not supported "
                             "(palette or unknown critical chunk)")
    if header is None:
        raise ValueError("PNG file has no IHDR chunk")
    W, H, depth, ctype, _, _, interlace = header
    if ctype not in _CHANNELS:
        raise ValueError(f"PNG color type {ctype} is not supported "
                         "(palette images are not read)")
    if depth not in (8, 16):
        raise ValueError(f"PNG bit depth {depth} is not supported")
    if interlace:
        raise ValueError("interlaced PNG files are not supported")
    ch = _CHANNELS[ctype]
    bpp = ch * depth // 8
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != H * (1 + W * bpp):
        raise ValueError("PNG image data does not match its header")
    px = _unfilter(raw.reshape(H, 1 + W * bpp), bpp)
    if depth == 16:
        px = px.reshape(H, W * ch, 2).astype(np.uint16)
        px = (px[..., 0] << 8) | px[..., 1]
    px = px.reshape(H, W, ch)
    return px[..., 0] if ch == 1 else px


def read_png(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_png(f.read())


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data)))


def encode_png(img: np.ndarray, level: int = 6) -> bytes:
    a = np.asarray(img)
    if a.dtype == np.uint8:
        depth = 8
    elif a.dtype == np.uint16:
        depth = 16
    else:
        raise ValueError(f"write uint8 or uint16 pixels, not {a.dtype}")
    if a.ndim == 2:
        a = a[..., None]
    if a.ndim != 3 or a.shape[-1] not in _COLOR_TYPE:
        raise ValueError(f"image of shape {a.shape}: want [H, W] or "
                         "[H, W, 1-4]")
    H, W, ch = a.shape
    rows = a.astype(">u2" if depth == 16 else np.uint8).reshape(H, -1)
    rows = rows.view(np.uint8).reshape(H, -1)
    raw = np.concatenate([np.zeros((H, 1), np.uint8), rows], 1)
    ihdr = struct.pack(">IIBBBBB", W, H, depth, _COLOR_TYPE[ch], 0, 0, 0)
    return (SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), level))
            + _chunk(b"IEND", b""))


def write_png(path: str, img: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(img))
