"""JPEG decoding, as the JAX package's LLFF loader gets it from cv2 and
imageio (``plnerf/data/llff.py:162, 219, 224``).

Both libraries wrap libjpeg-turbo with its defaults: the ISLOW integer
IDCT (jidctint.c), fancy upsampling (jdsample.c) and fixed-point YCbCr to
RGB tables (jdcolor.c).  ``decode_jpeg`` follows those steps integer for
integer, so it returns what ``imageio.v2.imread`` returns, which is
``cv2.imread(path, cv2.IMREAD_UNCHANGED)`` with its channels reversed:
``uint8 [H, W, 3]`` RGB, or ``[H, W]`` for a one-component image.  No
EXIF orientation is applied (neither library applies it there).

The markers are parsed here.  The entropy-coded data of each scan is
decoded by ``_jpeg_entropy.cpp`` (Huffman; sequential and progressive;
restart intervals), compiled with g++ at first use by ``native.build``
and called through ctypes, with no fallback.  Dequantization, the IDCT,
upsampling and colour conversion run in numpy, vectorised across blocks.

Refused with a ``ValueError`` naming the file and the feature, where
libjpeg would decode or guess: arithmetic coding, lossless and
hierarchical frames, a sample precision other than 8 bits, four
components (CMYK, YCCK), a DNL marker, corrupt or truncated entropy data,
and progressive scans that leave low coefficients unrefined (libjpeg
smooths such blocks).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import struct
import threading
import time
from typing import Dict, List, Optional

import numpy as np

from .. import native

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                   "_jpeg_entropy.cpp")
BUILD_DIR = native.BUILD_DIR

# jutils.c jpeg_natural_order: zigzag index -> natural (row-major) index
NATURAL = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])

_SOF_REFUSED = {
    0xC3: "lossless coding (SOF3)",
    0xC5: "hierarchical coding (SOF5)", 0xC6: "hierarchical coding (SOF6)",
    0xC7: "hierarchical lossless coding (SOF7)",
    0xC9: "arithmetic coding (SOF9)", 0xCA: "arithmetic coding (SOF10)",
    0xCB: "arithmetic lossless coding (SOF11)",
    0xCD: "hierarchical arithmetic coding (SOF13)",
    0xCE: "hierarchical arithmetic coding (SOF14)",
    0xCF: "hierarchical arithmetic lossless coding (SOF15)",
    0xDE: "hierarchical coding (DHP)", 0xDF: "hierarchical coding (EXP)",
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(native.build(SRC, "jpeg_entropy",
                                           build_dir=BUILD_DIR))
            lib.jpeg_decode_scan.restype = ctypes.c_int
            lib.jpeg_decode_scan.argtypes = [
                ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.POINTER(ctypes.c_void_p), ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.POINTER(ctypes.c_int64),
                ctypes.c_char_p, ctypes.c_int]
            _lib = lib
        return _lib


class _Component:
    def __init__(self, cid: int, h: int, v: int, tq: int):
        self.id, self.h, self.v, self.tq = cid, h, v, tq
        self.quant: Optional[np.ndarray] = None   # latched at its first scan
        self.coef: Optional[np.ndarray] = None    # [rows, stride, 64] int16
        self.wb = self.hb = 0                     # its size in blocks


def _marker_at(buf: bytes, pos: int, name: str):
    """(marker, position after it) of the marker at or after ``pos``;
    bytes before it are skipped, as libjpeg's next_marker does."""
    n = len(buf)
    while True:
        pos = buf.find(b"\xff", pos)
        if pos < 0 or pos + 1 >= n:
            raise ValueError(f"{name}: truncated JPEG: the data ends "
                             "before its EOI marker")
        pos += 1
        while pos < n and buf[pos] == 0xFF:
            pos += 1
        if pos < n and buf[pos] != 0:
            return buf[pos], pos + 1


def _segment(buf: bytes, pos: int, name: str):
    if pos + 2 > len(buf):
        raise ValueError(f"{name}: truncated JPEG marker segment")
    n = struct.unpack(">H", buf[pos:pos + 2])[0]
    if n < 2 or pos + n > len(buf):
        raise ValueError(f"{name}: truncated JPEG marker segment")
    return buf[pos + 2:pos + n], pos + n


def decode_jpeg(buf: bytes, name: str = "<bytes>",
                times: Optional[Dict[str, float]] = None) -> np.ndarray:
    """Decode a baseline, extended-sequential or progressive Huffman JPEG
    to ``uint8 [H, W, 3]`` RGB or ``[H, W]`` gray.  ``name`` goes into the
    errors.  ``times``, when given, gains the seconds of each stage:
    ``parse``, ``entropy`` (the native scans), ``idct`` (with
    dequantization), ``upsample`` and ``color``."""
    t_start = time.perf_counter()
    buf = bytes(buf)
    if buf[:2] != b"\xff\xd8":
        raise ValueError(f"{name}: not a JPEG file (no SOI marker)")
    quant: List[Optional[np.ndarray]] = [None] * 4
    huff_bits = np.zeros((8, 17), np.uint8)
    huff_vals = np.zeros((8, 256), np.uint8)
    restart = 0
    jfif = False
    adobe = None
    comps: List[_Component] = []
    progressive = None
    size = None
    coef_bits = None
    entropy_s = 0.0
    pos = 2
    while True:
        marker, pos = _marker_at(buf, pos, name)
        if marker == 0xD9:                                 # EOI
            break
        if 0xD0 <= marker <= 0xD7 or marker == 0x01:       # RSTn, TEM
            continue
        if marker in _SOF_REFUSED:
            raise ValueError(f"{name}: {_SOF_REFUSED[marker]} is not "
                             "supported")
        if marker == 0xDC:
            raise ValueError(f"{name}: a DNL marker is not supported")
        if marker == 0xD8:
            raise ValueError(f"{name}: corrupt JPEG: a second SOI marker")
        seg, pos = _segment(buf, pos, name)
        if marker in (0xC0, 0xC1, 0xC2):                   # SOF0-2
            if progressive is not None:
                raise ValueError(f"{name}: corrupt JPEG: a second SOF")
            progressive = marker == 0xC2
            size, comps, mcus = _frame(seg, name)
            coef_bits = np.full((len(comps), 64), -1, np.int64)
        elif marker == 0xC4:                               # DHT
            _tables(seg, huff_bits, huff_vals, name)
        elif marker == 0xDB:                               # DQT
            _quant(seg, quant, name)
        elif marker == 0xDD:                               # DRI
            if len(seg) < 2:
                raise ValueError(f"{name}: corrupt JPEG: a short DRI")
            restart = struct.unpack(">H", seg[:2])[0]
        elif marker == 0xE0:
            jfif = jfif or (len(seg) >= 14 and seg[:5] == b"JFIF\0")
        elif marker == 0xEE:
            if len(seg) >= 12 and seg[:5] == b"Adobe":
                adobe = seg[11]
        elif marker == 0xDA:                               # SOS
            if progressive is None:
                raise ValueError(f"{name}: corrupt JPEG: SOS before SOF")
            t = time.perf_counter()
            pos = _scan(buf, pos, seg, comps, mcus, progressive, restart,
                        quant, huff_bits, huff_vals, coef_bits, name)
            entropy_s += time.perf_counter() - t
        elif 0xE0 <= marker <= 0xEF or marker in (0xFE, 0xCC):
            pass                                   # APPn, COM, DAC
        else:
            raise ValueError(f"{name}: unknown JPEG marker 0x{marker:02X}")
    if progressive is None:
        raise ValueError(f"{name}: no image in the JPEG (no SOF)")
    if progressive and (coef_bits[:, 0] >= 0).all() \
            and (coef_bits[:, 1:10] != 0).any():
        raise ValueError(f"{name}: progressive scans that leave the first "
                         "AC coefficients unrefined (libjpeg smooths such "
                         "blocks) are not supported")
    if any(c.quant is None for c in comps):
        raise ValueError(f"{name}: corrupt JPEG: a component with no scan")
    if times is not None:
        times["parse"] = time.perf_counter() - t_start - entropy_s
        times["entropy"] = entropy_s
    return _pixels(comps, size, jfif, adobe, times)


def read_jpeg(path: str, times: Optional[Dict[str, float]] = None
              ) -> np.ndarray:
    """``decode_jpeg`` of a file; errors name the file."""
    with open(path, "rb") as f:
        return decode_jpeg(f.read(), path, times)


def digest(img: np.ndarray) -> str:
    """sha256 of a decoded image: its dtype, shape and bytes (the hashes of
    ``tests/data/torch_jpeg/manifest.json``)."""
    h = hashlib.sha256(f"{img.dtype.str}{tuple(img.shape)}".encode())
    h.update(np.ascontiguousarray(img).tobytes())
    return h.hexdigest()


def _frame(seg: bytes, name: str):
    if len(seg) < 6:
        raise ValueError(f"{name}: corrupt JPEG: a short SOF")
    prec, H, W, nf = struct.unpack(">BHHB", seg[:6])
    if prec != 8:
        raise ValueError(f"{name}: {prec}-bit sample precision is not "
                         "supported (8 bits only)")
    if H == 0:
        raise ValueError(f"{name}: a frame height of 0 (set by a DNL "
                         "marker) is not supported")
    if W == 0:
        raise ValueError(f"{name}: corrupt JPEG: a frame width of 0")
    if nf == 4:
        raise ValueError(f"{name}: four components (CMYK or YCCK) are not "
                         "supported")
    if nf not in (1, 3):
        raise ValueError(f"{name}: {nf} components are not supported "
                         "(1 or 3)")
    if len(seg) < 6 + 3 * nf:
        raise ValueError(f"{name}: corrupt JPEG: a short SOF")
    comps = []
    for i in range(nf):
        cid, hv, tq = seg[6 + 3 * i:9 + 3 * i]
        h, v = hv >> 4, hv & 15
        if not (1 <= h <= 4 and 1 <= v <= 4) or tq > 3:
            raise ValueError(f"{name}: corrupt JPEG: component {cid} has "
                             f"sampling {h}x{v}, table {tq}")
        comps.append(_Component(cid, h, v, tq))
    hmax, vmax = max(c.h for c in comps), max(c.v for c in comps)
    mcus = -(-W // (8 * hmax)), -(-H // (8 * vmax))
    for c in comps:
        if hmax % c.h or vmax % c.v:
            raise ValueError(f"{name}: sampling factors {c.h}x{c.v} under "
                             f"{hmax}x{vmax} (a fractional ratio) are not "
                             "supported")
        c.coef = np.zeros((mcus[1] * c.v, mcus[0] * c.h, 64), np.int16)
        c.wb = -(-W * c.h // (8 * hmax))
        c.hb = -(-H * c.v // (8 * vmax))
    return (H, W), comps, mcus


def _tables(seg: bytes, bits: np.ndarray, vals: np.ndarray, name: str):
    p = 0
    while p < len(seg):
        if p + 17 > len(seg):
            raise ValueError(f"{name}: corrupt JPEG: a short DHT")
        tc, th = seg[p] >> 4, seg[p] & 15
        counts = np.frombuffer(seg[p + 1:p + 17], np.uint8)
        n = int(counts.sum(dtype=np.int64))
        if tc > 1 or th > 3 or n > 256 or p + 17 + n > len(seg):
            raise ValueError(f"{name}: corrupt JPEG: a bad Huffman table")
        slot = 4 * tc + th
        bits[slot, 0] = 0
        bits[slot, 1:] = counts
        vals[slot] = 0
        vals[slot, :n] = np.frombuffer(seg[p + 17:p + 17 + n], np.uint8)
        p += 17 + n


def _quant(seg: bytes, quant: list, name: str):
    p = 0
    while p < len(seg):
        pq, tq = seg[p] >> 4, seg[p] & 15
        n = 64 * (pq + 1)
        if pq > 1 or tq > 3 or p + 1 + n > len(seg):
            raise ValueError(f"{name}: corrupt JPEG: a bad quantization "
                             "table")
        q = np.frombuffer(seg[p + 1:p + 1 + n],
                          np.uint8 if pq == 0 else ">u2").astype(np.int64)
        table = np.zeros(64, np.int64)
        table[NATURAL] = q
        quant[tq] = table
        p += 1 + n


def _scan(buf, pos, seg, comps, mcus, progressive, restart, quant,
          huff_bits, huff_vals, coef_bits, name) -> int:
    """Decode one scan; returns the offset of the marker after it."""
    if not seg or len(seg) != 4 + 2 * seg[0] or not 1 <= seg[0] <= 4:
        raise ValueError(f"{name}: corrupt JPEG: a bad SOS")
    ns = seg[0]
    by_id = {c.id: i for i, c in enumerate(comps)}
    idx, tabs = [], []
    for i in range(ns):
        cid, t = seg[1 + 2 * i], seg[2 + 2 * i]
        if cid not in by_id or by_id[cid] in idx:
            raise ValueError(f"{name}: corrupt JPEG: a scan names "
                             f"component {cid}")
        idx.append(by_id[cid])
        tabs.append((t >> 4, t & 15))
    ss, se, a = seg[1 + 2 * ns:4 + 2 * ns]
    ah, al = a >> 4, a & 15
    scan = [comps[i] for i in idx]
    if ns > 1 and sum(c.h * c.v for c in scan) > 10:
        raise ValueError(f"{name}: corrupt JPEG: an MCU of more than 10 "
                         "blocks")
    if progressive:
        # jdphuff.c start_pass_phuff_decoder
        bad = (se != 0) if ss == 0 else (ss > se or se > 63 or ns != 1)
        if (ah != 0 and al != ah - 1) or al > 13 or bad:
            raise ValueError(f"{name}: corrupt JPEG: a bad progression "
                             f"(Ss {ss}, Se {se}, Ah {ah}, Al {al})")
        for i in idx:
            coef_bits[i, ss:se + 1] = al
    else:
        ss, se, ah, al = 0, 63, 0, 0
    for c in scan:
        if c.quant is None:
            if quant[c.tq] is None:
                raise ValueError(f"{name}: corrupt JPEG: component {c.id} "
                                 f"uses undefined quantization table {c.tq}")
            c.quant = quant[c.tq].copy()
    desc = np.array([[dc, ac, c.h, c.v, c.coef.shape[1], c.wb, c.hb]
                     for c, (dc, ac) in zip(scan, tabs)], np.int32)
    ptrs = (ctypes.c_void_p * ns)(*[c.coef.ctypes.data for c in scan])
    end = ctypes.c_int64(0)
    err = ctypes.create_string_buffer(256)
    rc = _load().jpeg_decode_scan(
        buf, len(buf), pos, huff_bits.ctypes.data, huff_vals.ctypes.data,
        desc.ctypes.data, ptrs, ns, mcus[0], mcus[1], restart,
        int(progressive), ss, se, ah, al,
        ctypes.byref(end), err, len(err))
    if rc != 0:
        raise ValueError(f"{name}: {err.value.decode()}")
    return end.value


# jidctint.c constants (CONST_BITS 13)
_F = dict(f0298=2446, f0390=3196, f0541=4433, f0765=6270, f0899=7373,
          f1175=9633, f1501=12299, f1847=15137, f1961=16069, f2053=16819,
          f2562=20995, f3072=25172)


def _idct_1d(x):
    """One pass of jidctint.c ``jpeg_idct_islow`` on 8 arrays of the same
    shape (the column or row inputs), before its DESCALE: the 8 outputs
    in order."""
    f = _F
    z2, z3 = x[2], x[6]
    z1 = (z2 + z3) * f["f0541"]
    tmp2 = z1 - z3 * f["f1847"]
    tmp3 = z1 + z2 * f["f0765"]
    tmp0 = (x[0] + x[4]) * 8192
    tmp1 = (x[0] - x[4]) * 8192
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    t0, t1, t2, t3 = x[7], x[5], x[3], x[1]
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * f["f1175"]
    t0 = t0 * f["f0298"]
    t1 = t1 * f["f2053"]
    t2 = t2 * f["f3072"]
    t3 = t3 * f["f1501"]
    z1 = z1 * -f["f0899"]
    z2 = z2 * -f["f2562"]
    z3 = z3 * -f["f1961"] + z5
    z4 = z4 * -f["f0390"] + z5
    t0 += z1 + z3
    t1 += z2 + z4
    t2 += z2 + z3
    t3 += z1 + z4
    return (tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0,
            tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3)


def _range_table() -> np.ndarray:
    """jdmaster.c ``prepare_range_limit_table`` read from the IDCT's
    pointer: the sample for each ``x & RANGE_MASK`` (1023) of a descaled
    output x, wrapping as libjpeg's table does."""
    t = np.zeros(1024 + 128, np.uint8)
    t[:256] = np.arange(256)
    t[256:640] = 255
    t[1024:] = np.arange(128)
    return t[128:]


_RANGE = _range_table()
_IDCT_CHUNK = 4096   # blocks per numpy pass: the work arrays stay in cache
# every intermediate of ``_idct_1d`` is at most 61,214 x max|input| (the
# largest L1 norm of its linear forms), so int32 holds a pass exactly while
# max|input| <= _INT32_INPUT, with DESCALE's rounding term added
_INT32_INPUT = (2 ** 31 - 1 - (1 << 17)) // 61214


def _exact_dtype(x: np.ndarray):
    return np.int32 if np.abs(x).max() <= _INT32_INPUT else np.int64


def idct_islow(coef: np.ndarray, quant: np.ndarray) -> np.ndarray:
    """jidctint.c ``jpeg_idct_islow`` of int16 blocks ``[n, 64]`` (natural
    order) with the quantization table ``[64]``: uint8 ``[n, 8, 8]``.
    The table is cast to int16, as libjpeg's ISLOW_MULT_TYPE; each pass
    runs in int32 where that is exact for its inputs, else in int64 as
    libjpeg's JLONG; DESCALE and the range limit as jidctint.c."""
    q = quant.astype(np.uint16).view(np.int16).astype(np.int32)
    q = q.reshape(8, 1, 8)
    out = np.empty((coef.shape[0], 8, 8), np.uint8)
    for s in range(0, coef.shape[0], _IDCT_CHUNK):
        c = coef[s:s + _IDCT_CHUNK].reshape(-1, 8, 8)
        x = c.transpose(1, 0, 2).astype(np.int32) * q        # [u, n, v]
        x = x.astype(_exact_dtype(x), copy=False)
        ws = np.stack([(o + 1024) >> 11 for o in _idct_1d(x)])  # [y, n, v]
        ws = ws.transpose(2, 0, 1)                           # [v, y, n]
        ws = ws.astype(_exact_dtype(ws), copy=False)
        px = np.stack([(o + (1 << 17)) >> 18 for o in _idct_1d(ws)])
        out[s:s + _IDCT_CHUNK] = _RANGE[px & 1023].transpose(2, 1, 0)
    return out


def _plane(c: _Component) -> np.ndarray:
    """The component's samples [8 hb, 8 wb] (uint8) from its blocks."""
    hb, wb = c.hb, c.wb
    px = idct_islow(c.coef[:hb, :wb].reshape(-1, 64), c.quant)
    return px.reshape(hb, wb, 8, 8).transpose(0, 2, 1, 3).reshape(
        8 * hb, 8 * wb)


def _edges(p: np.ndarray, axis: int):
    """(previous, next) neighbours of ``p`` along ``axis``, the edge
    samples repeated."""
    n = p.shape[axis]
    prev = np.take(p, np.r_[0, np.arange(n - 1)], axis)
    nxt = np.take(p, np.r_[np.arange(1, n), n - 1], axis)
    return prev, nxt


def _interleave(a: np.ndarray, b: np.ndarray, axis: int) -> np.ndarray:
    out = np.stack([a, b], axis + 1)
    shape = list(a.shape)
    shape[axis] *= 2
    return out.reshape(shape)


def upsample(p: np.ndarray, hexp: int, vexp: int) -> np.ndarray:
    """jdsample.c with ``do_fancy_upsampling``: a component's samples
    ``[dh, dw]`` (its downsampled size; edge rows repeated as jdmainct.c
    gives them) expanded by (``hexp``, ``vexp``) = (max_h / h, max_v / v):
    ``h2v1_fancy_upsample``, ``h1v2_fancy_upsample`` and
    ``h2v2_fancy_upsample`` with their rounding biases, ``int_upsample``
    (replication) for other integral factors and for 2x horizontal
    factors of a component at most 2 samples wide."""
    p = p.astype(np.int16)                 # sums below stay under 2^15
    dw = p.shape[1]
    if (hexp, vexp) == (1, 1):
        return p
    if (hexp, vexp) == (2, 1) and dw > 2:
        left, right = _edges(p, 1)
        return _interleave((3 * p + left + 1) >> 2,
                           (3 * p + right + 2) >> 2, 1)
    if (hexp, vexp) == (1, 2):
        up, down = _edges(p, 0)
        return _interleave((3 * p + up + 1) >> 2, (3 * p + down + 2) >> 2, 0)
    if (hexp, vexp) == (2, 2) and dw > 2:
        up, down = _edges(p, 0)
        rows = []
        for s in (3 * p + up, 3 * p + down):
            left, right = _edges(s, 1)
            rows.append(_interleave((3 * s + left + 8) >> 4,
                                    (3 * s + right + 7) >> 4, 1))
        return _interleave(rows[0], rows[1], 0)
    return np.repeat(np.repeat(p, vexp, 0), hexp, 1)


def _ycc_tables():
    """jdcolor.c ``build_ycc_rgb_table`` (SCALEBITS 16, ONE_HALF)."""
    x = np.arange(256, dtype=np.int64) - 128
    one_half = 1 << 15

    def fix(v):
        return int(v * (1 << 16) + 0.5)

    cr_r = (fix(1.40200) * x + one_half) >> 16
    cb_b = (fix(1.77200) * x + one_half) >> 16
    cr_g = -fix(0.71414) * x
    cb_g = -fix(0.34414) * x + one_half
    return (cr_r.astype(np.int16), cb_b.astype(np.int16),
            cr_g.astype(np.int32), cb_g.astype(np.int32))


_CR_R, _CB_B, _CR_G, _CB_G = _ycc_tables()


def ycc_to_rgb(y: np.ndarray, cb: np.ndarray, cr: np.ndarray) -> np.ndarray:
    """jdcolor.c ``ycc_rgb_convert`` on uint8 planes: ``[H, W, 3]``."""
    out = np.empty(y.shape + (3,), np.uint8)
    y = y.astype(np.int16)
    g = ((_CB_G[cb] + _CR_G[cr]) >> 16).astype(np.int16)
    for i, d in enumerate((_CR_R[cr], g, _CB_B[cb])):
        d += y
        out[..., i] = np.clip(d, 0, 255, out=d)
    return out


def _pixels(comps, size, jfif, adobe, times) -> np.ndarray:
    H, W = size
    hmax = max(c.h for c in comps)
    vmax = max(c.v for c in comps)
    t = time.perf_counter()
    planes = [_plane(c) for c in comps]
    t_idct = time.perf_counter()
    full = []
    for c, p in zip(comps, planes):
        dh, dw = -(-H * c.v // vmax), -(-W * c.h // hmax)
        full.append(upsample(p[:dh, :dw], hmax // c.h,
                             vmax // c.v)[:H, :W].astype(np.uint8))
    t_up = time.perf_counter()
    if len(full) == 1:
        out = full[0]
    elif _is_ycc(comps, jfif, adobe):
        out = ycc_to_rgb(*full)
    else:
        out = np.stack(full, -1)
    if times is not None:
        t_end = time.perf_counter()
        times.update(idct=t_idct - t, upsample=t_up - t_idct,
                     color=t_end - t_up)
    return out


def _is_ycc(comps, jfif: bool, adobe) -> bool:
    """jdapimin.c ``default_decompress_parms`` for three components."""
    if jfif:
        return True
    if adobe is not None:
        return adobe != 0
    ids = tuple(c.id for c in comps)
    return ids != (82, 71, 66)                         # 'R', 'G', 'B'
