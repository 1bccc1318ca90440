"""Dot-walk probes: the wrappers around the hand-written CUDA kernels of
``csrc/dot_probe.cu``, their plain PyTorch versions and their bound.

The four kernels replace the TPU probe kernels of ``tools/dot_decompose.py``
(``make_shape_kernel``, ``make_mixed_kernel``, ``make_merged_kernel``) and
``tools/mosaic_probe.py`` (``make_kernel``): the fused forward kernel's dot
products, bf16 operands and fp32 sums, with nothing else in the way.

``run_shape``, ``run_mixed``, ``run_merged`` and ``run_mosaic`` dispatch on
the device of ``x``: a CPU tensor runs the plain version, a CUDA tensor
launches the kernel or raises.  There is no fallback from one to the
other.  Every entry point takes a row tile (rows per CTA, the TPU's
``T``) and raises on a row count that is not a multiple of it: the TPU
grid ``N // T`` leaves such a tail unwritten.

All four kernels run on ``wgmma`` and read their weights as one stream
of shared-memory slab images (the layout of the bf16 forward's
``fused_mlp.wgmma_image``) in the order they consume them:
``probe_stream`` for shape and mosaic, ``walk_stream`` for mixed and
merged, each packed by one cached gather at every call.  Callers hand
over raw ``[K, n]`` weights, so the pack is part of the kernel's time.

The plain versions multiply bf16 operands in fp32 (``torch.matmul`` on the
operands cast to fp32, exact products) and round to bf16 exactly where the
TPU kernel bodies do, summing in the same order.
"""
from __future__ import annotations

import ctypes
from typing import Dict, List, Sequence, Tuple

import torch

from . import build
from .fused_mlp import SLAB_K, wgmma_image

KERNEL = "dot_probe"
TILES = (64, 128)          # rows per CTA: mixed, merged, mosaic chained / mlp
SHAPE_TILES = (64, 128, 256)  # shape and mosaic independent (the shape code)
CONCAT_TILES = (64,)       # x, h and cat tiles: 192 KB of smem at 128
WIDTHS = (128, 256, 384)
MAX_REPS = 13              # weights of the shape probe, at most
# the forward's 13-dot walk (tools/dot_decompose.py run_mixed)
MIXED_SHAPES = ([(128, 256)] + [(256, 256)] * 4
                + [(128, 256), (256, 256), (256, 256), (256, 256),
                   (256, 384), (256, 128), (128, 128), (128, 128)])
# the 11-dot walk with skip and views merged (MERGED_SHAPES there)
MERGED_SHAPES = ([(128, 256)] + [(256, 256)] * 4 + [(384, 256)]
                 + [(256, 256)] * 2 + [(256, 384), (384, 128), (128, 128)])
MOSAIC_DEPTH = 13          # tools/mosaic_probe.py D
MOSAIC_WIDTH = 256         # tools/mosaic_probe.py W
VARIANTS = ("chained", "independent", "mlp")

PEAK_BF16_FLOPS = 989e12   # H100 SXM data sheet, dense
HBM_BYTES_PER_S = 3.35e12

# CUDA launches made by each ``*_cuda`` launcher
launches: Dict[str, int] = {"shape": 0, "mixed": 0, "merged": 0, "mosaic": 0}


def bound(flops: float, nbytes: float) -> Tuple[float, str]:
    """(bound_ms, bound_by): the larger of FLOPs at the bf16 tensor-core
    peak and bytes at the HBM rate."""
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def cost(rows: int, shapes: Sequence[Tuple[int, int]], k_in: int,
         n_out: int) -> Tuple[float, float]:
    """(FLOPs, bytes) of one call: every [K, n] weight used once per row,
    x [rows, k_in] bf16 and the weights read once, out [rows, n_out] fp32
    written once."""
    flops = 2.0 * rows * sum(k * n for k, n in shapes)
    nbytes = 2.0 * (rows * k_in + sum(k * n for k, n in shapes)) \
        + 4.0 * rows * n_out
    return flops, nbytes


def mosaic_tiles(variant: str) -> Tuple[int, ...]:
    """Row tiles of a mosaic variant: independent runs the shape code."""
    return SHAPE_TILES if variant == "independent" else TILES


def pass_width(tile: int) -> int:
    """The widest column pass (wgmma N) of the shape and mosaic kernels at
    a row tile: 256, or 128 at the 256-row tile (four consumer warpgroups,
    64 accumulators a thread)."""
    return 128 if tile == 256 else 256


def _passes(n: int, np_max: int) -> List[Tuple[int, int]]:
    """(first column, width) of the column passes over n output columns."""
    return [(c0, min(np_max, n - c0)) for c0 in range(0, n, np_max)]


def probe_stream(ws: Sequence[torch.Tensor], tile: int) -> torch.Tensor:
    """The weights ``ws`` (each [K, n]) as the shape and mosaic kernels
    stream them at row tile ``tile``: for each column pass, each weight,
    each 32-row k-slab, the slab's ``wgmma_image`` (W^T rows of 64 bytes
    in the 64-byte swizzle), in that order.  A permutation of the weights'
    elements."""
    out = []
    for c0, width in _passes(ws[0].shape[1], pass_width(tile)):
        for w in ws:
            for k0 in range(0, w.shape[0], SLAB_K):
                out.append(wgmma_image(w[k0:k0 + SLAB_K, c0:c0 + width]))
    return torch.cat(out)


# The walks' column passes in the kernels' order (csrc/dot_probe.cu WALK):
# (weights summed into one accumulator, first column, width, out column
# or None for a pass kept in the activation tile as bf16).  A product's
# columns bound for out (the head's alpha block) go before its kept pass.
# mixed's skip and views layers are two-term products taken h term first,
# so that each reads the tile's columns 0..383 ([h | x]) as merged's one
# [T, 384] product does.
_LAYERS = [((i,), 0, 256, None) for i in range(5)]
WALKS = {
    "mixed": _LAYERS + [((6, 5), 0, 256, None), ((7,), 0, 256, None),
                        ((8,), 0, 256, None), ((9,), 256, 128, 128),
                        ((9,), 0, 256, None), ((10, 11), 0, 128, None),
                        ((12,), 0, 128, 0)],
    "merged": _LAYERS + [((5,), 0, 256, None), ((6,), 0, 256, None),
                         ((7,), 0, 256, None), ((8,), 256, 128, 128),
                         ((8,), 0, 256, None), ((9,), 0, 128, None),
                         ((10,), 0, 128, 0)],
}


def walk_stream(ws: Sequence[torch.Tensor], walk: str) -> torch.Tensor:
    """The weights ``ws`` of walk ``walk`` ("mixed" or "merged") as its
    kernel streams them: for each pass of ``WALKS[walk]``, each weight
    summed, each 32-row k-slab, the ``wgmma_image`` of the slab's columns
    of the pass, in that order.  The same at every row tile (no pass is
    wider than 256 columns).  A permutation of the weights' elements."""
    out = []
    for terms, c0, width, _ in WALKS[walk]:
        for i in terms:
            for k0 in range(0, ws[i].shape[0], SLAB_K):
                out.append(wgmma_image(ws[i][k0:k0 + SLAB_K, c0:c0 + width]))
    return torch.cat(out)


_STREAM_INDEX: Dict[tuple, torch.Tensor] = {}


def _gather(ws: Sequence[torch.Tensor], key: tuple, layout) -> torch.Tensor:
    """``layout(ws)`` by one gather from the weights laid end to end, its
    index built once per ``key`` and device from element ids."""
    key = key + (str(ws[0].device),)
    if key not in _STREAM_INDEX:
        ids = torch.arange(sum(w.numel() for w in ws), dtype=torch.float64)
        parts = ids.split([w.numel() for w in ws])
        _STREAM_INDEX[key] = layout(
            [p.reshape(w.shape) for p, w in zip(parts, ws)]).long().to(
                ws[0].device)
    return torch.cat([w.reshape(-1) for w in ws])[_STREAM_INDEX[key]]


def pack_stream(ws: Sequence[torch.Tensor], tile: int) -> torch.Tensor:
    """``probe_stream(ws, tile)`` by one gather."""
    return _gather(ws, ("probe", len(ws), *ws[0].shape, pass_width(tile)),
                   lambda p: probe_stream(p, tile))


def pack_walk(ws: Sequence[torch.Tensor], walk: str) -> torch.Tensor:
    """``walk_stream(ws, walk)`` by one gather."""
    return _gather(ws, ("walk", walk), lambda p: walk_stream(p, walk))


# ------------------------------------------------------------ plain --

def _mm(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """bf16 operands, fp32 products and sums (``preferred_element_type``)."""
    return torch.matmul(a.float(), w.float())


def _bf(a: torch.Tensor) -> torch.Tensor:
    return a.to(torch.bfloat16)


def shape_plain(x: torch.Tensor, ws: Sequence[torch.Tensor]) -> torch.Tensor:
    acc = torch.zeros(x.shape[0], ws[0].shape[1], device=x.device)
    for w in ws:
        acc = acc + _mm(x, w)
    return acc


def mixed_plain(x: torch.Tensor, ws: Sequence[torch.Tensor]) -> torch.Tensor:
    w = ws
    h = _bf(_mm(x, w[0]))
    for i in range(1, 5):
        h = _bf(_mm(h, w[i]))
    h = _bf(_mm(x, w[5]) + _mm(h, w[6]))
    h = _bf(_mm(h, w[7]))
    h = _bf(_mm(h, w[8]))
    fa = _mm(h, w[9])
    feature = _bf(fa[:, :256])
    hv = _bf(_mm(feature, w[10]) + _mm(x, w[11]))
    return torch.cat([_mm(hv, w[12]), fa[:, 256:]], dim=1)


def merged_plain(x: torch.Tensor, ws: Sequence[torch.Tensor]) -> torch.Tensor:
    """Both operand modes compute this function."""
    w = ws
    h = _bf(_mm(x, w[0]))
    for i in range(1, 5):
        h = _bf(_mm(h, w[i]))
    h = _bf(_mm(torch.cat([h, x], dim=1), w[5]))
    h = _bf(_mm(h, w[6]))
    h = _bf(_mm(h, w[7]))
    fa = _mm(h, w[8])
    feature = _bf(fa[:, :256])
    hv = _bf(_mm(torch.cat([feature, x], dim=1), w[9]))
    return torch.cat([_mm(hv, w[10]), fa[:, 256:]], dim=1)


def mosaic_plain(x: torch.Tensor, ws: Sequence[torch.Tensor],
                 variant: str) -> torch.Tensor:
    if variant == "independent":
        return shape_plain(x, ws)
    h = x
    for w in ws:
        h = _mm(_bf(h), w)
        if variant == "mlp":
            h = torch.clamp_min(h + 0.01, 0.0)
    return h


# ------------------------------------------------------------- CUDA --

def _library() -> ctypes.CDLL:
    lib = build.load(KERNEL)
    if lib.plnerf_probe_shape.argtypes is None:
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.plnerf_probe_shape.argtypes = [P, P, I, I, I, P, L, I, P]
        lib.plnerf_probe_mixed.argtypes = [P, P, L, P, L, I, P]
        lib.plnerf_probe_merged.argtypes = [P, P, L, I, P, L, I, P]
        lib.plnerf_probe_mosaic.argtypes = [P, P, I, P, L, I, P]
        for fn in (lib.plnerf_probe_shape, lib.plnerf_probe_mixed,
                   lib.plnerf_probe_merged, lib.plnerf_probe_mosaic):
            fn.restype = ctypes.c_int
        lib.plnerf_probe_error_string.argtypes = [I]
        lib.plnerf_probe_error_string.restype = ctypes.c_char_p
    return lib


def _check_rows(x: torch.Tensor, tile: int, tiles=TILES) -> None:
    if tile not in tiles:
        raise ValueError(f"row tile {tile} not in {tiles}")
    if x.dim() != 2 or x.shape[0] % tile:
        raise ValueError(f"x {tuple(x.shape)}: rows must be a multiple of "
                         f"the row tile {tile}")


def _check(t: torch.Tensor, name: str, shape: Tuple[int, int],
           device: torch.device) -> None:
    if (t.device != device or t.dtype != torch.bfloat16
            or tuple(t.shape) != tuple(shape) or not t.is_contiguous()
            or t.data_ptr() % 16):
        raise ValueError(f"{name}: expected contiguous 16-byte aligned "
                         f"bfloat16 {tuple(shape)} on {device}, got "
                         f"{t.dtype} {tuple(t.shape)} on {t.device}")


def _prepare(name: str, x: torch.Tensor, ws: Sequence[torch.Tensor],
             shapes: Sequence[Tuple[int, int]], n_out: int, tile: int,
             tiles=TILES):
    """Checks x, the weights and the tile; returns (out [rows, n_out]
    fp32, the stream)."""
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"{name}_cuda needs CUDA tensors, got {dev}")
    _check_rows(x, tile, tiles)
    if len(ws) != len(shapes):
        raise ValueError(f"{name}: {len(ws)} weights, expected {len(shapes)}")
    _check(x, "x", (x.shape[0], shapes[0][0]), dev)
    for i, (w, s) in enumerate(zip(ws, shapes)):
        _check(w, f"w[{i}]", s, dev)
    out = torch.empty(x.shape[0], n_out, dtype=torch.float32, device=dev)
    return out, torch.cuda.current_stream(dev).cuda_stream


def _count(name: str, rc: int) -> None:
    if rc != 0:
        msg = _library().plnerf_probe_error_string(rc).decode()
        raise RuntimeError(f"dot_probe {name} launch failed: {msg} ({rc})")
    launches[name] += 1


def _shape_of(ws: Sequence[torch.Tensor]) -> Tuple[int, int]:
    if not 1 <= len(ws) <= MAX_REPS:
        raise ValueError(f"shape: {len(ws)} weights, expected 1 to "
                         f"{MAX_REPS}")
    k, n = ws[0].shape
    if k not in WIDTHS or n not in WIDTHS:
        raise ValueError(f"shape: [K, n] = [{k}, {n}], each must be in "
                         f"{WIDTHS}")
    return k, n


def shape_cuda(x: torch.Tensor, ws: Sequence[torch.Tensor],
               tile: int) -> torch.Tensor:
    k, n = _shape_of(ws)
    out, stream = _prepare("shape", x, ws, [(k, n)] * len(ws), n, tile,
                           SHAPE_TILES)
    w = pack_stream(ws, tile)
    _count("shape", _library().plnerf_probe_shape(
        x.data_ptr(), w.data_ptr(), len(ws), k, n, out.data_ptr(),
        x.shape[0], tile, stream))
    return out


def mixed_cuda(x: torch.Tensor, ws: Sequence[torch.Tensor],
               tile: int) -> torch.Tensor:
    out, stream = _prepare("mixed", x, ws, MIXED_SHAPES, 256, tile)
    w = pack_walk(ws, "mixed")
    _count("mixed", _library().plnerf_probe_mixed(
        x.data_ptr(), w.data_ptr(), w.numel() * 2, out.data_ptr(),
        x.shape[0], tile, stream))
    return out


def merged_cuda(x: torch.Tensor, ws: Sequence[torch.Tensor], tile: int,
                use_concat: bool = False) -> torch.Tensor:
    out, stream = _prepare("merged", x, ws, MERGED_SHAPES, 256, tile,
                           CONCAT_TILES if use_concat else TILES)
    w = pack_walk(ws, "merged")
    _count("merged", _library().plnerf_probe_merged(
        x.data_ptr(), w.data_ptr(), w.numel() * 2, int(use_concat),
        out.data_ptr(), x.shape[0], tile, stream))
    return out


def mosaic_cuda(x: torch.Tensor, ws: Sequence[torch.Tensor], tile: int,
                variant: str) -> torch.Tensor:
    if variant not in VARIANTS:
        raise ValueError(f"variant {variant!r} not in {VARIANTS}")
    shapes = [(MOSAIC_WIDTH, MOSAIC_WIDTH)] * MOSAIC_DEPTH
    out, stream = _prepare("mosaic", x, ws, shapes, MOSAIC_WIDTH, tile,
                           mosaic_tiles(variant))
    w = pack_stream(ws, tile)
    _count("mosaic", _library().plnerf_probe_mosaic(
        x.data_ptr(), w.data_ptr(), VARIANTS.index(variant), out.data_ptr(),
        x.shape[0], tile, stream))
    return out


# --------------------------------------------------------- dispatch --

def _on_cpu(x: torch.Tensor, tile: int, tiles=TILES) -> bool:
    """True for a CPU tensor (plain version); the row-tile rule holds on
    every device."""
    _check_rows(x, tile, tiles)
    return x.device.type == "cpu"


def run_shape(x: torch.Tensor, ws: Sequence[torch.Tensor],
              tile: int) -> torch.Tensor:
    """out[N, n] = sum_i x @ ws[i]: x [N, K] bf16, ws[i] [K, n] bf16."""
    if _on_cpu(x, tile, SHAPE_TILES):
        _shape_of(ws)
        return shape_plain(x, ws)
    return shape_cuda(x, ws, tile)


def run_mixed(x: torch.Tensor, ws: Sequence[torch.Tensor],
              tile: int) -> torch.Tensor:
    """The 13-dot walk: x [N, 128], ws of ``MIXED_SHAPES``; out [N, 256]
    = rgb [:, :128] | alpha block [:, 128:]."""
    if _on_cpu(x, tile):
        return mixed_plain(x, ws)
    return mixed_cuda(x, ws, tile)


def run_merged(x: torch.Tensor, ws: Sequence[torch.Tensor], tile: int,
               use_concat: bool = False) -> torch.Tensor:
    """The 11-dot walk: x [N, 128], ws of ``MERGED_SHAPES``; out as
    ``run_mixed``.  ``use_concat`` builds a fresh [T, 384] operand per use
    instead of writing the scratch buffer in place (tile 64 only)."""
    if _on_cpu(x, tile, CONCAT_TILES if use_concat else TILES):
        return merged_plain(x, ws)
    return merged_cuda(x, ws, tile, use_concat)


def run_mosaic(x: torch.Tensor, ws: Sequence[torch.Tensor], tile: int,
               variant: str) -> torch.Tensor:
    """13 [T, 256] @ [256, 256] dots: x [N, 256], out [N, 256]."""
    if variant not in VARIANTS:
        raise ValueError(f"variant {variant!r} not in {VARIANTS}")
    if _on_cpu(x, tile, mosaic_tiles(variant)):
        return mosaic_plain(x, ws, variant)
    return mosaic_cuda(x, ws, tile, variant)
