"""The port's dot-walk probes (plnerf_torch/kernels/dot_probe.py and
plnerf_torch/tools/{dot_decompose,mosaic_probe}.py) against the TPU probe
kernels of tools/dot_decompose.py and tools/mosaic_probe.py.

The TPU kernel bodies run in Pallas interpret mode under this file's own
``pl.pallas_call`` with the tools' BlockSpecs, at 256 rows and row tile
128; the tools are loaded by file path and not edited.  Inputs are bf16
values made with numpy from a seed and handed to both.  Tolerances, scaled
by max|ref|: 1e-5 where the probe only sums in fp32 (shape, mosaic
independent), 2e-2 where it rounds to bf16 between dots (one flipped
rounding moves a value by 2^-8 and travels down the chain)."""
import importlib.util
import os
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from plnerf_torch.kernels import dot_probe
from plnerf_torch.tools import dot_decompose, mosaic_probe

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROWS, TILE = 256, 128
SUMS, RECAST = 1e-5, 2e-2


def _load(name):
    spec = importlib.util.spec_from_file_location(
        f"_tpu_{name}", os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


JDD = _load("dot_decompose")
JMP = _load("mosaic_probe")


def _bf16(rng, shape, scale=1.0):
    """numpy values rounded to bf16: (torch tensor, the same as jax)."""
    t = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
         .to(torch.bfloat16) * scale)
    return t, jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)


def _inputs(k, shapes, seed):
    rng = np.random.default_rng(seed)
    x, jx = _bf16(rng, (ROWS, k))
    ws = [_bf16(rng, s, 0.05) for s in shapes]
    return x, [w for w, _ in ws], jx, [j for _, j in ws]


def _pallas(kernel, jx, jws, n_out, scratch=()):
    """The tools' pallas_call: x in row tiles, every weight whole, out in
    row tiles, all in VMEM; interpret mode."""
    return np.asarray(pl.pallas_call(
        kernel, grid=(ROWS // TILE,),
        in_specs=[pl.BlockSpec((TILE, jx.shape[1]), lambda i: (i, 0),
                               memory_space=pltpu.VMEM)]
        + [pl.BlockSpec(memory_space=pltpu.VMEM)] * len(jws),
        out_specs=pl.BlockSpec((TILE, n_out), lambda i: (i, 0),
                               memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((ROWS, n_out), jnp.float32),
        scratch_shapes=list(scratch), interpret=True)(jx, *jws))


def _close(got, ref, tol):
    ref = np.asarray(ref, np.float64)
    err = np.abs(got.numpy().astype(np.float64) - ref).max()
    assert err <= tol * np.abs(ref).max(), (err, np.abs(ref).max())


SHAPES = [(k, n) for k, n, _ in JDD.WALK] + [(384, 256), (384, 128)]


def test_constants_match_the_tpu_tools():
    assert dot_decompose.N_ROWS == JDD.N_ROWS
    assert dot_decompose.WALK == [tuple(w) for w in JDD.WALK]
    assert dot_probe.MERGED_SHAPES == JDD.MERGED_SHAPES
    assert (mosaic_probe.N, mosaic_probe.D, mosaic_probe.W) == \
        (JMP.N, JMP.D, JMP.W)
    assert sum(c for *_, c in JDD.WALK) == len(dot_probe.MIXED_SHAPES)


@pytest.mark.parametrize("k,n", SHAPES, ids=[f"{k}x{n}" for k, n in SHAPES])
def test_shape_matches_tpu_kernel(k, n):
    x, ws, jx, jws = _inputs(k, [(k, n)] * 13, seed=k + n)
    ref = _pallas(JDD.make_shape_kernel(k, n, 13), jx, jws, n)
    _close(dot_probe.run_shape(x, ws, TILE), ref, SUMS)


def test_mixed_matches_tpu_kernel():
    x, ws, jx, jws = _inputs(128, dot_probe.MIXED_SHAPES, seed=1)
    ref = _pallas(JDD.make_mixed_kernel(), jx, jws, 256)
    _close(dot_probe.run_mixed(x, ws, TILE), ref, RECAST)


@pytest.mark.parametrize("use_concat", [False, True],
                         ids=["scratch", "concat"])
def test_merged_matches_tpu_kernel(use_concat):
    x, ws, jx, jws = _inputs(128, dot_probe.MERGED_SHAPES, seed=2)
    ref = _pallas(JDD.make_merged_kernel(use_concat), jx, jws, 256,
                  [pltpu.VMEM((TILE, 384), jnp.bfloat16)])
    tile = dot_probe.CONCAT_TILES[0] if use_concat else TILE
    _close(dot_probe.run_merged(x, ws, tile, use_concat), ref, RECAST)


@pytest.mark.parametrize("variant", dot_probe.VARIANTS)
def test_mosaic_matches_tpu_kernel(variant):
    x, ws, jx, jws = _inputs(256, [(256, 256)] * 13, seed=3)
    ref = _pallas(JMP.make_kernel(variant), jx, jws, 256)
    _close(mosaic_probe.run(x, ws, variant, TILE), ref,
           SUMS if variant == "independent" else RECAST)


def _shape_schedule(x, ws):
    """shape_kernel's summation order: one fp32 accumulator over every
    32-row k-slab of every weight, in stream order."""
    acc = torch.zeros(x.shape[0], ws[0].shape[1])
    for w in ws:
        for k0 in range(0, w.shape[0], 32):
            acc = acc + torch.matmul(x[:, k0:k0 + 32].float(),
                                     w[k0:k0 + 32].float())
    return acc


def _mosaic_schedule(x, ws, variant):
    """mosaic_kernel's order for chained and mlp: each dot's accumulators
    start at 0 (chained) or 0.01 (mlp), sum its 32-row k-slabs in fp32,
    round to bf16 and, for mlp, take max(v, 0) after the rounding; the
    last dot's result stays fp32 (mlp: max(v, 0))."""
    if variant == "independent":
        return _shape_schedule(x, ws)
    start = 0.01 if variant == "mlp" else 0.0
    h = x
    for i, w in enumerate(ws):
        acc = torch.full((x.shape[0], w.shape[1]), start)
        for k0 in range(0, w.shape[0], 32):
            acc = acc + torch.matmul(h[:, k0:k0 + 32].float(),
                                     w[k0:k0 + 32].float())
        if variant == "mlp":
            acc = torch.where(acc < 0, torch.zeros_like(acc), acc)
        h = acc if i + 1 == len(ws) else acc.to(torch.bfloat16)
    return h


@pytest.mark.parametrize("k,n", SHAPES, ids=[f"{k}x{n}" for k, n in SHAPES])
def test_shape_schedule_matches_plain_and_tpu_kernel(k, n):
    x, ws, jx, jws = _inputs(k, [(k, n)] * 13, seed=k + n)
    got = _shape_schedule(x, ws)
    _close(got, dot_probe.shape_plain(x, ws).numpy(), SUMS)
    _close(got, _pallas(JDD.make_shape_kernel(k, n, 13), jx, jws, n), SUMS)


@pytest.mark.parametrize("variant", dot_probe.VARIANTS)
def test_mosaic_schedule_matches_plain_and_tpu_kernel(variant):
    x, ws, jx, jws = _inputs(256, [(256, 256)] * 13, seed=3)
    tol = SUMS if variant == "independent" else RECAST
    got = _mosaic_schedule(x, ws, variant)
    _close(got, dot_probe.mosaic_plain(x, ws, variant).numpy(), tol)
    _close(got, _pallas(JMP.make_kernel(variant), jx, jws, 256), tol)


def _walk_schedule(x, ws, walk):
    """walk_kernel's order: one [rows, 384] bf16 activation tile, h in
    columns 0..255 and x in 256..383 (the first pass reads x, every other
    pass the tile from column 0); each pass of ``WALKS[walk]`` sums every
    32-row k-slab of its weights, in stream order, into one fp32
    accumulator; a kept pass rounds to bf16 into the tile's first
    columns, in place; the alpha block and rgb go to out as fp32.  concat
    copies h and x unchanged, so both operand modes share this order."""
    tile = torch.zeros(x.shape[0], 384, dtype=torch.bfloat16)
    tile[:, 256:] = x
    out = torch.zeros(x.shape[0], 256)
    for p, (terms, c0, width, out_col) in enumerate(dot_probe.WALKS[walk]):
        col = 256 if p == 0 else 0
        acc = torch.zeros(x.shape[0], width)
        for i in terms:
            w = ws[i]
            for k0 in range(0, w.shape[0], 32):
                acc = acc + torch.matmul(
                    tile[:, col + k0:col + k0 + 32].float(),
                    w[k0:k0 + 32, c0:c0 + width].float())
            col += w.shape[0]
        if out_col is None:
            tile[:, :width] = acc.to(torch.bfloat16)
        else:
            out[:, out_col:out_col + width] = acc
    return out


WALK_SHAPES = {"mixed": dot_probe.MIXED_SHAPES,
               "merged": dot_probe.MERGED_SHAPES}
SCRATCH = [pltpu.VMEM((TILE, 384), jnp.bfloat16)]
# case: (walk, seed, TPU kernel, its scratch, plain version)
WALK_CASES = {
    "mixed": ("mixed", 1, lambda: JDD.make_mixed_kernel(), (),
              dot_probe.mixed_plain),
    "merged_scratch": ("merged", 2, lambda: JDD.make_merged_kernel(False),
                       SCRATCH, dot_probe.merged_plain),
    "merged_concat": ("merged", 2, lambda: JDD.make_merged_kernel(True),
                      SCRATCH, dot_probe.merged_plain),
}


@pytest.mark.parametrize("case", list(WALK_CASES))
def test_walk_schedule_matches_plain_and_tpu_kernel(case):
    """The walk kernels sum a two-term product (mixed's skip and views) in
    one accumulator, h term first, where the TPU kernel adds two dots:
    another fp32 order, held within the recast tolerance."""
    walk, seed, kernel, scratch, plain = WALK_CASES[case]
    shapes = WALK_SHAPES[walk]
    x, ws, jx, jws = _inputs(128, shapes, seed)
    got = _walk_schedule(x, ws, walk)
    _close(got, plain(x, ws).numpy(), RECAST)
    _close(got, _pallas(kernel(), jx, jws, 256, scratch), RECAST)


def _sw64(n, k):
    """Element offset of B[n][k] in a K-major slab image of 32-value rows
    (64 bytes) in the wgmma 64-byte swizzle: byte address bits [4, 6) XOR
    bits [7, 9) (CUTLASS Swizzle<2, 4, 3>)."""
    addr = n * 64 + k * 2
    return (addr ^ (((addr >> 7) & 3) << 4)) // 2


@pytest.mark.parametrize("tile", dot_probe.SHAPE_TILES)
@pytest.mark.parametrize("k,n", [(256, 256), (128, 384), (384, 128)],
                         ids=["256x256", "128x384", "384x128"])
def test_probe_stream_order(tile, k, n):
    """The shape and mosaic kernels read their weights as one stream of
    slab images: per column pass (256 columns, 128 at tile 256; n = 384 as
    256 + 128), weight and 32-row k-slab, the slab's [32, NP] values
    transposed into NP rows of 32 in the 64-byte swizzle.  Named elements
    land where the kernel reads them, and the one-gather pack agrees."""
    reps = 3
    ids = torch.arange(reps * k * n, dtype=torch.float64).reshape(reps, k, n)
    flat = dot_probe.probe_stream(list(ids), tile)
    assert torch.equal(flat.sort().values, torch.arange(reps * k * n,
                                                        dtype=torch.float64))
    np_max = 128 if tile == 256 else 256
    for i, kk, nn in [(0, 0, 0), (0, 1, 5), (1, 33, 2), (2, k - 1, n - 1),
                      (1, 100, n // 2 + 3), (2, 31, min(130, n - 1))]:
        c0 = nn // np_max * np_max
        width = min(np_max, n - c0)
        pos = (c0 * k * reps                        # earlier passes
               + (i * (k // 32) + kk // 32) * width * 32
               + _sw64(nn - c0, kk % 32))
        assert flat[pos] == ids[i, kk, nn], (i, kk, nn)
    ws = [torch.randn(k, n).to(torch.bfloat16) for _ in range(reps)]
    assert torch.equal(dot_probe.pack_stream(ws, tile),
                       dot_probe.probe_stream(ws, tile))


WALK_ELEMENTS = {  # (weight, k row, column) named in the layout test
    "mixed": [(0, 0, 0), (0, 127, 255), (3, 200, 31), (6, 33, 2),
              (5, 100, 200), (9, 5, 300), (9, 255, 0), (10, 40, 127),
              (11, 127, 64), (12, 127, 127)],
    "merged": [(0, 0, 0), (4, 255, 128), (5, 300, 17), (5, 383, 255),
               (8, 31, 383), (8, 200, 255), (9, 383, 1), (10, 64, 100)],
}


@pytest.mark.parametrize("tile", dot_probe.TILES)
@pytest.mark.parametrize("walk", list(dot_probe.WALKS))
def test_walk_stream_order(walk, tile):
    """mixed and merged read their weights as one stream: per pass of
    ``WALKS[walk]`` (none wider than the tile's widest pass, so the stream
    is the same at both tiles), weight and 32-row k-slab, the slab's
    [32, width] values transposed into width rows of 32 in the 64-byte
    swizzle.  Named elements land where the kernel reads them, and the
    one-gather pack agrees."""
    shapes = WALK_SHAPES[walk]
    assert max(p[2] for p in dot_probe.WALKS[walk]) <= \
        dot_probe.pass_width(tile)
    sizes = [k * n for k, n in shapes]
    ids = [p.reshape(s) for p, s in zip(
        torch.arange(sum(sizes), dtype=torch.float64).split(sizes), shapes)]
    flat = dot_probe.walk_stream(ids, walk)
    assert torch.equal(flat.sort().values,
                       torch.arange(sum(sizes), dtype=torch.float64))
    assert flat.numel() * 2 == 1376256   # csrc/dot_probe.cu walk_bytes()
    for i, kk, nn in WALK_ELEMENTS[walk]:
        pos = 0
        for terms, c0, width, _ in dot_probe.WALKS[walk]:
            if i in terms and c0 <= nn < c0 + width:
                pos += sum(shapes[t][0] for t in terms[:terms.index(i)]) \
                    * width
                pos += kk // 32 * width * 32 + _sw64(nn - c0, kk % 32)
                break
            pos += sum(shapes[t][0] for t in terms) * width
        assert flat[pos] == ids[i][kk, nn], (i, kk, nn)
    ws = [torch.randn(*s).to(torch.bfloat16) for s in shapes]
    assert torch.equal(dot_probe.pack_walk(ws, walk),
                       dot_probe.walk_stream(ws, walk))


def test_walk_table_matches_the_kernel_source():
    """``WALKS`` mirrors csrc/dot_probe.cu's WALK, pass by pass: the A
    operand (x for the first pass, then h, or [h | x] for 384 columns),
    its 32-column chunks, the width and the out column (-1: kept)."""
    with open(os.path.join(REPO, "plnerf_torch", "kernels", "csrc",
                           "dot_probe.cu")) as f:
        src = f.read()
    rows = [(s, int(c), int(n), int(o)) for s, c, n, o in re.findall(
        r"\{SRC_(\w+), (\d+), (\d+), (-?\d+)\}", src)]
    for walk, shapes in WALK_SHAPES.items():
        want = []
        for p, (terms, _, width, out_col) in enumerate(dot_probe.WALKS[walk]):
            k = sum(shapes[t][0] for t in terms)
            want.append(("X" if p == 0 else "CAT" if k == 384 else "H",
                         k // 32, width, -1 if out_col is None else out_col))
        assert rows == want, walk


def test_row_tile_256():
    """Tile 256 (four consumer warpgroups) is a tile of shape and mosaic
    independent, which run the shape code; chained and mlp keep 64 and
    128 (their activation tile is overwritten in place, so a layer's 256
    columns must sit in registers: 128 a thread, too many for 544
    threads).  Ragged rows raise at tile 256 as at every tile."""
    x, ws = dot_decompose.inputs(512, 256, [(256, 256)] * 13, "cpu")
    assert torch.equal(dot_probe.run_shape(x, ws, 256),
                       dot_probe.shape_plain(x, ws))
    assert torch.equal(mosaic_probe.run(x, ws, "independent", 256),
                       dot_probe.shape_plain(x, ws))
    for variant in ("chained", "mlp"):
        with pytest.raises(ValueError, match="row tile 256"):
            mosaic_probe.run(x, ws, variant, 256)
    with pytest.raises(ValueError, match="multiple of the row tile"):
        dot_probe.run_shape(x[:384], ws, 256)
    with pytest.raises(ValueError, match="multiple of the row tile"):
        mosaic_probe.run(x[:384], ws, "independent", 256)
    with pytest.raises(ValueError, match="row tile 256"):
        dot_probe.run_mixed(*dot_decompose.inputs(
            512, 128, dot_probe.MIXED_SHAPES, "cpu"), 256)


def _broken_mlp_chain(x, ws, bias, no_relu_at):
    h = x
    for i, w in enumerate(ws):
        h = torch.matmul(h.to(torch.bfloat16).float(), w.float()) + bias
        if i != no_relu_at:
            h = torch.clamp_min(h, 0.0)
    return h


@pytest.mark.parametrize("bias,no_relu_at", [(0.0, None), (0.01, 6),
                                             (0.01, 12)],
                         ids=["no_bias", "no_relu_6", "no_relu_12"])
def test_recast_tolerance_rejects_a_broken_mlp_chain(bias, no_relu_at):
    """The mlp probe's outputs stay below 1, so its limit scales with
    max|ref| itself: a chain without the +0.01 or one relu fails it."""
    x, ws, _, _ = _inputs(256, [(256, 256)] * 13, seed=3)
    ref = dot_probe.mosaic_plain(x, ws, "mlp")
    _close(ref, ref.numpy(), RECAST)
    with pytest.raises(AssertionError):
        _close(_broken_mlp_chain(x, ws, bias, no_relu_at), ref.numpy(),
               RECAST)


RAGGED = {
    "shape": lambda: dot_probe.run_shape(
        *dot_decompose.inputs(200, 128, [(128, 128)] * 2, "cpu"), 128),
    "mixed": lambda: dot_probe.run_mixed(
        *dot_decompose.inputs(200, 128, dot_probe.MIXED_SHAPES, "cpu"), 64),
    "merged": lambda: dot_probe.run_merged(
        *dot_decompose.inputs(96, 128, dot_probe.MERGED_SHAPES, "cpu"), 64,
        True),
    "mosaic": lambda: mosaic_probe.run(
        *mosaic_probe.inputs(200, "cpu"), "mlp", 128),
}


@pytest.mark.parametrize("kernel", list(RAGGED))
def test_ragged_rows_raise(kernel):
    with pytest.raises(ValueError, match="multiple of the row tile"):
        RAGGED[kernel]()


def test_concat_takes_tile_64_only():
    x, ws = dot_decompose.inputs(256, 128, dot_probe.MERGED_SHAPES, "cpu")
    with pytest.raises(ValueError, match="row tile 128"):
        dot_probe.run_merged(x, ws, 128, use_concat=True)
    assert dot_probe.run_merged(x, ws, 128).shape == (256, 256)


def test_cuda_launchers_refuse_cpu_tensors():
    x, ws = dot_decompose.inputs(128, 128, dot_probe.MIXED_SHAPES, "cpu")
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        dot_probe.mixed_cuda(x, ws, 128)


def test_bound_at_the_probe_rows():
    """The probes' bounds at 989 TFLOP/s: 2.27 ms for (128, 256) x13, 4.53
    for (256, 256) x13 and each mosaic variant, 3.66 for the walks."""
    n = dot_decompose.N_ROWS
    for shapes, k, ms in (([(128, 256)] * 13, 128, 2.27),
                          ([(256, 256)] * 13, 256, 4.53),
                          (dot_probe.MIXED_SHAPES, 128, 3.66),
                          (dot_probe.MERGED_SHAPES, 128, 3.66)):
        got, by = dot_probe.bound(*dot_probe.cost(n, shapes, k, 256))
        assert by == "operations" and abs(got - ms) < 0.01, (got, ms)


def test_dot_decompose_runs_on_cpu():
    out = dot_decompose.main(["--device", "cpu", "--rows", "256",
                              "--what", "shapes,mixed,merged,real"])
    assert [r["shape"] for r in out["A"]["shapes"]] == \
        [[k, n] for k, n, _ in dot_decompose.WALK]
    assert out["A"]["predicted_walk_ms"] > 0 and out["B"]["ms"] > 0
    assert [r["tile"] for r in out["D"]["mixed"]] == list(dot_probe.TILES)
    assert {(r["operand"], r["tile"]) for r in out["E"]["merged"]} == \
        {("scratch", 128), ("scratch", 64), ("concat", 64)}
    assert [r["heads"] for r in out["C"]["forward"]] == ["split", "folded"]


def test_mosaic_probe_runs_on_cpu():
    out = mosaic_probe.main(["--device", "cpu", "--rows", "256"])
    assert [(r["tile"], r["variant"]) for r in out] == [
        (t, v) for t in dot_probe.SHAPE_TILES for v in dot_probe.VARIANTS
        if t in dot_probe.mosaic_tiles(v)]
    assert [(r["tile"], r["variant"]) for r in out][-1] == \
        (256, "independent")
    assert all(r["ms"] > 0 for r in out)
