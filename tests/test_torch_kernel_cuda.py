"""The hand-written CUDA kernels (plnerf_torch/kernels/csrc/fused_mlp_fwd.cu,
fused_mlp_bwd.cu and dot_probe.cu) against their plain PyTorch versions,
on a CUDA device only.

This file imports neither JAX nor ``plnerf``, so it also runs on a machine
with a card and no JAX: ``python -m pytest --noconftest
tests/test_torch_kernel_cuda.py``.  Without a card every test skips."""
import pytest
import torch

from plnerf_torch.core.config import ModelConfig
from plnerf_torch.core.encoding import embed
from plnerf_torch.core.mlp import NeRF
from plnerf_torch.kernels import dot_probe, fused_mlp

torch.set_num_threads(1)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode "
                    "(python3 chip_smoke.py runs it on the H100)")
    return torch.device("cuda")


CASES = {
    "full_split": (dict(), False),
    "full_folded": (dict(), True),
    "plain_head": (dict(use_viewdirs=False, output_ch=4, netdepth=3,
                        netwidth=32, multires=4), False),
    "skips_2_4_folded": (dict(netdepth=6, netwidth=64, skips=(2, 4),
                              multires=6), True),
    "narrow_2x16": (dict(netdepth=2, netwidth=16, multires=4,
                         multires_views=2), False),
}


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", list(CASES))
def test_cuda_kernel_matches_plain_version(cuda_device, dtype, tol, case):
    kw, fold = CASES[case]
    cfg = ModelConfig(**kw)
    g = torch.Generator(device=cuda_device).manual_seed(0)
    m = NeRF(cfg, g, device=cuda_device)
    R, S = 37, 29                                      # ragged last tile
    pts = torch.randn(R, S, 3, generator=g, device=cuda_device)
    vd = torch.nn.functional.normalize(
        torch.randn(R, 3, generator=g, device=cuda_device), dim=-1)
    pe = embed(pts, cfg.multires, cfg.pi_bands)
    ve = (embed(vd, cfg.multires_views, cfg.pi_bands)[:, None, :]
          if cfg.use_viewdirs else None)
    with torch.no_grad():
        p, x, v, v_div = fused_mlp.prepare(m, pe, ve, cfg, dtype, fold)
        before = fused_mlp.launches
        got = fused_mlp.forward_cuda(p, x, v, v_div)
        torch.cuda.synchronize()
        assert fused_mlp.launches == before + 1
        ref = fused_mlp.forward_plain(p, x, v, v_div)
        assert v_div == (S if cfg.use_viewdirs else 1)
    torch.testing.assert_close(got, ref, atol=tol, rtol=tol)


FWD_HEADS = {"split": (dict(), False), "folded": (dict(), True),
             "plain": (dict(use_viewdirs=False, output_ch=4), False)}


def _fwd_inputs(head, dtype, dev, R, S):
    """Full-width (8x256) packed MLP and inputs of R rays x S samples,
    per-ray views (v_div = S) for the viewdirs heads."""
    kw, fold = FWD_HEADS[head]
    cfg = ModelConfig(**kw)
    g = torch.Generator(device=dev).manual_seed(R * 1000 + S)
    m = NeRF(cfg, g, device=dev)
    pe = embed(torch.randn(R, S, 3, generator=g, device=dev), cfg.multires,
               cfg.pi_bands)
    ve = None
    if cfg.use_viewdirs:
        vd = torch.nn.functional.normalize(
            torch.randn(R, 3, generator=g, device=dev), dim=-1)
        ve = embed(vd, cfg.multires_views, cfg.pi_bands)[:, None, :]
    return fused_mlp.prepare(m, pe, ve, cfg, dtype, fold)


# (rays, samples): 333 points, three 128-point tiles (an odd count) and a
# ragged last one; one point; 385 points (four tiles, one point in the
# last) with 77 samples per view row, which no tile boundary follows
FWD_EDGE_SIZES = [(3, 111), (1, 1), (5, 77)]


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("head", list(FWD_HEADS))
@pytest.mark.parametrize("R,S", FWD_EDGE_SIZES,
                         ids=[f"{r}x{s}" for r, s in FWD_EDGE_SIZES])
def test_cuda_forward_at_tile_edges(cuda_device, dtype, tol, head, R, S):
    """The full-width forward against its plain version where the point
    tiles and the per-ray views end raggedly."""
    with torch.no_grad():
        p, x, v, v_div = _fwd_inputs(head, dtype, cuda_device, R, S)
        assert x.shape[0] == R * S and v_div == (1 if head == "plain" else S)
        before = fused_mlp.launches
        got = fused_mlp.forward_cuda(p, x, v, v_div)
        torch.cuda.synchronize()
        assert fused_mlp.launches == before + 1
        ref = fused_mlp.forward_plain(p, x, v, v_div)
    assert torch.isfinite(got).all()
    scale = max(1.0, float(ref.abs().max()))
    assert float((got - ref).abs().max()) <= tol * scale


@pytest.mark.parametrize("head", list(FWD_HEADS))
def test_cuda_forward_fp32_across_chunks(cuda_device, head, monkeypatch):
    """The fp32 forward's launch sequences over chunks of whole view rows:
    at 1,000 points per chunk, 29 rays x 111 samples run as chunks of 999,
    999, 999 and 222 points; one launch counted per call."""
    monkeypatch.setattr(fused_mlp, "FWD_CHUNK", 1000)
    with torch.no_grad():
        p, x, v, v_div = _fwd_inputs(head, torch.float32, cuda_device, 29,
                                     111)
        if head != "plain":
            assert fused_mlp.fwd_chunks(x.shape[0], v_div)[-1] == (2997, 222)
        before = fused_mlp.launches
        got = fused_mlp.forward_cuda(p, x, v, v_div)
        torch.cuda.synchronize()
        assert fused_mlp.launches == before + 1
        ref = fused_mlp.forward_plain(p, x, v, v_div)
    scale = max(1.0, float(ref.abs().max()))
    assert float((got - ref).abs().max()) <= 1e-4 * scale


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("head", list(FWD_HEADS))
def test_cuda_forward_is_deterministic(cuda_device, dtype, head):
    """No atomics, a fixed order of every sum: two calls bit-identical."""
    with torch.no_grad():
        p, x, v, v_div = _fwd_inputs(head, dtype, cuda_device, 11, 97)
        a = fused_mlp.forward_cuda(p, x, v, v_div)
        b = fused_mlp.forward_cuda(p, x, v, v_div)
    assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("head", list(FWD_HEADS))
def test_cuda_registered_op_is_the_kernel(cuda_device, dtype, head,
                                          monkeypatch):
    """``torch.ops.plnerf_torch.fused_mlp_fwd`` (what an exported serving
    program calls) on CUDA tensors launches the kernel: bit-equal to
    ``forward_cuda``, one launch counted.  When the kernel cannot be
    built it raises and never runs the plain version."""
    with torch.no_grad():
        p, x, v, v_div = _fwd_inputs(head, dtype, cuda_device, 13, 61)
        ref = fused_mlp.forward_cuda(p, x, v, v_div)
        wbuf, bbuf = p.flat()
        before = fused_mlp.launches
        got = fused_mlp.forward_flat(p, wbuf, bbuf, x, v, v_div)
        torch.cuda.synchronize()
    assert fused_mlp.launches == before + 1
    assert torch.equal(got, ref)

    def broken(name):
        raise RuntimeError(f"nvcc failed for {name}.cu")

    def plain(*a, **k):
        raise AssertionError("the plain version ran on CUDA tensors")

    monkeypatch.setattr(fused_mlp, "_library", lambda: broken("fused_mlp_fwd"))
    monkeypatch.setattr(fused_mlp, "forward_plain", plain)
    with torch.no_grad(), pytest.raises(RuntimeError, match="nvcc failed"):
        fused_mlp.forward_flat(p, wbuf, bbuf, x, v, v_div)


def _inputs(cfg, fold, dtype, dev, R=37, S=29):
    g = torch.Generator(device=dev).manual_seed(0)
    m = NeRF(cfg, g, device=dev)
    pts = torch.randn(R, S, 3, generator=g, device=dev)
    vd = torch.nn.functional.normalize(
        torch.randn(R, 3, generator=g, device=dev), dim=-1)
    pe = embed(pts, cfg.multires, cfg.pi_bands)
    ve = embed(vd, cfg.multires_views, cfg.pi_bands)[:, None, :]
    cot = torch.randn(R * S, 4, generator=g, device=dev)
    return m, pe, ve, cot


def _assert_rel_l2(got, ref, tol, name):
    """||got - ref|| <= tol * ||ref||: grads jump where a relu mask flips
    (a pre-activation within rounding of 0 is kept by one summation order
    and dropped by the other), which moves a few elements by up to their
    full size and the norm by little."""
    d = float((got.double() - ref.double()).norm())
    assert d <= tol * float(ref.double().norm()), (name, d,
                                                   float(ref.norm()))


BWD_CASES = {k: v for k, v in CASES.items() if k != "plain_head"}


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", list(BWD_CASES))
def test_cuda_backward_matches_plain_version(cuda_device, dtype, tol, case):
    """Every packed weight and bias grad, dx and the per-point dv, at
    37 rays x 29 samples (ragged last tile, per-ray views)."""
    kw, fold = BWD_CASES[case]
    cfg = ModelConfig(**kw)
    m, pe, ve, cot = _inputs(cfg, fold, dtype, cuda_device)
    with torch.no_grad():
        p, x, v, v_div = fused_mlp.prepare(m, pe, ve, cfg, dtype, fold)
        before = fused_mlp.bwd_launches
        got = fused_mlp.backward_cuda(p, x, v, v_div, cot)
        torch.cuda.synchronize()
        assert fused_mlp.bwd_launches == before + 1
        ref = fused_mlp.backward_plain(p, x, v, v_div, cot)
    for name, a, b in zip(("dW", "db"), got[:2], ref[:2]):
        assert len(a) == len(b)
        for i, (ga, gb) in enumerate(zip(a, b)):
            assert ga.shape == gb.shape
            _assert_rel_l2(ga, gb, tol, f"{name}[{i}]")
    _assert_rel_l2(got[2], ref[2], tol, "dx")
    _assert_rel_l2(got[3], ref[3], tol, "dv")


# (rays, samples per ray): n = 1; n below one 128-point tile; n = 128 k
# - 1 and 128 k + 1; n past the smallest weight-pass chunk (256 points)
# and across many chunks; per-ray views whose samples per ray (the views'
# row divisor) do not divide the tile
EDGE_SIZES = [(1, 1), (7, 11), (1, 127), (3, 43), (1, 255), (257, 1),
              (3, 100), (41, 100)]


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("fold", [False, True], ids=["split", "folded"])
@pytest.mark.parametrize("R,S", EDGE_SIZES,
                         ids=[f"{r}x{s}" for r, s in EDGE_SIZES])
def test_cuda_backward_at_tile_edges(cuda_device, dtype, tol, fold, R, S):
    """The full-width backward against its plain version where the point
    tiles, the weight-pass chunks and the per-ray views end raggedly."""
    cfg = ModelConfig()
    m, pe, ve, cot = _inputs(cfg, fold, dtype, cuda_device, R, S)
    with torch.no_grad():
        p, x, v, v_div = fused_mlp.prepare(m, pe, ve, cfg, dtype, fold)
        assert v_div == S and x.shape[0] == R * S
        got = fused_mlp.backward_cuda(p, x, v, v_div, cot)
        torch.cuda.synchronize()
        ref = fused_mlp.backward_plain(p, x, v, v_div, cot)
    for name, a, b in zip(("dW", "db"), got[:2], ref[:2]):
        for i, (ga, gb) in enumerate(zip(a, b)):
            assert torch.isfinite(ga).all()
            _assert_rel_l2(ga, gb, tol, f"{name}[{i}]")
    _assert_rel_l2(got[2], ref[2], tol, "dx")
    _assert_rel_l2(got[3], ref[3], tol, "dv")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("fold", [False, True])
def test_cuda_backward_is_deterministic(cuda_device, fold, dtype):
    """No floating-point atomics: two calls give bit-identical grads."""
    cfg = ModelConfig()
    m, pe, ve, cot = _inputs(cfg, fold, dtype, cuda_device, 64, 97)
    with torch.no_grad():
        p, x, v, v_div = fused_mlp.prepare(m, pe, ve, cfg, dtype, fold)
        a = fused_mlp.backward_cuda(p, x, v, v_div, cot)
        b = fused_mlp.backward_cuda(p, x, v, v_div, cot)
    for ta, tb in zip(a[0] + a[1] + [a[2], a[3]], b[0] + b[1] + [b[2], b[3]]):
        assert torch.equal(ta, tb)


def test_cuda_backward_refuses_plain_topology(cuda_device):
    kw, fold = CASES["plain_head"]
    cfg = ModelConfig(**kw)
    g = torch.Generator(device=cuda_device).manual_seed(0)
    m = NeRF(cfg, g, device=cuda_device)
    pe = embed(torch.randn(5, 3, generator=g, device=cuda_device),
               cfg.multires, cfg.pi_bands)
    with torch.no_grad():
        p, x, v, v_div = fused_mlp.prepare(m, pe, None, cfg)
    with pytest.raises(ValueError, match="viewdirs"):
        fused_mlp.backward_cuda(p, x, v, v_div,
                                torch.zeros(5, 4, device=cuda_device))


@pytest.mark.parametrize("fold", [False, True])
def test_cuda_autograd_matches_cpu(cuda_device, fold):
    """Grads through ``fused_mlp.apply`` (the autograd function) on the
    card (both kernels) against the CPU (both plain versions)."""
    cfg = ModelConfig(netdepth=4, netwidth=64, skips=(2,), multires=6)
    m, pe, ve, cot = _inputs(cfg, fold, torch.float32, cuda_device)
    out = []
    for dev in (cuda_device, torch.device("cpu")):
        md = NeRF(cfg, torch.Generator(device=dev).manual_seed(0),
                  device=dev)
        md.load_state_dict(m.state_dict())
        x = pe.detach().to(dev).requires_grad_()
        v = ve.detach().to(dev).requires_grad_()
        raw = fused_mlp.apply(md, x, v, cfg, fold_heads=fold)
        (raw * cot.to(dev).reshape(raw.shape)).sum().backward()
        out.append([x.grad, v.grad] + [q.grad for q in md.parameters()])
    for i, (a, b) in enumerate(zip(*out)):
        _assert_rel_l2(a.cpu(), b, 1e-4, f"grad {i}")


@pytest.mark.parametrize("reduced", [True, False],
                         ids=["reduced_on", "reduced_off"])
def test_cuda_apply_mlp_bf16_matches_cpu(cuda_device, reduced):
    """The unfused bf16 MLP (``apply_mlp``: cuBLAS bf16 hidden layers) on
    the card against the CPU at the bf16 tolerance, 2e-2 x max(1,
    max|raw|), with cuBLAS allowed and not allowed to reduce bf16 sums in
    reduced precision; ``resolve_device`` turns it off."""
    from plnerf_torch.core.mlp import apply_mlp
    from plnerf_torch.device import resolve_device

    resolve_device(cuda_device)
    matmul = torch.backends.cuda.matmul
    assert not matmul.allow_bf16_reduced_precision_reduction
    cfg = ModelConfig()
    m, pe, ve, _ = _inputs(cfg, False, torch.float32, cuda_device, R=64,
                           S=64)
    mc = NeRF(cfg, torch.Generator().manual_seed(0), device="cpu")
    mc.load_state_dict({k: v.cpu() for k, v in m.state_dict().items()})
    matmul.allow_bf16_reduced_precision_reduction = reduced
    try:
        with torch.no_grad():
            ref = apply_mlp(mc, pe.cpu(), ve.cpu(), cfg, torch.bfloat16)
            got = apply_mlp(m, pe, ve, cfg, torch.bfloat16)
    finally:
        matmul.allow_bf16_reduced_precision_reduction = False
    ref, got = ref.float(), got.float().cpu()
    err = float((got - ref).abs().max())
    assert err <= 2e-2 * max(1.0, float(ref.abs().max())), err


# ------------------------------------------------ dot-walk probes --

PROBE_SHAPES = [(128, 256), (256, 256), (256, 384), (256, 128), (128, 128),
                (384, 256), (384, 128)]


def _probe_inputs(dev, k, shapes, rows=256):
    g = torch.Generator(device=dev).manual_seed(k + len(shapes))
    x = torch.randn(rows, k, generator=g, device=dev).to(torch.bfloat16)
    ws = [torch.randn(*s, generator=g, device=dev).to(torch.bfloat16) * 0.05
          for s in shapes]
    return x, ws


# name: (x width, weight shapes, kernel(x, ws, tile), plain(x, ws),
#        tolerance x max|ref|, row tiles)
PROBES = {
    **{f"shape_{k}x{n}": (k, [(k, n)] * 13, dot_probe.shape_cuda,
                          dot_probe.shape_plain, 1e-5, dot_probe.SHAPE_TILES)
       for k, n in PROBE_SHAPES},
    "mixed": (128, dot_probe.MIXED_SHAPES, dot_probe.mixed_cuda,
              dot_probe.mixed_plain, 2e-2, dot_probe.TILES),
    "merged_scratch": (128, dot_probe.MERGED_SHAPES, dot_probe.merged_cuda,
                       dot_probe.merged_plain, 2e-2, dot_probe.TILES),
    "merged_concat": (128, dot_probe.MERGED_SHAPES,
                      lambda x, ws, t: dot_probe.merged_cuda(x, ws, t, True),
                      dot_probe.merged_plain, 2e-2, dot_probe.CONCAT_TILES),
    **{f"mosaic_{v}": (256, [(256, 256)] * 13,
                       lambda x, ws, t, v=v: dot_probe.mosaic_cuda(x, ws, t,
                                                                   v),
                       lambda x, ws, v=v: dot_probe.mosaic_plain(x, ws, v),
                       1e-5 if v == "independent" else 2e-2,
                       dot_probe.mosaic_tiles(v))
       for v in dot_probe.VARIANTS},
}
PROBE_CASES = [(name, tile) for name, case in PROBES.items()
               for tile in case[5]]


def _hold_probe(name, tile, rows):
    k, shapes, kernel, plain, tol, _ = PROBES[name]
    x, ws = _probe_inputs(torch.device("cuda"), k, shapes, rows)
    key = name.split("_")[0]
    before = dot_probe.launches[key]
    got = kernel(x, ws, tile)
    again = kernel(x, ws, tile)
    torch.cuda.synchronize()
    assert dot_probe.launches[key] == before + 2
    ref = plain(x, ws)
    assert torch.equal(got, again)
    err = float((got - ref).abs().max())
    assert err <= tol * float(ref.abs().max()), err


@pytest.mark.parametrize("name,tile", PROBE_CASES,
                         ids=[f"{n}_t{t}" for n, t in PROBE_CASES])
def test_cuda_probe_matches_plain_and_repeats(cuda_device, name, tile):
    """Each probe kernel against its plain version at 256 rows, and two
    calls bit-identical (no atomics, a fixed summation order)."""
    _hold_probe(name, tile, 256)


# more CTAs than one wave on 132 SMs at every tile (one CTA per SM)
WAVE_ROWS = 256 * 140
WAVE_CASES = [(name, tile) for name in ("shape_256x256", "shape_384x128",
                                        "mixed", "merged_scratch",
                                        "merged_concat", "mosaic_chained",
                                        "mosaic_mlp", "mosaic_independent")
              for tile in PROBES[name][5]]


@pytest.mark.parametrize("name,tile", WAVE_CASES,
                         ids=[f"{n}_t{t}" for n, t in WAVE_CASES])
def test_cuda_probe_past_one_wave(cuda_device, name, tile):
    """The probes at 35,840 rows (140 to 560 CTAs): every CTA's rows, ring
    and barriers, against the plain version, twice."""
    _hold_probe(name, tile, WAVE_ROWS)


@pytest.mark.parametrize("name", list(PROBES))
def test_cuda_probe_refuses_ragged_rows_and_wrong_dtype(cuda_device, name):
    k, shapes, kernel, _, _, tiles = PROBES[name]
    x, ws = _probe_inputs(cuda_device, k, shapes, rows=tiles[0] * 3 + 32)
    with pytest.raises(ValueError, match="multiple of the row tile"):
        kernel(x, ws, tiles[0])
    x, ws = _probe_inputs(cuda_device, k, shapes)
    with pytest.raises(ValueError, match="bfloat16"):
        kernel(x.float(), ws, tiles[0])
    with pytest.raises(ValueError, match="bfloat16"):
        kernel(x, [w.half() for w in ws], tiles[0])


@pytest.mark.parametrize("walk", ["mixed", "merged"])
def test_cuda_walk_refuses_a_stream_of_the_wrong_length(cuda_device, walk):
    """The mixed and merged launchers take the stream's length and refuse
    any but the walk's (the kernel would read past it or stop short);
    the right length launches."""
    shapes = dot_probe.MIXED_SHAPES if walk == "mixed" else \
        dot_probe.MERGED_SHAPES
    x, ws = _probe_inputs(cuda_device, 128, shapes)
    w = dot_probe.pack_walk(ws, walk)
    out = torch.empty(x.shape[0], 256, device=cuda_device)
    lib = dot_probe._library()
    launch = lib.plnerf_probe_mixed if walk == "mixed" else \
        (lambda x_, w_, n, *rest: lib.plnerf_probe_merged(x_, w_, n, 0,
                                                          *rest))
    stream = torch.cuda.current_stream(cuda_device).cuda_stream
    for nbytes in (w.numel() * 2 - 8192, w.numel() * 2 + 16, 0):
        assert launch(x.data_ptr(), w.data_ptr(), nbytes, out.data_ptr(),
                      x.shape[0], 64, stream) != 0, nbytes
    assert launch(x.data_ptr(), w.data_ptr(), w.numel() * 2, out.data_ptr(),
                  x.shape[0], 64, stream) == 0
    torch.cuda.synchronize()
