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


def _hold_bwd(got, ref, tol):
    for name, a, b in zip(("dW", "db"), got[:2], ref[:2]):
        for i, (ga, gb) in enumerate(zip(a, b)):
            assert torch.isfinite(ga).all()
            _assert_rel_l2(ga, gb, tol, f"{name}[{i}]")
    _assert_rel_l2(got[2], ref[2], tol, "dx")
    _assert_rel_l2(got[3], ref[3], tol, "dv")


def _ring(p, dev):
    """(stages, wraps) of the bf16 data pass's weight ring: the stages
    that fit beside its tiles (csrc/fused_mlp_bwd.cu ``data_stages``) and
    the times its slabs (``_bwd_products``) refill it whole."""
    optin = torch.cuda.get_device_properties(dev).shared_memory_per_block_optin
    fixed = 1024 + 256 * (p.w_p + p.in_p + p.v_p) + (p.n_layers + 1) * 4096
    stages = min(8, (optin - fixed) // (16384 + 16))
    slabs = sum(sum(k for *_, k in terms) // 32
                for terms, _ in fused_mlp._bwd_products(p))
    return stages, slabs // stages


# (netdepth, netwidth, folded): 41 slabs through 8 stages, 167 and 152
# through 6 on the H100
RING_CASES = [(3, 128, False), (8, 256, False), (8, 256, True)]


@pytest.mark.parametrize("depth,width,fold", RING_CASES,
                         ids=["3x128_split", "8x256_split", "8x256_folded"])
def test_cuda_backward_bf16_ring_wraps_odd(cuda_device, depth, width, fold):
    """Layouts whose weight ring wraps an odd number of times (the
    mbarriers' parity flips on every wrap) against the plain version."""
    cfg = ModelConfig(netdepth=depth, netwidth=width)
    m, pe, ve, cot = _inputs(cfg, fold, torch.bfloat16, cuda_device, 9, 31)
    with torch.no_grad():
        p, x, v, v_div = fused_mlp.prepare(m, pe, ve, cfg, torch.bfloat16,
                                           fold)
        assert _ring(p, cuda_device)[1] % 2 == 1
        got = fused_mlp.backward_cuda(p, x, v, v_div, cot)
        torch.cuda.synchronize()
        ref = fused_mlp.backward_plain(p, x, v, v_div, cot)
    _hold_bwd(got, ref, 2e-2)


@pytest.mark.parametrize("fold", [False, True], ids=["split", "folded"])
def test_cuda_backward_bf16_deepest_layout(cuda_device, fold):
    """The deepest layout the kernel takes (16 layers of 256, three skip
    inputs): 17 mask slots leave room for a 4-stage ring only, so the
    second warpgroup's start behind the first is cut to what the ring
    holds (a lag the ring cannot hold deadlocks)."""
    cfg = ModelConfig(netdepth=16, netwidth=256, skips=(4, 8, 12))
    m, pe, ve, cot = _inputs(cfg, fold, torch.bfloat16, cuda_device, 5, 53)
    with torch.no_grad():
        p, x, v, v_div = fused_mlp.prepare(m, pe, ve, cfg, torch.bfloat16,
                                           fold)
        assert _ring(p, cuda_device)[0] == 4
        got = fused_mlp.backward_cuda(p, x, v, v_div, cot)
        torch.cuda.synchronize()
        ref = fused_mlp.backward_plain(p, x, v, v_div, cot)
    _hold_bwd(got, ref, 2e-2)


# n across the weight pass's chunks of row blocks: at most 5,632 points a
# chunk holds 256 (the smallest), so 1,281 puts one point in a sixth
# chunk; at 5,633 the chunks hold 320 points and the last one 193
@pytest.mark.parametrize("n", [1281, 5633])
@pytest.mark.parametrize("fold", [False, True], ids=["split", "folded"])
def test_cuda_backward_bf16_across_weight_chunks(cuda_device, fold, n):
    cfg = ModelConfig()
    m, pe, ve, cot = _inputs(cfg, fold, torch.bfloat16, cuda_device, n, 1)
    with torch.no_grad():
        p, x, v, v_div = fused_mlp.prepare(m, pe, ve, cfg, torch.bfloat16,
                                           fold)
        got = fused_mlp.backward_cuda(p, x, v, v_div, cot)
        torch.cuda.synchronize()
        ref = fused_mlp.backward_plain(p, x, v, v_div, cot)
    _hold_bwd(got, ref, 2e-2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("fold", [False, True], ids=["split", "folded"])
def test_cuda_backward_graph_replay_is_eager(cuda_device, fold, dtype):
    """The backward captured in a CUDA graph and replayed on new values of
    the same buffers: bit-equal to the eager call on those values; the
    capture and the replay count no launch."""
    cfg = ModelConfig()
    m, pe, ve, cot = _inputs(cfg, fold, dtype, cuda_device, 13, 71)
    with torch.no_grad():
        p, x, v, v_div = fused_mlp.prepare(m, pe, ve, cfg, dtype, fold)
        fused_mlp.backward_cuda(p, x, v, v_div, cot)   # build, index, pool
        torch.cuda.synchronize()
        before = fused_mlp.bwd_launches
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = fused_mlp.backward_cuda(p, x, v, v_div, cot)
        cot.copy_(torch.randn(cot.shape, device=cuda_device,
                              generator=torch.Generator(
                                  device=cuda_device).manual_seed(11)))
        graph.replay()
        torch.cuda.synchronize()
        assert fused_mlp.bwd_launches == before
        ref = fused_mlp.backward_cuda(p, x, v, v_div, cot)
    for a, b in zip(out[0] + out[1] + [out[2], out[3]],
                    ref[0] + ref[1] + [ref[2], ref[3]]):
        assert torch.equal(a, b)


def test_cuda_backward_refuses_a_stream_of_the_wrong_length(cuda_device,
                                                            monkeypatch):
    """A bf16 weight stream that does not match the kernel's walk is
    refused before any launch."""
    cfg = ModelConfig(netdepth=3, netwidth=64)
    m, pe, ve, cot = _inputs(cfg, False, torch.bfloat16, cuda_device, 3, 5)
    with torch.no_grad():
        p, x, v, v_div = fused_mlp.prepare(m, pe, ve, cfg, torch.bfloat16)

    full_stream = fused_mlp.bwd_stream

    def short_stream(q):
        return full_stream(q)[:-64 * 32]

    monkeypatch.setattr(fused_mlp, "bwd_stream", short_stream)
    before = fused_mlp.bwd_launches
    with torch.no_grad(), pytest.raises(ValueError, match="walk"):
        fused_mlp.backward_cuda(p, x, v, v_div, cot)
    assert fused_mlp.bwd_launches == before


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


# ----------------------------------- fp32 activations kept for the backward --

def _outputs(res):
    """Every tensor ``backward_cuda`` returns, in order."""
    return res[0] + res[1] + [res[2], res[3]]


# (config, rays, samples per ray = the views' row divisor): ragged point
# counts (4,097 and 21 x 192 = 4,032, neither a multiple of 128) with v_div
# 1 and 192, on the flagship 8x256 and on 6x64 with two skip inputs
SAVED_CASES = {f"{c}_{r}x{s}": (c, r, s)
               for c in ("full_folded", "skips_2_4_folded")
               for r, s in ((4097, 1), (21, 192))}


@pytest.mark.parametrize("fold", [False, True], ids=["split", "folded"])
@pytest.mark.parametrize("case", list(SAVED_CASES))
def test_cuda_backward_from_saved_acts_is_bit_equal(cuda_device, case, fold):
    """The fp32 forward with an activations buffer gives the raw it gives
    without one.  The backward reading those activations gives every
    packed dW / dB, dx and dv within 1e-4 relative L2 of the plain version
    and bit-equal to the standalone call, which runs that forward itself.
    One ``bwd_saved`` counted for the call given them, none for the
    other."""
    name, R, S = SAVED_CASES[case]
    cfg = ModelConfig(**CASES[name][0])
    m, pe, ve, cot = _inputs(cfg, fold, torch.float32, cuda_device, R, S)
    with torch.no_grad():
        p, x, v, v_div = fused_mlp.prepare(m, pe, ve, cfg, torch.float32,
                                           fold)
        assert v_div == S and x.shape[0] % 128
        acts = x.new_empty((x.shape[0], fused_mlp.acts_cols(p)))
        kept = fused_mlp.forward_cuda(p, x, v, v_div, acts)
        raw = fused_mlp.forward_cuda(p, x, v, v_div)
        before = fused_mlp.bwd_saved
        saved = fused_mlp.backward_cuda(p, x, v, v_div, cot, acts)
        torch.cuda.synchronize()
        assert fused_mlp.bwd_saved == before + 1
        recomputed = fused_mlp.backward_cuda(p, x, v, v_div, cot)
        torch.cuda.synchronize()
        assert fused_mlp.bwd_saved == before + 1
        ref = fused_mlp.backward_plain(p, x, v, v_div, cot)
    assert torch.equal(kept, raw)
    _hold_bwd(saved, ref, 1e-4)
    for i, (a, b) in enumerate(zip(_outputs(saved), _outputs(recomputed))):
        assert torch.equal(a, b), i


@pytest.mark.parametrize("fold", [False, True], ids=["split", "folded"])
def test_cuda_saved_acts_across_forward_chunks(cuda_device, fold,
                                               monkeypatch):
    """At 1,000 points per fp32 forward chunk (29 rays x 111 samples: 999,
    999, 999 and 222 points), each chunk writes its own rows of the one
    activations buffer: the same buffer, bit for bit, as one chunk writes,
    and a backward from it within 1e-4 relative L2 of the plain version."""
    cfg = ModelConfig()
    m, pe, ve, cot = _inputs(cfg, fold, torch.float32, cuda_device, 29, 111)
    with torch.no_grad():
        p, x, v, v_div = fused_mlp.prepare(m, pe, ve, cfg, torch.float32,
                                           fold)
        assert len(fused_mlp.fwd_chunks(x.shape[0], v_div)) == 1
        whole = x.new_empty((x.shape[0], fused_mlp.acts_cols(p)))
        fused_mlp.forward_cuda(p, x, v, v_div, whole)
        monkeypatch.setattr(fused_mlp, "FWD_CHUNK", 1000)
        assert len(fused_mlp.fwd_chunks(x.shape[0], v_div)) == 4
        acts = torch.full_like(whole, float("nan"))
        fused_mlp.forward_cuda(p, x, v, v_div, acts)
        saved = fused_mlp.backward_cuda(p, x, v, v_div, cot, acts)
        torch.cuda.synchronize()
        ref = fused_mlp.backward_plain(p, x, v, v_div, cot)
    assert torch.equal(acts, whole)
    _hold_bwd(saved, ref, 1e-4)


def test_cuda_saved_acts_refused_where_not_kept(cuda_device):
    """Only the fp32 viewdirs kernels keep and read activations: bf16 and
    a buffer of the wrong width or row count are refused before any
    launch."""
    cfg = ModelConfig(netdepth=3, netwidth=64)
    m, pe, ve, cot = _inputs(cfg, False, torch.bfloat16, cuda_device, 3, 5)
    with torch.no_grad():
        p, x, v, v_div = fused_mlp.prepare(m, pe, ve, cfg, torch.bfloat16)
        q, xf, vf, _ = fused_mlp.prepare(m, pe, ve, cfg, torch.float32)
    acts = torch.empty(15, fused_mlp.acts_cols(q), device=cuda_device)
    before = (fused_mlp.launches, fused_mlp.bwd_launches)
    with torch.no_grad():
        with pytest.raises(ValueError, match="fp32"):
            fused_mlp.forward_cuda(p, x, v, v_div, acts)
        with pytest.raises(ValueError, match="fp32"):
            fused_mlp.backward_cuda(p, x, v, v_div, cot, acts)
        with pytest.raises(ValueError, match="acts"):
            fused_mlp.forward_cuda(q, xf, vf, v_div, acts[:, :-32])
        with pytest.raises(ValueError, match="acts"):
            fused_mlp.backward_cuda(q, xf, vf, v_div, cot,
                                    acts[:, :-32].contiguous())
        with pytest.raises(ValueError, match="acts"):
            fused_mlp.backward_cuda(q, xf, vf, v_div, cot, acts[:-1])
    assert (fused_mlp.launches, fused_mlp.bwd_launches) == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_cuda_fused_function_counts_saved_backwards(cuda_device, dtype):
    """A ``FusedMLPFunction`` step raises ``bwd_saved`` by one per fp32
    backward and by none for bf16, which recomputes on chip; both run one
    backward launch."""
    cfg = ModelConfig(netdepth=4, netwidth=64, skips=(2,), multires=6)
    m, pe, ve, cot = _inputs(cfg, True, torch.float32, cuda_device)
    x = pe.detach().requires_grad_()
    before = (fused_mlp.bwd_launches, fused_mlp.bwd_saved)
    raw = fused_mlp.apply(m, x, ve, cfg, dtype, fold_heads=True)
    (raw * cot.reshape(raw.shape)).sum().backward()
    torch.cuda.synchronize()
    assert fused_mlp.bwd_launches == before[0] + 1
    assert fused_mlp.bwd_saved == before[1] + (dtype == torch.float32)
    assert torch.isfinite(x.grad).all()


@pytest.mark.parametrize("fold", [False, True], ids=["split", "folded"])
def test_cuda_remat_grads_equal_the_plain_step(cuda_device, fold):
    """``remat_mlp`` (``torch.utils.checkpoint``) drops what the fp32
    forward keeps and reruns it in the backward, whose data pass then
    reads the rerun's activations: loss and every grad of both networks
    equal the plain step's, bit for bit."""
    from plnerf_torch.core.config import RenderConfig
    from plnerf_torch.train import step as tstep

    dev = cuda_device
    mcfg = ModelConfig(netdepth=4, netwidth=64, skips=(2,), multires=6,
                       multires_views=2)
    g = torch.Generator(device=dev).manual_seed(3)
    o = torch.nn.functional.normalize(
        torch.randn(64, 3, generator=g, device=dev), dim=-1) * 4.0
    d = -o / 4.0 + 0.1 * torch.randn(64, 3, generator=g, device=dev)
    rays = torch.cat([o, d, torch.full((64, 1), 2.0, device=dev),
                      torch.full((64, 1), 6.0, device=dev),
                      torch.nn.functional.normalize(d, dim=-1)], -1)
    batch = {"rays": rays, "target": torch.rand(64, 3, generator=g,
                                                device=dev)}
    out = []
    for remat in (False, True):
        setup = tstep.TrainSetup(mcfg=mcfg, rcfg=RenderConfig(
            n_samples=32, n_importance=32, mode="linear", white_bkgd=True,
            perturb=False, use_fused_mlp=True, fused_fold_heads=fold,
            remat_mlp=remat))
        models = [NeRF(mcfg, torch.Generator(device=dev).manual_seed(s),
                       device=dev) for s in (0, 1)]
        before = fused_mlp.bwd_saved
        loss, _ = tstep._render_loss(*models, batch, None, setup)
        loss.backward()
        torch.cuda.synchronize()
        assert fused_mlp.bwd_saved == before + 2
        out.append((loss.detach(), [q.grad for mm in models
                                    for q in mm.parameters()]))
    assert torch.equal(out[0][0], out[1][0])
    for i, (a, b) in enumerate(zip(out[0][1], out[1][1])):
        assert torch.equal(a, b), i


@pytest.mark.parametrize("packed", [False, True], ids=["apply", "packed_net"])
def test_cuda_inference_allocates_no_acts(cuda_device, packed):
    """An fp32 forward of a 32,768-ray chunk (64 samples, 2^21 points, one
    forward chunk) without gradients, through ``apply`` and through a
    ``PackedNet``, peaks at the ping-pong workspace, raw and the padded
    inputs: no [N, acts_cols] buffer (17 GiB here) is allocated."""
    cfg = ModelConfig()
    R, S = 32768, 64
    g = torch.Generator(device=cuda_device).manual_seed(0)
    m = NeRF(cfg, g, device=cuda_device)
    pe = embed(torch.randn(R, S, 3, generator=g, device=cuda_device),
               cfg.multires, cfg.pi_bands)
    ve = embed(torch.nn.functional.normalize(
        torch.randn(R, 3, generator=g, device=cuda_device), dim=-1),
        cfg.multires_views, cfg.pi_bands)[:, None, :]
    net = fused_mlp.PackedNet(m, cfg, torch.float32, True) if packed else m
    n = R * S
    p = fused_mlp.pack_weights(m, cfg, torch.float32, True)
    ws = fused_mlp._library().plnerf_fused_mlp_fwd_workspace(n, p.w_p, 0)
    assert ws == 2 * n * p.w_p * 4
    # the workspace, raw and the density's softplus beside it, the padded
    # x and views, the packed weights (a few MB)
    bound = ws + 3 * n * 16 + n * p.in_p * 4 + R * p.v_p * 4 + (64 << 20)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(cuda_device)
    base = torch.cuda.memory_allocated(cuda_device)
    with torch.no_grad():
        raw = fused_mlp.apply(net, pe, ve, cfg, torch.float32,
                              fold_heads=True)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(cuda_device) - base
    assert raw.shape == (R, S, 4)
    assert peak <= bound < n * fused_mlp.acts_cols(p) * 4, (peak, bound)


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


SYNC_FREE = {
    "nvs_fp32": dict(), "nvs_bf16": dict(mlp_dtype="bfloat16"),
    "vanilla": dict(vanilla=True), "pool": dict(pool=True),
    "occ_bf16": dict(occ=True, mlp_dtype="bfloat16"),
    "depth": dict(depth=True), "depth_occ": dict(depth=True, occ=True)}


@pytest.mark.parametrize("flavour", list(SYNC_FREE))
def test_cuda_train_step_never_waits_on_the_card(cuda_device, flavour):
    """A train step of each flavour the drivers run (folded-head kernels;
    the two Adams, the joint Adam, a pool slice, the grid, the depth step
    with camera embeddings), its batch made as the drivers make it, under
    ``torch.cuda.set_sync_debug_mode("error")``: the host reads nothing
    back, so it raises nothing.  One step runs first (the kernels build,
    the optimizers make their state); the bf16 weight stream's index,
    kept per layout, is made again under the check."""
    import numpy as np

    from plnerf_torch.cli.run_depth import depth_batch
    from plnerf_torch.core import occgrid
    from plnerf_torch.core.config import RenderConfig
    from plnerf_torch.data.synthetic import make_sphere_dataset
    from plnerf_torch.train import batching
    from plnerf_torch.train.step import (TrainSetup, apply_occ_update,
                                         init_state, make_depth_train_step,
                                         make_occ_train_step,
                                         make_train_step)

    kw = SYNC_FREE[flavour]
    dev = cuda_device
    depth = kw.get("depth", False)
    mcfg = ModelConfig(netdepth=4, netwidth=64, skips=(2,), multires=6,
                       multires_views=2, pi_bands=depth,
                       input_ch_cam=3 if depth else 0)
    occ = occgrid.OccGridConfig(resolution=16, candidates=32) \
        if kw.get("occ") else None
    rcfg = RenderConfig(n_samples=16, n_importance=16, white_bkgd=True,
                        perturb=True, raw_noise_std=1.0,
                        mlp_dtype=kw.get("mlp_dtype", "float32"),
                        use_fused_mlp=True, fused_fold_heads=True, occ=occ,
                        compute_pred_hyp=depth, trim_first_weight=depth)
    setup = TrainSetup(mcfg=mcfg, rcfg=rcfg, lrate=5e-3,
                       joint_optimizer=kw.get("vanilla", False) or depth,
                       grad_clip_value=0.1 if depth else None,
                       space_carving_weight=0.007 if depth else 0.0,
                       freeze_ss=1, opt_ch_cam=depth)
    images, poses, _, K = make_sphere_dataset(4, 32, 32)
    images = torch.as_tensor(images, device=dev)
    poses = torch.as_tensor(poses[:, :3, :4], device=dev)
    K = torch.as_tensor(K, device=dev)
    i_train = torch.arange(4, device=dev)
    pool = torch.as_tensor(batching.build_ray_pool(
        images.cpu().numpy(), poses.cpu().numpy(), K.cpu().numpy(),
        range(4)), device=dev)
    intr = torch.stack([K[0, 0], K[1, 1], K[0, 2], K[1, 2]]).expand(
        4, 4).contiguous()
    depths = torch.full((4, 32, 32), 4.0, device=dev)
    mask = torch.ones(4, 32, 32, device=dev)
    state = init_state(torch.Generator(device=dev).manual_seed(0), setup,
                       dev, n_images=4 if depth else 0)
    grid = occgrid.init_grid([-1.5] * 3, [1.5] * 3, occ, dev) \
        if occ else None
    step = (make_depth_train_step(setup) if depth else
            make_occ_train_step(setup) if occ else make_train_step(setup))
    g = torch.Generator(device=dev).manual_seed(1)

    def one(k):
        nonlocal state, grid
        if depth:
            batch = depth_batch(images, poses, intr, depths, mask, k % 4, 64,
                                2.0, 6.0, True, g)
            if occ:
                state, m = step(state, dict(batch, occ_grid=grid), g)
                grid, m = apply_occ_update(setup, grid, batch, m)
            else:
                state, m = step(state, batch, g)
            return m
        if kw.get("pool"):
            rays, target = batching.pool_batch(pool, 64 * k, 64, 2.0, 6.0,
                                               True)
        else:
            rays, target, _ = batching.sample_one_image_batch(
                images, poses, K, i_train, g, 64, 2.0, 6.0, True)
        batch = {"rays": rays, "target": target}
        if occ:
            state, grid, m = step(state, grid, batch, g)
        else:
            state, m = step(state, batch, g)
        return m

    one(0)
    torch.cuda.synchronize()
    # the bf16 weight stream's index is built again, inside the check
    fused_mlp._STREAM_INDEX.clear()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for k in range(1, 4):
            m = one(k)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert all(np.isfinite(float(v)) for k, v in m.items()
               if not k.startswith("_"))
    assert state.step == 4


# ---------------------------------------------------------------------------
# a window of steps as one CUDA graph (train/graph.py)
# ---------------------------------------------------------------------------

GRAPH_N = 4
GRAPH_FLAVOURS = {"sampled": dict(), "pool": dict(pool=True),
                  "occ": dict(occ=True, mlp_dtype="bfloat16"),
                  "depth": dict(depth=True)}
# the flavours captured under a data-parallel mesh: the NVS step in bf16,
# the grid's (its observations max-reduced) and the depth step with the
# joint space-carving term (its ray means summed over the ranks, forward
# and backward)
MESH_FLAVOURS = {"nvs_bf16": dict(mlp_dtype="bfloat16"),
                 "occ_bf16": GRAPH_FLAVOURS["occ"],
                 "depth_joint": dict(depth=True, joint=True)}


def _graph_run(dev, flavour, capture, keys="vvv", debug_after=None,
               trace_from=None, mesh=None):
    """One window of GRAPH_N steps of ``flavour`` per item of ``keys``
    (its variant: ``v``, or ``w``, the same step without the raw noise)
    through ``graph.Graphs`` (``capture`` False: every window eager), the
    batches made on the card from the staged feed as the drivers make
    them, or from the host's values in an eager window; ``mesh``: the
    steps of this rank's share of the batch, their collectives inside
    the windows.  Returns (state, grid, metrics, graphs, counts): the
    windows from ``debug_after`` on run (and stage) under
    ``set_sync_debug_mode("error")``, those from ``trace_from`` on under
    ``torch.profiler``, whose trace's fused kernels ``counts`` counts
    (``utils/profile.trace_kernel_counts``)."""
    import dataclasses
    import json
    import os
    import tempfile

    from plnerf_torch.cli.run_depth import depth_batch
    from plnerf_torch.core import occgrid
    from plnerf_torch.core.config import RenderConfig
    from plnerf_torch.data.synthetic import make_sphere_dataset
    from plnerf_torch.train import batching, graph
    from plnerf_torch.train.step import (TrainSetup, init_state,
                                         make_multi_train_step,
                                         stage_window, window_counters)
    from plnerf_torch.utils import profile as uprofile

    kw = {**GRAPH_FLAVOURS, **MESH_FLAVOURS}[flavour]
    depth, joint = kw.get("depth", False), kw.get("joint", False)
    mcfg = ModelConfig(netdepth=4, netwidth=64, skips=(2,), multires=6,
                       multires_views=2, pi_bands=depth,
                       input_ch_cam=3 if depth else 0)
    occ = occgrid.OccGridConfig(resolution=16, candidates=32) \
        if kw.get("occ") else None
    rcfg = RenderConfig(n_samples=16, n_importance=16, white_bkgd=True,
                        perturb=True, raw_noise_std=0.0 if depth else 1.0,
                        mlp_dtype=kw.get("mlp_dtype", "float32"),
                        use_fused_mlp=True, fused_fold_heads=True, occ=occ,
                        compute_pred_hyp=depth, trim_first_weight=depth,
                        is_joint=joint)
    # depth: the warm start ends at step 2 and the freeze at step 5, both
    # inside a window
    setup = TrainSetup(mcfg=mcfg, rcfg=rcfg, lrate=5e-3, lrate_decay=1,
                       joint_optimizer=depth,
                       grad_clip_value=0.1 if depth else None,
                       space_carving_weight=0.007 if depth else 0.0,
                       is_joint=joint, warm_start_nerf=2, freeze_ss=6,
                       scaleshift_lr=1e-3, opt_ch_cam=depth)
    images, poses, _, K = make_sphere_dataset(4, 32, 32)
    images = torch.as_tensor(images, device=dev)
    poses = torch.as_tensor(poses[:, :3, :4], device=dev)
    K = torch.as_tensor(K, device=dev)
    i_train = torch.arange(4, device=dev)
    pool = torch.as_tensor(batching.build_ray_pool(
        images.cpu().numpy(), poses.cpu().numpy(), K.cpu().numpy(),
        range(4)), device=dev)
    intr = torch.stack([K[0, 0], K[1, 1], K[0, 2], K[1, 2]]).expand(
        4, 4).contiguous()
    depths = torch.full((4, 32, 32), 4.0, device=dev)
    mask = torch.ones(4, 32, 32, device=dev)
    state = init_state(torch.Generator(device=dev).manual_seed(0), setup,
                       dev, n_images=4 if depth else 0)
    grid = occgrid.init_grid([-1.5] * 3, [1.5] * 3, occ, dev) \
        if occ else None
    g = torch.Generator(device=dev).manual_seed(1)
    multis = {"v": make_multi_train_step(setup, GRAPH_N, mesh, depth),
              "w": make_multi_train_step(dataclasses.replace(
                  setup, rcfg=dataclasses.replace(rcfg, raw_noise_std=0.0)),
                  GRAPH_N, mesh, depth)}
    feed = graph.Feed(GRAPH_N, dev, len(state.optimizers()))
    graphs = graph.Graphs(dev, GRAPH_N, window_counters(state), [g],
                          capture=capture)
    offsets = imgs = None

    def batch_of(k):
        if depth:
            return depth_batch(images, poses, intr, depths, mask, imgs[k],
                               64, 2.0, 6.0, True, g)
        if kw.get("pool"):
            rays, target = batching.pool_batch(pool, offsets[k], 64, 2.0,
                                               6.0, True)
        else:
            rays, target, _ = batching.sample_one_image_batch(
                images, poses, K, i_train, g, 64, 2.0, 6.0, True)
        return {"rays": rays, "target": target}

    m, prof = None, None
    for w, key in enumerate(keys):
        if w == trace_from:
            prof = uprofile.start_trace(dev)
        if w == debug_after:
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
        try:
            s0 = state.step
            offsets = [64 * (s0 + k) for k in range(GRAPH_N)]
            imgs = [(3 * (s0 + k)) % 4 for k in range(GRAPH_N)]
            staged = graphs.schedule(key, GRAPH_N) in graph.STAGED
            if staged:
                stage_window(feed, state, GRAPH_N, offset=offsets, img=imgs)
                offsets, imgs = feed.row("offset"), feed.row("img")
            multi = multis[key]
            m = graphs.run(key, lambda n: multi.window(
                state, n, batch_of, g, feed if staged else None, grid),
                GRAPH_N)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    counts = None
    if prof is not None:
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            uprofile.end_trace(prof, dev)
            prof.export_chrome_trace(path)
            with open(path) as f:
                counts = uprofile.trace_kernel_counts(json.load(f))
    return state, grid, m, graphs, counts


def _same(x, y, where):
    if isinstance(x, torch.Tensor):
        assert torch.equal(x, y), where
    elif isinstance(x, dict):
        assert set(x) == set(y), where
        for k in x:
            _same(x[k], y[k], f"{where}/{k}")
    elif isinstance(x, (tuple, list)):
        assert len(x) == len(y), where
        for i, (a, b) in enumerate(zip(x, y)):
            _same(a, b, f"{where}/{i}")
    else:
        assert x == y, where


@pytest.mark.parametrize("flavour", list(GRAPH_FLAVOURS))
def test_cuda_replayed_window_is_eager_steps(cuda_device, flavour):
    """Four windows of 4: the first eager on the capture stream, the
    second captured and replayed, the third replayed (staged and run
    under ``set_sync_debug_mode("error")``), the fourth replayed under
    the profiler; against the same windows run eagerly: the state, the
    grid and the last metrics bit for bit.  The wrappers count the first
    window's launches only (a capture and a replay launch nothing from
    Python), 2 + 2 a step eagerly; the traced replay ran the fused
    kernels of the traced eager window, one backward (``weight_kernel``)
    per network a step."""
    fused_mlp.launches = fused_mlp.bwd_launches = 0
    a, ga, ma, graphs, counts = _graph_run(
        cuda_device, flavour, True, keys="vvvv", debug_after=2,
        trace_from=3)
    assert (fused_mlp.launches, fused_mlp.bwd_launches) == (2 * GRAPH_N,
                                                            2 * GRAPH_N)
    assert [k for _, _, k in graphs.windows()] == ["first", "capture",
                                                   "replay", "replay"]
    assert (graphs.captures, graphs.replays) == (1, 3)
    fused_mlp.launches = fused_mlp.bwd_launches = 0
    b, gb, mb, _, eager_counts = _graph_run(cuda_device, flavour, False,
                                            keys="vvvv", trace_from=3)
    assert (fused_mlp.launches, fused_mlp.bwd_launches) == (
        2 * 4 * GRAPH_N, 2 * 4 * GRAPH_N)
    assert counts == eager_counts and counts["weight_kernel"] == 2 * GRAPH_N
    assert a.step == b.step == 4 * GRAPH_N
    _same(a.state_dict(), b.state_dict(), "state")
    if ga is not None:
        _same(ga, gb, "grid")
    _same(ma, mb, "metrics")


@pytest.fixture
def nccl_mesh(cuda_device, tmp_path):
    """A data-parallel mesh of one rank in this process: an NCCL group of
    world size 1 (a ``file://`` rendezvous), destroyed after the test."""
    import torch.distributed as dist

    from plnerf_torch.parallel import mesh as pmesh

    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/rdv",
                            rank=0, world_size=1, device_id=torch.device(
                                "cuda", torch.cuda.current_device()))
    try:
        yield pmesh.make_mesh("cuda")
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("flavour", list(MESH_FLAVOURS))
def test_cuda_data_parallel_window_is_captured(nccl_mesh, flavour):
    """Under an NCCL mesh of one rank, four windows of 4 through
    ``graph.Graphs`` as the drivers run them under ``torchrun``: the first
    eager, the second captured with its collectives and replayed, the
    third and fourth replayed, the third under
    ``set_sync_debug_mode("error")``.  The state, the grid and the last
    metrics equal bit for bit the same windows run eagerly under the mesh
    and the same windows replayed without one."""
    dev = nccl_mesh.device
    a, ga, ma, graphs, _ = _graph_run(dev, flavour, True, keys="vvvv",
                                      debug_after=2, mesh=nccl_mesh)
    assert [k for _, _, k in graphs.windows()] == ["first", "capture",
                                                   "replay", "replay"]
    assert (graphs.captures, graphs.replays) == (1, 3)
    b, gb, mb, _, _ = _graph_run(dev, flavour, False, keys="vvvv",
                                 mesh=nccl_mesh)
    c, gc, mc, _, _ = _graph_run(dev, flavour, True, keys="vvvv")
    for other, grid, m in ((b, gb, mb), (c, gc, mc)):
        assert a.step == other.step == 4 * GRAPH_N
        _same(a.state_dict(), other.state_dict(), "state")
        if ga is not None:
            _same(ga, grid, "grid")
        _same(ma, m, "metrics")


def _two_rank_windows(rank, rdv, out, flavour):
    import torch.distributed as dist

    from plnerf_torch.parallel import mesh as pmesh

    dev = torch.device("cuda", rank)
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", init_method=rdv, rank=rank, world_size=2,
                            device_id=dev)
    try:
        mesh = pmesh.make_mesh("cuda")
        a, ga, ma, graphs, _ = _graph_run(dev, flavour, True, keys="vvvv",
                                          debug_after=2, mesh=mesh)
        b, gb, mb, _, _ = _graph_run(dev, flavour, False, keys="vvvv",
                                     mesh=mesh)
        res = {"replayed": (a.state_dict(), ga, ma),
               "eager": (b.state_dict(), gb, mb),
               "plan": graphs.windows()}
        torch.save(res, f"{out}.{rank}.pt")
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("flavour", list(MESH_FLAVOURS))
def test_cuda_two_rank_windows_are_captured(cuda_device, tmp_path, flavour):
    """Two ranks on two cards (skipped on fewer): each rank's replayed
    windows, their all-reduces inside, bit-equal to its eager ones, and
    both ranks holding the same state."""
    import torch.multiprocessing as mp

    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices: one rank per card")
    out = str(tmp_path / "w2")
    mp.spawn(_two_rank_windows, args=(f"file://{tmp_path}/rdv", out,
                                      flavour), nprocs=2)
    ranks = [torch.load(f"{out}.{r}.pt", map_location="cpu",
                        weights_only=False) for r in (0, 1)]
    for res in ranks:
        assert [k for _, _, k in res["plan"]] == ["first", "capture",
                                                  "replay", "replay"]
        _same(res["replayed"], res["eager"], "replayed vs eager")
    _same(ranks[0]["replayed"], ranks[1]["replayed"], "rank 0 vs 1")


def test_cuda_returning_variant_is_captured_anew(cuda_device):
    """Two variants sharing the graphs' pool, the first coming back after
    the second was captured (the occupancy advisory's fallback): it is
    captured anew, and the run is bit-equal to the same windows run
    eagerly."""
    keys = "vvvwwwvv"
    a, _, ma, graphs, _ = _graph_run(cuda_device, "sampled", True, keys)
    assert [k for _, _, k in graphs.windows()] == [
        "first", "capture", "replay", "first", "capture", "replay",
        "capture", "replay"]
    assert (graphs.captures, graphs.replays) == (3, 6)
    b, _, mb, _, _ = _graph_run(cuda_device, "sampled", False, keys)
    _same(a.state_dict(), b.state_dict(), "state")
    _same(ma, mb, "metrics")


def test_cuda_device_steps_survive_save_and_load(cuda_device, tmp_path):
    """The card's Adam is capturable: its steps live on the card and its
    rate is a device tensor.  A checkpoint, a reference ``.tar`` and
    optax's moments load the steps there; a checkpoint saved again is the
    same file."""
    import numpy as np

    from plnerf_torch.checkpoint import convert_jax, convert_torch
    from plnerf_torch.checkpoint import io as ckio

    def on_card(state, count):
        for o in state.optimizers():
            assert o.count == count and isinstance(
                o.param_groups[0]["lr"], torch.Tensor)
            assert o.state and all(
                s["step"].dtype == torch.float32 and s["step"].is_cuda
                and float(s["step"]) == count for s in o.state.values())

    a, _, _, _, _ = _graph_run(cuda_device, "depth", False, keys="v")
    on_card(a, GRAPH_N)
    path = ckio.save_checkpoint(str(tmp_path), a.step, a.state_dict())
    fresh, _, _, _, _ = _graph_run(cuda_device, "depth", False, keys="")
    back = ckio.restore_checkpoint(path, fresh, cuda_device)
    on_card(back, GRAPH_N)
    _same(back.state_dict(), a.state_dict(), "state")
    again = ckio.save_checkpoint(str(tmp_path / "again"), back.step,
                                 back.state_dict())
    _same(torch.load(again, weights_only=True),
          torch.load(path, weights_only=True), "file")

    n, _, _, _, _ = _graph_run(cuda_device, "sampled", False, keys="v")
    sd = n.state_dict()
    tar = str(tmp_path / "ref.tar")
    kind = convert_torch.save_reference_checkpoint(
        tar, n.step, sd["params_coarse"], sd["params_fine"],
        fine_adam=convert_torch.adam_moments(sd["opt_fine"],
                                             [sd["params_fine"]]))
    assert kind == "real Adam moments"
    nfresh, _, _, _, _ = _graph_run(cuda_device, "sampled", False, keys="")
    back = ckio.restore_checkpoint(tar, nfresh, cuda_device)
    assert back.step == GRAPH_N and back.opt_fine.count == GRAPH_N
    assert all(float(s["step"]) == GRAPH_N and s["step"].is_cuda
               for s in back.opt_fine.state.values())

    opt = fresh.opt_ss
    convert_jax.load_adam_state(opt, [np.zeros((4, 1))] * 2,
                                [np.ones((4, 1))] * 2, 5)
    assert opt.count == 5 and all(
        float(s["step"]) == 5 and s["step"].is_cuda
        for s in opt.state.values())


def test_cuda_capture_of_a_host_read_raises():
    """A window body that reads a value on the host cannot be captured:
    ``Graphs`` raises (in a process of its own, since a failed capture
    leaves the allocator mid-capture) and never runs it eagerly
    instead."""
    import os
    import subprocess
    import sys

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs have no CPU mode "
                    "(python3 chip_smoke.py runs them on the H100)")
    code = (
        "import torch\n"
        "from plnerf_torch.train import graph\n"
        "dev = torch.device('cuda')\n"
        "x = torch.ones(8, device=dev)\n"
        "def body(n):\n"
        "    y = x * 2\n"
        "    if float(y.sum()) > 0:\n"
        "        y = y + 1\n"
        "    return {'y': y.sum()}\n"
        "g = graph.Graphs(dev, 2)\n"
        "g.run('k', body, 2)\n"
        "try:\n"
        "    g.run('k', body, 2)\n"
        "except RuntimeError as e:\n"
        "    print('RAISED', g.replays)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=os.path.dirname(
                             os.path.dirname(os.path.abspath(__file__))))
    # torch's AcceleratorError is a RuntimeError
    assert "RAISED 0" in out.stdout, out.stdout + out.stderr
