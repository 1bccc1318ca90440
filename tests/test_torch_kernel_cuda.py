"""The hand-written CUDA kernels (plnerf_torch/kernels/csrc/fused_mlp_fwd.cu
and fused_mlp_bwd.cu) against their plain PyTorch versions, on a CUDA
device only.

This file imports neither JAX nor ``plnerf``, so it also runs on a machine
with a card and no JAX: ``python -m pytest --noconftest
tests/test_torch_kernel_cuda.py``.  Without a card every test skips."""
import pytest
import torch

from plnerf_torch.core.config import ModelConfig
from plnerf_torch.core.encoding import embed
from plnerf_torch.core.mlp import NeRF
from plnerf_torch.kernels import fused_mlp

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


@pytest.mark.parametrize("fold", [False, True])
def test_cuda_backward_is_deterministic(cuda_device, fold):
    """No floating-point atomics: two calls give bit-identical grads."""
    cfg = ModelConfig()
    m, pe, ve, cot = _inputs(cfg, fold, torch.float32, cuda_device, 64, 97)
    with torch.no_grad():
        p, x, v, v_div = fused_mlp.prepare(m, pe, ve, cfg, torch.float32,
                                           fold)
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
