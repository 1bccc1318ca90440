"""The hand-written CUDA kernel (plnerf_torch/kernels/csrc/fused_mlp_fwd.cu)
against its plain PyTorch version, on a CUDA device only.

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
