"""The port's fused-MLP module (plnerf_torch/kernels/fused_mlp.py) against
the JAX package: the weight packing against ``_padded_weights``, the
plain PyTorch version of the kernel against the Pallas kernel in
interpret mode and against ``apply_mlp``, and (on a CUDA device only) the
hand-written kernel against the plain version."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from plnerf.core.config import ModelConfig as JModelConfig
from plnerf.kernels import fused_mlp as jfused
from plnerf_torch.core import mlp
from plnerf_torch.core.config import ModelConfig
from plnerf_torch.kernels import fused_mlp

from test_torch_mlp import (MODEL_CASES, j_apply_mlp, j_query, np_inputs,
                            np_params, t, torch_model)

torch.set_num_threads(1)


def _jax_blocks(kw, params, fold):
    """JAX packing with its 128-lane padding removed, in logical order."""
    cfg = JModelConfig(**kw)
    L = jfused.LANE
    in_ch, W = cfg.input_ch, cfg.netwidth
    vch = cfg.input_ch_views + cfg.input_ch_cam
    in_p, w_p, h_p = jfused._rup(in_ch), jfused._rup(W), jfused._rup(W // 2)
    v_p = jfused._rup(max(vch, 1))
    ts = [np.asarray(x, np.float32) for x in jfused._padded_weights(
        params, cfg, in_p, w_p, v_p, h_p, jnp.float32, fold_heads=fold)]
    return _canon(ts, cfg, fold, w_p, h_p, bias_2d=True), L


def _port_blocks(kw, params, fold):
    cfg = ModelConfig(**kw)
    p = fused_mlp.pack_weights(torch_model(kw, params), cfg, torch.float32,
                               fold)
    ts = []
    wi, bi = iter(p.weights), iter(p.biases)
    for i in range(p.n_layers):
        ts += [next(wi)] + ([next(wi)] if (p.skip_mask >> i) & 1 else [])
        ts.append(next(bi))
    rest_w, rest_b = list(wi), list(bi)
    if p.head == fused_mlp.SPLIT:
        ts += [rest_w[0], rest_b[0], rest_w[1], rest_w[2], rest_b[1],
               rest_w[3], rest_b[2]]
    elif p.head == fused_mlp.FOLDED:
        ts += [rest_w[0], rest_b[0], rest_w[1], rest_w[2], rest_b[1]]
    else:
        ts += [rest_w[0], rest_b[0]]
    ts = [x.numpy() for x in ts]
    return _canon(ts, cfg, fold, p.w_p, p.h_p, bias_2d=False), p


def _canon(ts, cfg, fold, w_p, h_p, bias_2d):
    """Unpadded blocks: pts layers, then the head blocks."""
    in_ch, W = cfg.input_ch, cfg.netwidth
    vch = cfg.input_ch_views + cfg.input_ch_cam
    b1 = (lambda b, n: b[0, :n]) if bias_2d else (lambda b, n: b[:n])
    bat = (lambda b, c: b[0, c]) if bias_2d else (lambda b, c: b[c])
    out, k = [], 0
    for i in range(cfg.netdepth):
        if (i - 1) in cfg.skips:
            out += [ts[k][:in_ch, :W], ts[k + 1][:W, :W], b1(ts[k + 2], W)]
            k += 3
        else:
            out += [ts[k][:in_ch if i == 0 else W, :W], b1(ts[k + 1], W)]
            k += 2
    H = W // 2
    if cfg.use_viewdirs and fold:
        wfa, bfa, wvv, wr, br = ts[k:k + 5]
        out += [wfa[:W, :H], wfa[:W, h_p], b1(bfa, H), bat(bfa, h_p),
                wvv[:vch, :H], wr[:H, :3], b1(br, 3)]
    elif cfg.use_viewdirs:
        waf, baf, wvf, wvv, bv, wr, br = ts[k:k + 7]
        out += [waf[:W, :W], waf[:W, w_p], b1(baf, W), bat(baf, w_p),
                wvf[:W, :H], wvv[:vch, :H], b1(bv, H), wr[:H, :3], b1(br, 3)]
    else:
        out += [ts[k][:W, :cfg.output_ch], b1(ts[k + 1], cfg.output_ch)]
    return out


@pytest.mark.parametrize("name", list(MODEL_CASES))
@pytest.mark.parametrize("fold", [False, True])
def test_packing_matches_jax_padded_weights(name, fold):
    kw = MODEL_CASES[name]
    params = np_params(kw)
    ref, _ = _jax_blocks(kw, params, fold)
    got, p = _port_blocks(kw, params, fold)
    assert len(got) == len(ref)
    for i, (a, b) in enumerate(zip(got, ref)):
        # the fold is an fp32 matmul summed in another order
        np.testing.assert_allclose(a, b, atol=1e-6, rtol=1e-6, err_msg=str(i))
    # K/N padded to the CUDA kernel's 32, not to 128 lanes; pads are zero
    assert p.in_p == -(-ModelConfig(**kw).input_ch // 32) * 32
    assert p.in_p % 32 == 0 and p.w_p % 32 == 0 and p.v_p % 32 == 0
    packed_abs = sum(float(np.abs(w.numpy()).sum()) for w in p.weights) + \
        sum(float(np.abs(b.numpy()).sum()) for b in p.biases)
    canon_abs = sum(float(np.abs(x).sum()) for x in got)
    assert packed_abs == pytest.approx(canon_abs, rel=1e-6)


def test_packing_pads_to_kernel_granularity():
    p = fused_mlp.pack_weights(torch_model({}, np_params({})), ModelConfig())
    assert (p.in_p, p.v_p, p.w_p, p.h_p) == (64, 32, 256, 128)
    assert p.skip_mask == 1 << 5
    assert [tuple(w.shape) for w in p.weights[-4:]] == [
        (256, 288), (256, 128), (32, 128), (128, 32)]


@pytest.mark.parametrize("name", list(MODEL_CASES))
@pytest.mark.parametrize("fold", [False, True])
def test_plain_version_matches_pallas_interpret(name, fold):
    kw = MODEL_CASES[name]
    params = np_params(kw)
    n = 61 if name == "full_8x256" else 97                 # odd N
    pe, ve = np_inputs(kw, n)
    jcfg = JModelConfig(**kw)
    jve = None if ve is None else jnp.asarray(ve)
    ref = np.asarray(jfused.apply(params, jnp.asarray(pe), jve, jcfg,
                                  tile=128, interpret=True, fold_heads=fold))
    ref_xla = np.asarray(j_apply_mlp(params, jnp.asarray(pe), jve, cfg=jcfg))
    with torch.no_grad():
        got = fused_mlp.apply(torch_model(kw, params), t(pe), t(ve),
                              ModelConfig(**kw), fold_heads=fold).numpy()
    np.testing.assert_allclose(got, ref, atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(got, ref_xla, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("fold", [False, True])
def test_plain_version_bf16_matches_pallas_interpret(fold):
    kw = dict(netdepth=4, netwidth=64, skips=(2,), multires=4,
              multires_views=2)
    params = np_params(kw)
    pe, ve = np_inputs(kw, 96)
    ref = np.asarray(jfused.apply(params, jnp.asarray(pe), jnp.asarray(ve),
                                  JModelConfig(**kw), jnp.bfloat16, tile=128,
                                  interpret=True, fold_heads=fold))
    with torch.no_grad():
        got = fused_mlp.apply(torch_model(kw, params), t(pe), t(ve),
                              ModelConfig(**kw), torch.bfloat16,
                              fold_heads=fold).numpy()
    np.testing.assert_allclose(got, ref, atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("fold", [False, True])
def test_fused_query_network_per_ray_views(fold):
    """[R, S] leading shape: the views reach the kernel's function per ray
    (samples-per-ray divisor) and match the JAX fused query."""
    kw = dict(netdepth=2, netwidth=32, multires=4, multires_views=2)
    params = np_params(kw)
    rng = np.random.default_rng(4)
    pts = rng.normal(size=(13, 7, 3)).astype(np.float32)
    vd = rng.normal(size=(13, 3)).astype(np.float32)
    vd /= np.linalg.norm(vd, axis=-1, keepdims=True)
    ref = np.asarray(j_query(
        params, jnp.asarray(pts), jnp.asarray(vd), cfg=JModelConfig(**kw),
        use_pallas=True, pallas_fold_heads=fold))
    m = torch_model(kw, params)
    cfg = ModelConfig(**kw)
    with torch.no_grad():
        p, x, v, v_div = fused_mlp.prepare(
            m, torch.zeros(13, 7, cfg.input_ch), torch.zeros(13, 1, 15), cfg)
        assert v_div == 7 and v.shape == (13, 32) and x.shape == (91, 32)
        got = mlp.query_network(m, t(pts), t(vd), cfg, use_fused=True,
                                fused_fold_heads=fold).numpy()
    assert got.shape == (13, 7, 4)
    np.testing.assert_allclose(got, ref, atol=2e-5, rtol=2e-5)


def test_mma_fragment_order():
    """bf16 blocks reach the tensor-core kernel in mma.sync m16n8k16
    B-fragment order: lane 4g + t of block (kb, nb) holds W[k0][n],
    W[k0+1][n], W[k0+8][n], W[k0+9][n], k0 = 16kb + 2t, n = 8nb + g."""
    K, N = 64, 96
    w = torch.arange(K * N, dtype=torch.float32).reshape(K, N)
    flat = fused_mlp.mma_fragments(w)
    assert sorted(flat.tolist()) == w.reshape(-1).tolist()   # a permutation
    for kb, nb, lane in [(0, 0, 0), (1, 2, 5), (3, 11, 31), (2, 7, 18)]:
        g, tq = lane // 4, lane % 4
        k0, n = 16 * kb + 2 * tq, 8 * nb + g
        base = ((kb * (N // 8) + nb) * 32 + lane) * 4
        assert flat[base:base + 4].tolist() == [
            w[k0, n], w[k0 + 1, n], w[k0 + 8, n], w[k0 + 9, n]]
    p = fused_mlp.pack_weights(torch_model({}, np_params({})), ModelConfig(),
                               torch.bfloat16)
    wbuf, bbuf = p.flat()
    assert wbuf.dtype == torch.bfloat16
    assert wbuf.numel() == sum(x.numel() for x in p.weights)
    assert torch.equal(wbuf[:p.weights[0].numel()],
                       fused_mlp.mma_fragments(p.weights[0]))


def test_forward_cuda_refuses_cpu_tensors():
    kw = dict(netdepth=2, netwidth=16, multires=4, multires_views=2)
    pe, ve = np_inputs(kw, 5)
    cfg = ModelConfig(**kw)
    p, x, v, v_div = fused_mlp.prepare(torch_model(kw, np_params(kw)),
                                       t(pe), t(ve), cfg)
    before = fused_mlp.launches
    with pytest.raises(ValueError, match="CUDA"):
        fused_mlp.forward_cuda(p, x, v, v_div)
    assert fused_mlp.launches == before
