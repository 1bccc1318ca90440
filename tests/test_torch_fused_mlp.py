"""The port's fused-MLP module (plnerf_torch/kernels/fused_mlp.py) against
the JAX package: the weight packing against ``_padded_weights``, the
plain PyTorch version of the kernel against the Pallas kernel in
interpret mode and against ``apply_mlp``, and (on a CUDA device only) the
hand-written kernel against the plain version."""
import dataclasses

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


def _sw64(n, k):
    """Element offset of B[n][k] in a K-major slab image of 32-value rows
    (64 bytes) in the wgmma 64-byte swizzle: byte address bits [4, 6) XOR
    bits [7, 9) (CUTLASS Swizzle<2, 4, 3>)."""
    addr = n * 64 + k * 2
    return (addr ^ (((addr >> 7) & 3) << 4)) // 2


def test_wgmma_stream_order():
    """bf16 blocks reach the wgmma kernel as one stream of shared-memory
    slab images: per product, column pass (the columns for raw only, then
    the columns kept on chip as one pass), block and 32-row k-slab, the
    slab's [32, NP] values transposed into NP rows of 32 in the 64-byte
    swizzle.  A permutation of the blocks; named elements land where the
    wgmma layout puts them."""
    p = fused_mlp.pack_weights(torch_model({}, np_params({})), ModelConfig(),
                               torch.bfloat16)
    ids, off = [], 0
    for w in p.weights:                         # every element its own id
        ids.append(torch.arange(off, off + w.numel(),
                                dtype=torch.float64).reshape(w.shape))
        off += w.numel()
    q = dataclasses.replace(p, weights=ids)
    flat = fused_mlp.wgmma_stream(q)
    assert torch.equal(flat.sort().values, torch.arange(off,
                                                        dtype=torch.float64))
    starts = np.cumsum([0] + [w.numel() for w in ids])
    w0, waf = ids[0], ids[-4]                   # [64, 256], [256, 288]
    for k, n in [(0, 0), (1, 5), (9, 2), (40, 130), (63, 255)]:
        pos = (k // 32) * 256 * 32 + _sw64(n, k % 32)   # one 256-wide pass
        assert flat[pos] == w0[k, n], (k, n)
    base = starts[len(ids) - 4]                 # Waf: the alpha pass first
    for k, n in [(0, 256), (37, 256), (255, 287), (100, 270)]:
        pos = base + (k // 32) * 32 * 32 + _sw64(n - 256, k % 32)
        assert flat[pos] == waf[k, n], (k, n)
    base += 256 * 32                            # then the 256 features
    for k, n in [(0, 0), (33, 7), (255, 255), (130, 64)]:
        pos = base + (k // 32) * 256 * 32 + _sw64(n, k % 32)
        assert flat[pos] == waf[k, n], (k, n)
    wbuf, bbuf = p.flat()
    assert wbuf.dtype == torch.bfloat16
    assert torch.equal(wbuf, fused_mlp.wgmma_stream(p))
    assert bbuf.numel() == sum(b.numel() for b in p.biases)


@pytest.mark.parametrize("head", ["split", "folded", "plain"])
def test_fp32_schedule_matches_pallas_interpret(head, monkeypatch):
    """The fp32 kernel's schedule in plain PyTorch (``forward_chunked``:
    the per-layer products over chunks of whole rays) against the Pallas
    kernel: 13 rays x 7 samples at ``FWD_CHUNK`` = 35 points, three chunks
    with a ragged last one, each reading its own view rows."""
    monkeypatch.setattr(fused_mlp, "FWD_CHUNK", 35)
    kw = dict(netdepth=4, netwidth=64, skips=(2,), multires=4,
              multires_views=2)
    if head == "plain":
        kw.update(use_viewdirs=False, output_ch=4)
    fold = head == "folded"
    params = np_params(kw)
    cfg, jcfg = ModelConfig(**kw), JModelConfig(**kw)
    R, S = 13, 7
    rng = np.random.default_rng(5)
    pe = rng.normal(size=(R, S, cfg.input_ch)).astype(np.float32)
    vch = cfg.input_ch_views + cfg.input_ch_cam
    ve = rng.normal(size=(R, 1, vch)).astype(np.float32)
    jve = (jnp.asarray(np.broadcast_to(ve, (R, S, vch)).reshape(-1, vch))
           if cfg.use_viewdirs else None)
    ref = np.asarray(jfused.apply(params, jnp.asarray(pe.reshape(R * S, -1)),
                                  jve, jcfg, tile=128, interpret=True,
                                  fold_heads=fold))
    with torch.no_grad():
        p, x, v, v_div = fused_mlp.prepare(
            torch_model(kw, params), t(pe),
            t(ve) if cfg.use_viewdirs else None, cfg, fold_heads=fold)
        assert v_div == (S if cfg.use_viewdirs else 1)
        assert fused_mlp.fwd_chunks(x.shape[0], v_div) == [
            (0, 35), (35, 35), (70, 21)]
        raw = fused_mlp.forward_chunked(p, x, v, v_div)
        got = mlp.softplus10_density(raw, cfg).numpy()
    np.testing.assert_allclose(got, ref, atol=2e-5, rtol=2e-5)


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
