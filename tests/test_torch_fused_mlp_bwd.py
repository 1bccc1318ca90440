"""Gradients through the port's fused MLP (plnerf_torch/kernels/fused_mlp.py
``apply``: the autograd function, ``backward_plain`` on the CPU, the
unpad/unfold of the packed grads) against ``jax.grad`` through the JAX
package's ``fused_mlp.apply`` with ``interpret=True``, which runs the
Pallas ``_bwd_kernel`` in interpret mode.  Weights, inputs and the
cotangent of raw are made with numpy from a seed."""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from plnerf.core.config import ModelConfig as JModelConfig
from plnerf.kernels import fused_mlp as jfused
from plnerf_torch.checkpoint import convert_jax
from plnerf_torch.core import mlp
from plnerf_torch.core.config import ModelConfig
from plnerf_torch.kernels import fused_mlp

from test_torch_mlp import MODEL_CASES, np_inputs, np_params, t, torch_model

torch.set_num_threads(1)

F32_TOL = 1e-4


def _jax_grads(kw, params, pe, ve, cot, fold, dtype=jnp.float32):
    """(param grads as a NeRF state dict, d pts, d views) of sum(raw * cot)
    through the Pallas kernels in interpret mode."""
    cfg = JModelConfig(**kw)

    def loss(p, x, v):
        raw = jfused.apply(p, x, v, cfg, dtype, tile=128, interpret=True,
                           fold_heads=fold)
        return jnp.sum(raw.astype(jnp.float32) * cot)

    jve = None if ve is None else jnp.asarray(ve)
    argnums = (0, 1) if ve is None else (0, 1, 2)
    grads = jax.grad(loss, argnums=argnums)(params, jnp.asarray(pe), jve)
    gp = convert_jax.params_to_state_dict(
        jax.tree.map(np.asarray, grads[0]))
    return gp, np.asarray(grads[1]), (None if ve is None
                                      else np.asarray(grads[2]))


def _port_grads(kw, params, pe, ve, cot, fold, dtype=torch.float32):
    m = torch_model(kw, params)
    x = t(pe).requires_grad_()
    v = None if ve is None else t(ve).requires_grad_()
    raw = fused_mlp.apply(m, x, v, ModelConfig(**kw), dtype, fold_heads=fold)
    (raw.float() * t(cot)).sum().backward()
    gp = {k: q.grad.numpy() for k, q in m.named_parameters()}
    return gp, x.grad.numpy(), None if v is None else v.grad.numpy()


def _assert_f32(got, ref):
    gp, gx, gv = got
    rp, rx, rv = ref
    assert set(gp) == set(rp)
    for k in rp:
        np.testing.assert_allclose(gp[k], rp[k], atol=F32_TOL, rtol=F32_TOL,
                                   err_msg=k)
    np.testing.assert_allclose(gx, rx, atol=F32_TOL, rtol=F32_TOL)
    if rv is not None:
        np.testing.assert_allclose(gv, rv, atol=F32_TOL, rtol=F32_TOL)


def _close_bf16(a, b, name):
    """The JAX tests' bf16 rule: max abs difference under 5% of the larger
    max magnitude."""
    denom = max(np.abs(a).max(), np.abs(b).max(), 1e-6)
    assert np.abs(a - b).max() / denom < 0.05, (name,
                                                np.abs(a - b).max(), denom)


def _cot(n, seed=5):
    return np.random.default_rng(seed).normal(size=(n, 4)).astype(np.float32)


@pytest.mark.parametrize("name", list(MODEL_CASES))
@pytest.mark.parametrize("fold", [False, True])
def test_grads_match_pallas_interpret(name, fold):
    """Split and folded schedules (the plain head ignores the fold and
    backpropagates through ``apply_mlp``, as the JAX wrapper's XLA vjp
    does): params, dx and per-point dv."""
    kw = MODEL_CASES[name]
    params = np_params(kw)
    n = 37 if name == "full_8x256" else 61                 # odd N
    pe, ve = np_inputs(kw, n)
    cot = _cot(n)
    _assert_f32(_port_grads(kw, params, pe, ve, cot, fold),
                _jax_grads(kw, params, pe, ve, cot, fold))


@pytest.mark.parametrize("fold", [False, True])
def test_grads_per_ray_views(fold):
    """[R, S] points with [R, 1, ch] views: the views' grad is the sum of
    the per-point dv over each ray's samples."""
    kw = dict(netdepth=3, netwidth=32, multires=4, multires_views=2)
    params = np_params(kw)
    R, S = 6, 9
    rng = np.random.default_rng(8)
    pe, ve = np_inputs(kw, R * S)
    pe = pe.reshape(R, S, -1)
    ve = ve[::S][:, None, :] * rng.uniform(0.5, 1.5, (R, 1, 1)).astype(
        np.float32)
    cot = _cot(R * S).reshape(R, S, 4)
    m = torch_model(kw, params)
    with torch.no_grad():
        p, x, v, v_div = fused_mlp.prepare(m, t(pe), t(ve), ModelConfig(**kw))
    assert v_div == S and v.shape[0] == R
    got = _port_grads(kw, params, pe, ve, cot, fold)
    ref = _jax_grads(kw, params, pe, ve, cot, fold)
    assert got[2].shape == (R, 1, ve.shape[-1])
    _assert_f32(got, ref)


@pytest.mark.parametrize("fold", [False, True])
def test_grads_bf16_match_pallas_interpret(fold):
    kw = dict(netdepth=4, netwidth=64, skips=(2,), multires=4,
              multires_views=2)
    params = np_params(kw)
    pe, ve = np_inputs(kw, 96)
    cot = _cot(96)
    gp, gx, gv = _port_grads(kw, params, pe, ve, cot, fold, torch.bfloat16)
    rp, rx, rv = _jax_grads(kw, params, pe, ve, cot, fold, jnp.bfloat16)
    for k in rp:
        _close_bf16(gp[k], rp[k], k)
    _close_bf16(gx, rx, "dx")
    _close_bf16(gv, rv, "dv")


def test_final_layer_skip_goes_to_apply_mlp():
    """A final-layer skip is routed to the unfused ``apply_mlp`` in both
    packages, where the heads cannot take the concat: both refuse it the
    same way, under autograd too."""
    kw = dict(netdepth=3, netwidth=16, skips=(2,), multires=4,
              multires_views=2)
    cfg = ModelConfig(**kw)
    m = mlp.NeRF(cfg, torch.Generator().manual_seed(0), device="cpu")
    pe = torch.zeros(5, cfg.input_ch, requires_grad=True)
    ve = torch.zeros(5, cfg.input_ch_views)
    with pytest.raises(RuntimeError):
        fused_mlp.apply(m, pe, ve, cfg)
    with pytest.raises(TypeError):
        jfused.apply(np_params(kw), jnp.zeros((5, cfg.input_ch)),
                     jnp.zeros((5, cfg.input_ch_views)), JModelConfig(**kw),
                     interpret=True)


@pytest.mark.parametrize("fold", [False, True])
def test_backward_plain_packed_grads(fold):
    """``backward_plain`` on the packed layout: zero grads on every padded
    row and column, and the grads of a function linear in the cotangent."""
    kw = MODEL_CASES["skips_2_4"]
    cfg = ModelConfig(**kw)
    m = torch_model(kw, np_params(kw))
    pe, ve = np_inputs(kw, 45)
    with torch.no_grad():
        p, x, v, v_div = fused_mlp.prepare(m, t(pe), t(ve), cfg,
                                           fold_heads=fold)
        g = torch.from_numpy(_cot(45))
        dW, dB, dx, dv = fused_mlp.backward_plain(p, x, v, v_div, g)
        dW2, dB2, dx2, dv2 = fused_mlp.backward_plain(p, x, v, v_div, 2 * g)
    assert [tuple(a.shape) for a in dW] == [tuple(w.shape) for w in p.weights]
    assert [tuple(a.shape) for a in dB] == [tuple(b.shape) for b in p.biases]
    assert float(dx[:, p.in_ch:].abs().max()) == 0.0
    assert float(dv[:, p.vch:].abs().max()) == 0.0
    assert float(dW[0][p.in_ch:].abs().max()) == 0.0
    for a, b in zip(dW + dB + [dx, dv], dW2 + dB2 + [dx2, dv2]):
        torch.testing.assert_close(2 * a, b, atol=1e-5, rtol=1e-5)


def test_backward_cuda_refuses_cpu_tensors():
    kw = dict(netdepth=2, netwidth=16, multires=4, multires_views=2)
    pe, ve = np_inputs(kw, 5)
    cfg = ModelConfig(**kw)
    p, x, v, v_div = fused_mlp.prepare(torch_model(kw, np_params(kw)),
                                       t(pe), t(ve), cfg)
    before = fused_mlp.bwd_launches
    with pytest.raises(ValueError, match="CUDA"):
        fused_mlp.backward_cuda(p, x, v, v_div, torch.zeros(5, 4))
    assert fused_mlp.bwd_launches == before


def _sw64(n, k):
    """Element offset of B[n][k] in a K-major slab image of 32-value rows
    (64 bytes) in the wgmma 64-byte swizzle: byte address bits [4, 6) XOR
    bits [7, 9) (CUTLASS Swizzle<2, 4, 3>)."""
    addr = n * 64 + k * 2
    return (addr ^ (((addr >> 7) & 3) << 4)) // 2


def _ids(p):
    """``p`` with every weight element replaced by its own id (float64)."""
    ids, off = [], 0
    for w in p.weights:
        ids.append(torch.arange(off, off + w.numel(),
                                dtype=torch.float64).reshape(w.shape))
        off += w.numel()
    return dataclasses.replace(p, weights=ids), ids


def _packed_8x256(fold, dtype=torch.bfloat16):
    kw = MODEL_CASES["full_8x256"]
    m = torch_model(kw, np_params(kw))
    return fused_mlp.pack_weights(m, ModelConfig(**kw), dtype, fold)


@pytest.mark.parametrize("fold", [False, True], ids=["split", "folded"])
def test_bwd_stream_order(fold):
    """The bf16 backward's data pass reads its weights as one stream of
    slab images: the recompute's slabs of W (as the forward's,
    ``wgmma_stream``), the data grads' slabs of W^T (NP rows of W, 32
    columns each).  Named elements land where the wgmma layout puts them;
    every element appears twice (recompute and data grad), the alpha
    columns and the rgb block once (the recompute skips them)."""
    p = _packed_8x256(fold)
    q, ids = _ids(p)
    flat = fused_mlp.bwd_stream(q)
    # layer 0 first, as the forward: W0 [64, 256], one 256-wide pass
    w0 = ids[0]
    for k, n in [(0, 0), (1, 5), (9, 2), (40, 130), (63, 255)]:
        assert flat[(k // 32) * 256 * 32 + _sw64(n, k % 32)] == w0[k, n]
    # the last product is dx of layer 0: da_0 @ W0^T, 64 rows of W0 by 8
    # column slabs of 32, slab c holding W0[r, 32 c + k] at (r, k)
    base = flat.numel() - 64 * 256
    for r, c in [(0, 0), (63, 255), (17, 33), (40, 200)]:
        assert flat[base + (c // 32) * 64 * 32 + _sw64(r, c % 32)] == w0[r, c]
    # the recompute streams (K x NP per product): the pts layers (layer 5
    # takes the [x | h] skip), then the split head's feature and views
    # layers or the folded head's one layer, all K x NP
    recompute = 64 * 256 + 6 * 256 * 256 + (64 + 256) * 256 + (
        256 * 256 + (256 + 32) * 128 if not fold else (256 + 32) * 128)
    wr = ids[-1]                                # [128, 32]
    for r, c in [(0, 0), (127, 31), (5, 2), (66, 17)]:  # da_v = d_rgb Wr^T
        assert flat[recompute + _sw64(r, c)] == wr[r, c]
    # multiplicity
    count = torch.bincount(flat.long(), minlength=sum(w.numel() for w in ids))
    want = [torch.full(w.shape, 2) for w in ids]
    head = ids[-4 if not fold else -3]          # Waf / Wfa
    want[-4 if not fold else -3][:, head.shape[1] - 32:] = 1
    if fold:
        want[-2][:, p.h_p:] = 1                 # Wvv's alpha columns
    want[-1][:] = 1                             # Wr
    assert torch.equal(count, torch.cat([w.reshape(-1) for w in want]))
    assert flat.numel() == sum(n * sum(k for *_, k in terms)
                               for terms, n in fused_mlp._bwd_products(p))


def _unslab(img, k, n):
    """The [32, n] operand of one slab image (inverse of ``wgmma_image``)."""
    kk, nn = torch.meshgrid(torch.arange(k), torch.arange(n), indexing="ij")
    return img[_sw64(nn, kk)]


def _stream_walk(p, x, v, v_div, g):
    """The bf16 data pass's walk (csrc/fused_mlp_bwd.cu ``build_dplan``) in
    float64, its weights decoded from ``bwd_stream`` in the order
    ``_bwd_products`` lists them: T the in-place activation tile, R the
    views tile that takes d_rgb, then d_alpha.  Returns (dx, dv)."""
    flat = fused_mlp.bwd_stream(p).double()
    off = 0

    def operand(terms, n):
        nonlocal off
        out = []
        for _, _, _, k in terms:
            for _ in range(k // 32):
                out.append(_unslab(flat[off:off + n * 32], 32, n))
                off += n * 32
        return torch.cat(out)                   # [sum K, n]

    prods = iter(fused_mlp._bwd_products(p))

    def run(*srcs):
        terms, n = next(prods)
        return torch.cat(srcs, 1) @ operand(terms, n)

    B = [b.double() for b in p.biases]
    L, h = p.n_layers, p.h_p
    walk, _ = fused_mlp._layer_blocks(p)
    x, n_pts = x.double(), x.shape[0]
    vr = fused_mlp._view_rows(v, n_pts, v_div).double()
    masks, T = [], x
    for i, (bx, _) in enumerate(walk):          # recompute
        T = torch.relu(run(*([x] if bx is not None else []), T) + B[i])
        masks.append(T > 0)
    d_rgb = torch.nn.functional.pad(g[:, :3].double(), (0, 29))
    d_alpha = torch.nn.functional.pad(g[:, 3:4].double(), (0, 31))
    if p.head == fused_mlp.SPLIT:
        T = run(T) + B[L][:p.w_p]               # feature
        T = torch.relu(run(T, vr) + B[L + 1])   # z_hv
        zmask = T > 0
        T = run(d_rgb) * zmask                  # da_v
        dv = run(T)
        T = run(T)                              # dfeat
    else:
        T = torch.relu(run(T, vr) + B[L][:h])
        zmask = T > 0
        T = run(d_rgb) * zmask
        dv = run(T, d_alpha)
    T = run(T, d_alpha) * masks[L - 1]          # da_{L-1}
    dx = 0                                      # the x blocks, then W0
    for i in range(L - 1, -1, -1):
        if walk[i][0] is not None:
            dx = dx + run(T)
        if i > 0:
            T = run(T) * masks[i - 1]
        else:
            dx = dx + run(T)
    assert next(prods, None) is None and off == flat.numel()
    return dx, dv


@pytest.mark.parametrize("fold", [False, True], ids=["split", "folded"])
@pytest.mark.parametrize("name", ["skips_2_4", "small_2x16"])
def test_bwd_stream_walk_matches_backward_plain(name, fold):
    """The stream decoded slab by slab, fed to the kernel's walk in order,
    gives ``backward_plain``'s dx and dv (fp32 blocks, walked in float64)."""
    kw = MODEL_CASES[name]
    cfg = ModelConfig(**kw)
    pe, ve = np_inputs(kw, 21)
    with torch.no_grad():
        p, x, v, v_div = fused_mlp.prepare(torch_model(kw, np_params(kw)),
                                           t(pe), t(ve), cfg,
                                           fold_heads=fold)
        g = torch.from_numpy(_cot(21))
        dx, dv = _stream_walk(p, x, v, v_div, g)
        _, _, rdx, rdv = fused_mlp.backward_plain(p, x, v, v_div, g,
                                                  torch.float64)
    torch.testing.assert_close(dx, rdx, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(dv, rdv, atol=1e-5, rtol=1e-5)
