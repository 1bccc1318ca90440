"""PyTorch port vs the JAX package on the render path: quadrature,
samplers (including the CDF edge cases), rays, and ``render_rays`` as a
whole at small and at full width.  Random draws are made with numpy and
injected into both renderers through ``overrides``.  The JAX side runs
under ``jax.jit``: at these shapes compiling once costs a tenth of eager
op-by-op dispatch."""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from plnerf.core import quadrature as jquad
from plnerf.core import rays as jrays
from plnerf.core import render as jrender
from plnerf.core import sampling as jsamp
from plnerf.core.config import ModelConfig as JModelConfig
from plnerf.core.config import RenderConfig as JRenderConfig
from plnerf_torch.core import quadrature, rays, render, sampling
from plnerf_torch.core.config import ModelConfig, RenderConfig

from test_torch_mlp import np_params, t, torch_model

torch.set_num_threads(1)

j_raw2outputs = jax.jit(jquad.raw2outputs, static_argnames=(
    "mode", "color_mode", "white_bkgd", "farcolorfix"))
j_reform = jax.jit(jsamp.sample_pdf_reformulation)
j_render_rays = jax.jit(jrender.render_rays, static_argnames=("mcfg",
                                                              "rcfg"))


def close(got, ref, atol, rtol=0.0, msg=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(ref), atol=atol, rtol=rtol,
                               err_msg=msg)


def _quad_inputs(R=6, S=12, seed=0):
    rng = np.random.default_rng(seed)
    raw = rng.normal(size=(R, S, 4)).astype(np.float32) * 2
    near = np.full((R, 1), 2.0, np.float32)
    far = np.full((R, 1), 6.0, np.float32)
    z = np.sort(rng.uniform(2, 6, size=(R, S)).astype(np.float32), -1)
    d = rng.normal(size=(R, 3)).astype(np.float32)
    noise = rng.normal(size=(R, S)).astype(np.float32)
    return raw, z, near, far, d, noise


@pytest.mark.parametrize("mode,color_mode,farcolorfix,white", [
    ("linear", "midpoint", False, True),
    ("linear", "midpoint", True, False),
    ("linear", "left", False, False),
    ("linear", "tau_weighted", False, True),
    ("constant", "midpoint", False, True),
    ("constant", "midpoint", False, False),
])
def test_raw2outputs_matches_jax(mode, color_mode, farcolorfix, white):
    raw, z, near, far, d, noise = _quad_inputs()
    args = (raw, z, near, far, d)
    ref = j_raw2outputs(*map(jnp.asarray, args), mode=mode,
                        color_mode=color_mode, noise=jnp.asarray(noise),
                        white_bkgd=white, farcolorfix=farcolorfix)
    got = quadrature.raw2outputs(*map(t, args), mode, color_mode, t(noise),
                                 white, farcolorfix)
    for k, v in ref.items():
        if v is None:
            assert got[k] is None, k
            continue
        close(got[k], v, atol=1e-5, rtol=1e-5, msg=k)


def test_linspace_matches_jax_bit_for_bit():
    for n in (1, 2, 3, 7, 8, 64, 65, 128, 130, 192, 256):
        ref = np.asarray(jnp.linspace(0.0, 1.0, n, dtype=jnp.float32))
        np.testing.assert_array_equal(sampling.linspace01(n).numpy(), ref)
    ref = np.asarray(jsamp.draw_u(None, 3, 64, det=True))
    np.testing.assert_array_equal(
        sampling.draw_u(None, 3, 64, det=True).numpy(), ref)


@pytest.mark.parametrize("lindisp", [False, True])
@pytest.mark.parametrize("jitter", [False, True])
def test_stratified_z_vals_matches_jax(lindisp, jitter):
    rng = np.random.default_rng(1)
    near = rng.uniform(0.5, 2, (5, 1)).astype(np.float32)
    far = near + rng.uniform(1, 4, (5, 1)).astype(np.float32)
    tr = rng.uniform(size=(5, 128)).astype(np.float32) if jitter else None
    ref = jsamp.stratified_z_vals(jnp.asarray(near), jnp.asarray(far), 128,
                                  lindisp, None if tr is None
                                  else jnp.asarray(tr))
    got = sampling.stratified_z_vals(t(near), t(far), 128, lindisp, t(tr))
    close(got, ref, atol=1e-6, rtol=1e-6)


def _pl_case(R=4, S=10, seed=2):
    """Coarse bins and piecewise-linear weights with flat intervals and
    both slope signs (tau made from a staircase density)."""
    rng = np.random.default_rng(seed)
    near = np.full((R, 1), 2.0, np.float32)
    far = np.full((R, 1), 6.0, np.float32)
    bins = np.sort(rng.uniform(2, 6, (R, S)).astype(np.float32), -1)
    sigma = rng.choice([0.0, 0.0, 1.5, 4.0], size=(R, S)).astype(np.float32)
    d = np.tile(np.array([[0, 0, 1]], np.float32), (R, 1))
    w, tau, T = jquad.compute_weights_piecewise_linear(
        jnp.asarray(sigma), jnp.asarray(bins), jnp.asarray(near),
        jnp.asarray(far), jnp.asarray(d))
    return bins, np.asarray(w), np.asarray(tau), np.asarray(T), near, far


def _u_with_edges(cdf, N=24, seed=3, on_entries=False):
    """Random u plus u = 0 and u = 1 (and u exactly on CDF entries)."""
    rng = np.random.default_rng(seed)
    u = rng.uniform(size=(cdf.shape[0], N)).astype(np.float32)
    u[:, 0] = 0.0
    u[:, 1] = 1.0
    if on_entries:
        u[:, 2:2 + cdf.shape[1]] = cdf
    return u


def _reform_check(bins, w, tau, T, near, far, u):
    args = (bins, w, tau, T, near, far, u)
    ref = j_reform(*map(jnp.asarray, args))
    got = sampling.sample_pdf_reformulation(*map(t, args))
    for name, g, r in zip(("samples", "T_left", "tau_left", "s_left"),
                          got, ref):
        close(g, r, atol=1e-5, rtol=1e-5, msg=name)


def _cdf(w):
    return np.asarray(jsamp.sample_pdf_reformulation_cdf(
        None, jnp.asarray(w), None, None))


def test_sample_pdf_reformulation_matches_jax():
    bins, w, tau, T, near, far = _pl_case()
    _reform_check(bins, w, tau, T, near, far, _u_with_edges(_cdf(w)))


def _dyadic_weights(R, n, ulp_over=False, seed=4):
    """Weights on a 2**-23 grid: every cumsum is exact in float32 in any
    summation order, so both packages' CDFs are bit-equal and u can sit
    exactly on an entry.  ``ulp_over``: cumsum exceeds 1 by one ulp before
    the last bin, so the cdf[-1] = 1 overwrite makes the CDF dip."""
    rng = np.random.default_rng(seed)
    k = rng.multinomial(64, np.full(n, 1.0 / n), size=R).astype(np.float32)
    w = k / np.float32(64)
    if ulp_over:
        w[:, 1] += w[:, -1]
        w[:, -1] = 0.0
        w[:, 0] += np.float32(2.0 ** -23)
    return w


@pytest.mark.parametrize("ulp_over", [False, True])
def test_sample_pdf_reformulation_cdf_edges(ulp_over):
    """u = 0, u = 1 and u exactly on every CDF entry; with ``ulp_over``
    the CDF is not monotone at its end, where the comparison count keeps
    JAX's bins (a binary search would not)."""
    bins, _, tau, T, near, far = _pl_case(R=3)
    w = _dyadic_weights(3, bins.shape[1] + 1, ulp_over)
    cdf = _cdf(w)
    np.testing.assert_array_equal(
        cdf[:, 1:-1], np.cumsum(w, -1, dtype=np.float32)[:, :-1])
    assert (np.diff(cdf, axis=-1) < 0).any() == ulp_over
    u = _u_with_edges(cdf, N=cdf.shape[1] + 6, on_entries=True)
    counts_ref = np.asarray(jsamp.searchsorted_right(jnp.asarray(cdf),
                                                     jnp.asarray(u)))
    counts = sampling.searchsorted_right(t(cdf), t(u)).numpy()
    np.testing.assert_array_equal(counts, counts_ref)
    _reform_check(bins, w, tau, T, near, far, u)


def test_sample_pdf_reformulation_nan_falls_back_to_left_edge():
    bins, w, tau, T, near, far = _pl_case(R=2)
    T = np.array(T)
    T[:, 3:] = np.nan
    u = _u_with_edges(_cdf(w))
    samples = sampling.sample_pdf_reformulation(
        *map(t, (bins, w, tau, T, near, far, u)))[0]
    assert torch.isfinite(samples).all()
    _reform_check(bins, w, tau, T, near, far, u)


@pytest.mark.parametrize("flat", [False, True])
def test_sample_pdf_matches_jax(flat):
    rng = np.random.default_rng(5)
    bins = np.sort(rng.uniform(2, 6, (4, 9)).astype(np.float32), -1)
    w = rng.uniform(size=(4, 8)).astype(np.float32)
    if flat:
        w[:, 2:6] = 0.0                               # zero-weight bins
    u = rng.uniform(size=(4, 16)).astype(np.float32)
    u[:, 0], u[:, 1] = 0.0, 1.0
    ref = jsamp.sample_pdf(jnp.asarray(bins), jnp.asarray(w), jnp.asarray(u))
    got = sampling.sample_pdf(t(bins), t(w), t(u))
    close(got, ref, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_one_hot_gather_matches_gather_forward_and_backward(dtype):
    """``OneHotGather`` (the gather the CUDA path backpropagates through)
    against ``torch.gather`` on the CPU: equal values, and equal grads
    where many draws share a bin, the bins at both edges included."""
    rng = np.random.default_rng(8)
    vals = rng.normal(size=(5, 9))
    idx = rng.integers(0, 9, (5, 24))
    idx[:, :6] = 3                                    # six draws in one bin
    idx[:, 6], idx[:, 7] = 0, 8
    g = rng.normal(size=(5, 24))
    grads = []
    for gather in (sampling.OneHotGather.apply,
                   lambda v, i: torch.gather(v, -1, i)):
        v = torch.tensor(vals, dtype=dtype, requires_grad=True)
        out = gather(v, torch.from_numpy(idx))
        out.backward(torch.tensor(g, dtype=dtype))
        grads.append((out.detach(), v.grad))
    torch.testing.assert_close(grads[0][0], grads[1][0], atol=0, rtol=0)
    tol = 1e-12 if dtype == torch.float64 else 1e-6
    torch.testing.assert_close(grads[0][1], grads[1][1], atol=tol, rtol=tol)
    assert torch.all(grads[0][1][:, 3] != 0)


def _cam():
    rng = np.random.default_rng(6)
    a = rng.normal(size=(3, 3))
    q, _ = np.linalg.qr(a)
    c2w = np.concatenate([q, rng.normal(size=(3, 1))], 1).astype(np.float32)
    K = np.array([[11.0, 0, 4.5], [0, 11.0, 3.0], [0, 0, 1]], np.float32)
    return c2w, K


def test_rays_match_jax():
    c2w, K = _cam()
    ro_r, rd_r = jrays.get_rays(6, 9, K, c2w)
    ro, rd = rays.get_rays(6, 9, K, t(c2w))
    close(ro, ro_r, atol=1e-6)
    close(rd, rd_r, atol=1e-6)
    intr = np.array([11.0, 12.0, 4.5, 3.0], np.float32)
    ro_r, rd_r = jrays.get_rays_pixelcenter(6, 9, intr, c2w)
    ro, rd = rays.get_rays_pixelcenter(6, 9, intr, t(c2w))
    close(rd, rd_r, atol=1e-6)
    coords = np.array([[0, 0], [5, 8], [2, 3]])
    _, rd_r = jrays.get_rays_pixelcenter(6, 9, intr, c2w, coords)
    _, rd = rays.get_rays_pixelcenter(6, 9, intr, t(c2w), t(coords))
    close(rd, rd_r, atol=1e-6)


@pytest.mark.parametrize("ndc", [False, True])
def test_make_ray_batch_matches_jax(ndc):
    c2w, K = _cam()
    c2w[:, 3] = [0.1, -0.2, 1.5]          # in front of the NDC near plane
    ro_r, rd_r = jrays.get_rays(6, 9, K, c2w)
    ref, sh = jrender.make_ray_batch(ro_r, rd_r, 2.0, 6.0, True, ndc, 6, 9,
                                     11.0)
    ro, rd = rays.get_rays(6, 9, K, t(c2w))
    got, sh2 = render.make_ray_batch(ro, rd, 2.0, 6.0, True, ndc, 6, 9, 11.0)
    assert tuple(sh) == tuple(sh2)
    close(got, ref, atol=1e-6, rtol=1e-6)
    ref_ndc = jrays.ndc_rays(6, 9, 11.0, 1.0, ro_r, rd_r)
    got_ndc = rays.ndc_rays(6, 9, 11.0, 1.0, ro, rd)
    for g, r in zip(got_ndc, ref_ndc):
        close(g, r, atol=1e-6, rtol=1e-6)


def _ray_batch(R, seed=7):
    """Blender-like rays: origins on a radius-4 sphere looking at the
    centre (with jitter), near 2, far 6, unit viewdirs."""
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(R, 3)).astype(np.float32)
    o = 4.0 * o / np.linalg.norm(o, axis=-1, keepdims=True)
    d = -o / 4.0 + 0.1 * rng.normal(size=(R, 3)).astype(np.float32)
    vd = d / np.linalg.norm(d, axis=-1, keepdims=True)
    return np.concatenate([o, d, np.full((R, 1), 2.0, np.float32),
                           np.full((R, 1), 6.0, np.float32), vd],
                          -1).astype(np.float32)


def _render_both(kw, rkw, R, fused, seed=8, dense_sigma=False):
    params_c, params_f = np_params(kw, seed=0), np_params(kw, seed=1)
    if dense_sigma:      # visible content: lift the density heads
        for p in (params_c, params_f):
            p["alpha_linear"]["b"] = p["alpha_linear"]["b"] + 2.0
    rcfg = RenderConfig(**rkw)
    jrcfg = JRenderConfig(**rkw)
    rb = _ray_batch(R)
    rng = np.random.default_rng(seed)
    ov = {"t_rand": rng.uniform(size=(R, rcfg.n_samples)).astype(np.float32),
          "u": rng.uniform(size=(R, rcfg.n_importance)).astype(np.float32)}
    ref = j_render_rays(params_c, params_f, jnp.asarray(rb),
                        jax.random.PRNGKey(0), mcfg=JModelConfig(**kw),
                        rcfg=jrcfg, overrides={k: jnp.asarray(v)
                                               for k, v in ov.items()})
    mc, mf = torch_model(kw, params_c), torch_model(kw, params_f)
    with torch.no_grad():
        got = render.render_rays(
            mc, mf, t(rb), None, ModelConfig(**kw),
            dataclasses.replace(rcfg, use_fused_mlp=fused), overrides=ov)
    return got, ref


TOL = {"rgb_map": 1e-4, "acc_map": 1e-4, "depth_map": 1e-4, "rgb0": 1e-4,
       "acc0": 1e-4, "depth0": 1e-4, "z_std": 1e-4, "sigma0_pos_frac": 0.0,
       "raw": 1e-4}


def _check_all_keys(got, ref):
    assert set(got) == set(ref)
    for k, v in ref.items():
        if k in ("disp_map", "disp0"):          # 1/(depth/acc): relative
            close(got[k], v, atol=0, rtol=1e-4, msg=k)
        else:
            close(got[k], v, atol=TOL[k], rtol=TOL[k], msg=k)


@pytest.mark.parametrize("mode", ["linear", "constant"])
@pytest.mark.parametrize("fused", [False, True])
def test_render_rays_matches_jax(mode, fused):
    kw = dict(netdepth=2, netwidth=16, multires=4, multires_views=2)
    rkw = dict(n_samples=16, n_importance=8, mode=mode, white_bkgd=True,
               perturb=True, retraw=True)
    got, ref = _render_both(kw, rkw, R=12, fused=fused, dense_sigma=True)
    _check_all_keys(got, ref)


def test_render_rays_full_width_fused_matches_jax():
    """Flagship widths: 8x256 MLPs, 128 + 64 samples, linear, white
    background, fused path on (its plain version on the CPU)."""
    rkw = dict(n_samples=128, n_importance=64, mode="linear",
               white_bkgd=True, perturb=True)
    got, ref = _render_both({}, rkw, R=8, fused=True, dense_sigma=True)
    _check_all_keys(got, ref)
    assert float(got["acc_map"].min()) > 0.1     # rays see content
