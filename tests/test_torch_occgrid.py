"""The port's occupancy grid (plnerf_torch/core/occgrid.py) and its paths
through ``render_rays``, the occupancy train step and the depth step,
against the JAX package on the CPU.  Grids, rays, weights and draws are
made with numpy from a seed; the port's fused MLP runs its plain versions
here.

Tolerances: the grid functions exactly (``init_grid``, ``refresh_occ``,
``_voxel_index``, ``update_grid``, ``occupancy_along_rays``);
``occ_guided_z_vals`` 1e-5, with a bin floor of 0.25: the port inverts
the CDF in float64, the JAX package in float32, whose cumsum rounding
moves a sample by 6.7e-6 there; at the recipe's floor of 0.03 an
unoccupied bin holds ~1e-3 of the CDF and the same rounding moves
samples by up to 2.9e-5 (held at 1e-4 there).  ``render_rays`` 1e-4; a
step's loss 1e-5 relative and grads 1e-4; the updated grid's ``occ``
equal and its density
to 1e-5 (the densities it observes are the MLP's, 1e-6 apart) in all but
1 voxel of 1000 (a sample within rounding of a voxel face lands on either
side of it: 1 of 4096 in the depth step, 1% off).  The depth step runs a
floor of 0.25 for the reason above."""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from plnerf.core import occgrid as jog
from plnerf.core.config import ModelConfig as JModelConfig
from plnerf.core.config import RenderConfig as JRenderConfig
from plnerf.train import step as jstep
from plnerf.train.state import TrainState as JTrainState
from plnerf_torch.checkpoint import convert_jax
from plnerf_torch.core import occgrid as og
from plnerf_torch.core import render
from plnerf_torch.core.config import ModelConfig, RenderConfig
from plnerf_torch.train import step as tstep

from test_torch_depth import (_batches, _both_states, _inject_jax_draws,
                              _jbatch, _setups, _tbatch, _tensors)
from test_torch_mlp import np_params, t, torch_model
from test_torch_render import _ray_batch, close, j_render_rays
from test_torch_train import _batches as nvs_batches
from test_torch_train import _grads_of, _jax_grads

torch.set_num_threads(1)

G, M = 16, 24
BOX = ([-1.5] * 3, [1.5] * 3)
KW = dict(netdepth=3, netwidth=32, multires=4, multires_views=2)


def _cfgs(**kw):
    kw = dict(dict(resolution=G, candidates=M), **kw)
    return og.OccGridConfig(**kw), jog.OccGridConfig(**kw)


def _density(seed=0, g=G):
    """A carved density field: a ball of radius 0.8 above the threshold,
    noise around it, some of it above too."""
    rng = np.random.default_rng(seed)
    c = (np.arange(g) + 0.5) / g * 3.0 - 1.5
    r = np.sqrt(c[:, None, None] ** 2 + c[None, :, None] ** 2
                + c[None, None, :] ** 2)
    d = np.where(r < 0.8, 5.0, 0.0) + rng.exponential(2e-3, (g, g, g))
    return d.astype(np.float32)


def _grids(cfg, jcfg, seed=0):
    """The same carved grid in both packages, ``occ`` refreshed."""
    dens = _density(seed, cfg.resolution)
    jg = jog.refresh_occ({**jog.init_grid(*BOX, jcfg),
                          "density": jnp.asarray(dens)}, jcfg)
    pg = og.refresh_occ({**og.init_grid(*BOX, cfg, "cpu"),
                         "density": t(dens)}, cfg)
    return pg, jg


def _same_grid(pg, jg, density_tol=0.0):
    """``occ`` and the box equal; the density equal or, with a tolerance,
    within it in all but 1 voxel of 1000 (a sample within rounding of a
    voxel face lands on either side of it)."""
    assert set(pg) == set(jg)
    np.testing.assert_array_equal(pg["occ"].numpy(), np.asarray(jg["occ"]))
    for k in ("aabb_min", "aabb_max"):
        np.testing.assert_array_equal(pg[k].numpy(), np.asarray(jg[k]))
    got, ref = pg["density"].numpy(), np.asarray(jg["density"])
    if not density_tol:
        np.testing.assert_array_equal(got, ref)
        return
    off = np.abs(got - ref) > density_tol * (1.0 + np.abs(ref))
    assert off.sum() <= off.size // 1000, np.abs(got - ref).max()


def _rays(R, seed=7):
    rb = _ray_batch(R, seed)
    return rb[:, 0:3], rb[:, 3:6], rb[:, 6:7], rb[:, 7:8]


# ----------------------------------------------------------- grid functions --

def test_init_and_refresh_match_jax():
    cfg, jcfg = _cfgs()
    jg = jog.init_grid(*BOX, jcfg)
    pg = og.init_grid(*BOX, cfg, "cpu")
    _same_grid(pg, jg)
    assert pg["density"].dtype == torch.float32
    pg, jg = _grids(cfg, jcfg)
    _same_grid(pg, jg)
    # the dilation reaches one voxel beyond the thresholded ball, no more
    occ, raw = pg["occ"].numpy(), (pg["density"].numpy() > cfg.threshold)
    assert occ.sum() > raw.sum() and occ[~raw].any()
    assert occ[0, 0, 0] == float(raw[:2, :2, :2].any())


def test_voxel_index_matches_jax():
    cfg, jcfg = _cfgs()
    pg, jg = _grids(cfg, jcfg)
    rng = np.random.default_rng(1)
    pts = rng.uniform(-2.0, 2.0, (200, 5, 3)).astype(np.float32)
    pts[0, 0] = [-1.5, -1.5, -1.5]               # the box's corners
    pts[0, 1] = [1.5, 1.5, 1.5]
    pts[0, 2] = [1e9, -1e9, 0.0]                 # far outside
    flat, inb = og._voxel_index(pg, t(pts), G)
    jflat, jinb = jog._voxel_index(jg, jnp.asarray(pts), G)
    np.testing.assert_array_equal(flat.numpy(), np.asarray(jflat))
    np.testing.assert_array_equal(inb.numpy(), np.asarray(jinb))
    assert flat.dtype == torch.int64 and 0 < inb.float().mean() < 1
    assert inb[0, 0] and not inb[0, 1] and not inb[0, 2]


def test_update_grid_matches_jax():
    """Ten updates from a fresh grid: observations inside and outside the
    box, repeats into one voxel (the max wins), zero densities that carve
    the optimistic init and a ball that keeps its density."""
    cfg, jcfg = _cfgs()
    jg = jog.init_grid(*BOX, jcfg)
    pg = og.init_grid(*BOX, cfg, "cpu")
    rng = np.random.default_rng(2)
    for k in range(10):
        pts = rng.uniform(-1.6, 1.6, (3000, 8, 3)).astype(np.float32)
        pts[..., 0] = np.minimum(pts[..., 0], 1.0)    # x > 1 unvisited
        r = np.linalg.norm(pts, axis=-1)
        sigma = np.where(r < 0.8, rng.uniform(1, 10, r.shape),
                         np.maximum(rng.normal(0, 1e-3, r.shape), 0))
        sigma = sigma.astype(np.float32)
        jg = jog.update_grid(jg, jnp.asarray(pts), jnp.asarray(sigma), jcfg)
        pg = og.update_grid(pg, t(pts), t(sigma), cfg)
        _same_grid(pg, jg)
    occ = pg["occ"].numpy()
    assert 0.1 < occ.mean() < 0.9 and occ[G // 2, G // 2, G // 2] == 1.0
    # unvisited voxels keep the init
    dens = pg["density"].numpy()
    assert (dens[-2:] == np.float32(10.0 * cfg.threshold)).all()
    assert (dens[:-3] < cfg.threshold).any()


def test_update_grid_takes_no_gradient():
    cfg, _ = _cfgs()
    pg = og.init_grid(*BOX, cfg, "cpu")
    pts = torch.zeros(4, 3, requires_grad=True)
    sigma = torch.ones(4, requires_grad=True)
    out = og.update_grid(pg, pts, sigma, cfg)
    assert not out["density"].requires_grad and not out["occ"].requires_grad


def test_occupancy_along_rays_matches_jax():
    cfg, jcfg = _cfgs()
    pg, jg = _grids(cfg, jcfg)
    o, d, near, far = _rays(40)
    je, jo = jog.occupancy_along_rays(
        jg, *map(jnp.asarray, (o, d, near, far)), M, jcfg)
    e, occ = og.occupancy_along_rays(pg, *map(t, (o, d, near, far)), M, cfg)
    np.testing.assert_array_equal(e.numpy(), np.asarray(je))
    np.testing.assert_array_equal(occ.numpy(), np.asarray(jo))
    assert 0.05 < float(occ.mean()) < 0.8


@pytest.mark.parametrize("jitter", [False, True])
@pytest.mark.parametrize("floor,tol", [(0.25, 1e-5), (0.03, 1e-4)])
def test_occ_guided_z_vals_matches_jax(jitter, floor, tol):
    cfg, jcfg = _cfgs(floor=floor)
    pg, jg = _grids(cfg, jcfg)
    R, n = 40, 16
    o, d, near, far = _rays(R)
    tr = (np.random.default_rng(3).uniform(size=(R, n)).astype(np.float32)
          if jitter else None)
    jz, jfrac = jog.occ_guided_z_vals(
        jg, *map(jnp.asarray, (o, d, near, far)), n,
        None if tr is None else jnp.asarray(tr), jcfg)
    z, frac = og.occ_guided_z_vals(pg, *map(t, (o, d, near, far)), n,
                                   None if tr is None else t(tr), cfg)
    close(z, jz, atol=tol)
    assert float(frac) == pytest.approx(float(jfrac), abs=1e-7)
    assert bool((z[:, 1:] >= z[:, :-1]).all())
    # guided: more samples inside the ball than uniform placement puts
    pts = t(o)[:, None] + t(d)[:, None] * z[..., None]
    inside = (pts.norm(dim=-1) < 0.9).float().mean()
    assert float(inside) > 0.25


# -------------------------------------------------------------- render_rays --

def _render_occ(rkw, R=12, seed=8, grid=True):
    cfg, jcfg = _cfgs()
    pg, jg = _grids(cfg, jcfg)
    pc, pf = np_params(KW, seed=0), np_params(KW, seed=1)
    for p in (pc, pf):
        p["alpha_linear"]["b"] = p["alpha_linear"]["b"] + 2.0
    rb = _ray_batch(R)
    rng = np.random.default_rng(seed)
    ov = {"t_rand": rng.uniform(size=(R, rkw["n_samples"])).astype(
        np.float32)}
    if rkw.get("n_importance", 0):
        ov["u"] = rng.uniform(size=(R, rkw["n_importance"])).astype(
            np.float32)
    ref = j_render_rays(pc, pf, jnp.asarray(rb), jax.random.PRNGKey(0),
                        mcfg=JModelConfig(**KW),
                        rcfg=JRenderConfig(**rkw, occ=jcfg),
                        overrides={k: jnp.asarray(v) for k, v in ov.items()},
                        occ_grid=jg if grid else None)
    with torch.no_grad():
        got = render.render_rays(
            torch_model(KW, pc), torch_model(KW, pf), t(rb), None,
            ModelConfig(**KW), RenderConfig(**rkw, occ=cfg), overrides=ov,
            occ_grid=pg if grid else None)
    return got, ref


@pytest.mark.parametrize("n_importance", [0, 8])
@pytest.mark.parametrize("grid", [True, False])
def test_render_rays_occ_branch_matches_jax(n_importance, grid):
    """Grid-guided coarse samples (or, with ``rcfg.occ`` set and no grid,
    uniform ones), the density observations and ``occ_ray_frac``."""
    rkw = dict(n_samples=16, n_importance=n_importance, mode="linear",
               white_bkgd=True, perturb=True)
    got, ref = _render_occ(rkw, grid=grid)
    assert set(got) == set(ref)
    assert ("occ_ray_frac" in got) == grid
    for k, v in ref.items():
        if k in ("disp_map", "disp0"):
            close(got[k], v, atol=0, rtol=1e-4, msg=k)
        else:
            close(got[k], v, atol=1e-4, rtol=1e-4, msg=k)
    n = 16 + (16 + 8 if n_importance else 0)
    assert got["occ_z"].shape == got["occ_sigma"].shape == (12, n)
    assert not got["occ_sigma"].requires_grad
    assert float(got["occ_sigma"].min()) >= 0.0


def test_render_rays_without_grid_samples_uniformly():
    """``rcfg.occ`` set and no grid: the maps of the uniform renderer."""
    rkw = dict(n_samples=16, n_importance=8, mode="linear",
               white_bkgd=True, perturb=True)
    cfg, _ = _cfgs()
    pc, pf = np_params(KW, seed=0), np_params(KW, seed=1)
    mc, mf = torch_model(KW, pc), torch_model(KW, pf)
    rb = t(_ray_batch(12))
    ov = {"t_rand": np.random.default_rng(8).uniform(size=(12, 16)),
          "u": np.random.default_rng(9).uniform(size=(12, 8))}
    with torch.no_grad():
        plain = render.render_rays(mc, mf, rb, None, ModelConfig(**KW),
                                   RenderConfig(**rkw), overrides=ov)
        occ = render.render_rays(mc, mf, rb, None, ModelConfig(**KW),
                                 RenderConfig(**rkw, occ=cfg), overrides=ov)
    for k, v in plain.items():
        assert torch.equal(occ[k], v), k


# ---------------------------------------------------------------- the steps --

def _step_setups(accum, perturb):
    cfg, jcfg = _cfgs()
    rkw = dict(n_samples=16, n_importance=8, mode="linear", white_bkgd=True,
               perturb=perturb)
    skw = dict(lrate=5e-3, coarse_lrate=5e-3, lrate_decay=1,
               accum_chunks=accum)
    jsetup = jstep.TrainSetup(mcfg=JModelConfig(**KW),
                              rcfg=JRenderConfig(**rkw, occ=jcfg), **skw)
    setup = tstep.TrainSetup(mcfg=ModelConfig(**KW), rcfg=RenderConfig(
        **rkw, occ=cfg, use_fused_mlp=True, fused_fold_heads=True), **skw)
    return setup, jsetup


def _step_inputs(R, perturb, monkeypatch):
    rng = np.random.default_rng(9)
    rb = _ray_batch(R)
    target = rng.uniform(size=(R, 3)).astype(np.float32)
    ov = None
    if perturb:
        ov = {"t_rand": rng.uniform(size=(R, 16)).astype(np.float32),
              "u": rng.uniform(size=(R, 8)).astype(np.float32)}
        for mod, conv in ((jstep.render, jnp.asarray), (tstep.render, None)):
            orig = mod.render_rays
            monkeypatch.setattr(mod, "render_rays", (
                lambda o, c: lambda *a, **k: o(*a, **dict(k, overrides={
                    n: (c(v) if c else v) for n, v in ov.items()})))(
                        orig, conv))
    return rb, target


@pytest.mark.parametrize("accum,perturb", [(1, True), (2, False)])
def test_occ_loss_grads_and_grid_update_match_jax(accum, perturb,
                                                  monkeypatch):
    """One forward and backward through the guided renderer (over two ray
    chunks with ``accum_chunks`` 2) and the grid update from its density
    observations, against JAX ``_value_and_grad_accum`` and
    ``_apply_occ_update``."""
    setup, jsetup = _step_setups(accum, perturb)
    R = 16
    rb, target = _step_inputs(R, perturb, monkeypatch)
    pg, jg = _grids(setup.rcfg.occ, jsetup.rcfg.occ)
    pc, pf = np_params(KW, seed=0), np_params(KW, seed=1)
    for p in (pc, pf):
        p["alpha_linear"]["b"] = p["alpha_linear"]["b"] + 0.5

    jbatch = {"rays": jnp.asarray(rb), "target": jnp.asarray(target)}
    (_, jm), (gc, gf) = jstep._value_and_grad_accum(
        jsetup, (pc, pf), dict(jbatch, occ_grid=jg), jax.random.PRNGKey(0),
        lambda both, b, k: jstep._render_loss(both[0], both[1], b, k,
                                              jsetup))
    jg1, jm = jstep._apply_occ_update(jsetup, jg, jbatch, dict(jm))

    mc, mf = torch_model(KW, pc), torch_model(KW, pf)
    batch = {"rays": t(rb), "target": t(target)}
    m = tstep._value_and_grad_accum(
        setup, list(mc.parameters()) + list(mf.parameters()),
        dict(batch, occ_grid=pg), None,
        lambda b, g: tstep._render_loss(mc, mf, b, g, setup))
    assert m["_occ_z"].shape == (R, 16 + 24)
    pg1, m = tstep.apply_occ_update(setup, pg, batch, m)

    assert set(m) == set(jm) and "occ_ray_frac" in m
    for k in jm:
        assert float(m[k]) == pytest.approx(float(jm[k]), rel=1e-5,
                                            abs=1e-7), k
    got, ref = _grads_of((mc, mf)), _jax_grads(gc, gf)
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], atol=1e-4, rtol=1e-4,
                                   err_msg=k)
    _same_grid(pg1, jg1, density_tol=1e-5)
    assert not torch.equal(pg1["density"], pg["density"])


def test_make_occ_train_step_matches_jax():
    """Two steps of ``make_occ_train_step`` from one init on the same
    batches: losses, the grid after each, the step count; and the step
    refuses a setup without ``rcfg.occ``."""
    setup, jsetup = _step_setups(1, False)
    pg, jg = _grids(setup.rcfg.occ, jsetup.rcfg.occ)
    pc, pf = np_params(KW, seed=0), np_params(KW, seed=1)
    fine, coarse, _ = jsetup.make_optimizers()
    jstate = JTrainState(step=jnp.int32(0), params_coarse=pc,
                         params_fine=pf, opt_coarse=coarse.init(pc),
                         opt_fine=fine.init(pf))
    state = tstep.init_state(torch.Generator().manual_seed(0), setup, "cpu")
    convert_jax.load_jax_params(state.params_coarse, pc)
    convert_jax.load_jax_params(state.params_fine, pf)
    jfn = jstep.make_occ_train_step(jsetup)
    fn = tstep.make_occ_train_step(setup)
    for i, (rays, target) in enumerate(nvs_batches(2, 16)):
        jstate, jg, jm = jfn(jstate, jg, {"rays": jnp.asarray(rays),
                                          "target": jnp.asarray(target)},
                             jax.random.PRNGKey(i))
        state, pg, m = fn(state, pg, {"rays": t(rays), "target": t(target)})
        assert set(m) == set(jm)
        assert float(m["loss"]) == pytest.approx(float(jm["loss"]),
                                                 rel=1e-5), i
        assert float(m["occ_ray_frac"]) == float(jm["occ_ray_frac"])
        _same_grid(pg, jg, density_tol=1e-5)
    assert state.step == int(jstate.step) == 2
    with pytest.raises(ValueError):
        tstep.make_occ_train_step(dataclasses.replace(
            setup, rcfg=dataclasses.replace(setup.rcfg, occ=None)))


def test_depth_step_with_grid_matches_jax(monkeypatch):
    """One depth step (space carving, joint Adam) with grid-guided coarse
    samples from a converted state, then the grid update, against JAX
    ``make_depth_train_step`` with ``occ_grid`` in its batch and
    ``_apply_occ_update``."""
    cfg, jcfg = _cfgs(floor=0.25)
    jsetup, setup = _setups(dict(freeze_ss=100), dict(), False)
    jsetup = dataclasses.replace(jsetup, rcfg=dataclasses.replace(
        jsetup.rcfg, occ=jcfg))
    setup = dataclasses.replace(setup, rcfg=dataclasses.replace(
        setup.rcfg, occ=cfg))
    js, ps = _both_states(jsetup, setup, count=3)
    pg, jg = _grids(cfg, jcfg)
    (batch, draws), = _batches(1, 16, 12, 8, False)
    _inject_jax_draws(monkeypatch, [draws])
    jb = _jbatch(batch)
    js1, jm = jstep.make_depth_train_step(jsetup)(
        js, dict(jb, occ_grid=jg), jax.random.PRNGKey(0))
    jg1, jm = jstep._apply_occ_update(jsetup, jg, jb, dict(jm))
    tb = _tbatch(batch)
    ps, m = tstep.make_depth_train_step(setup)(
        ps, dict(tb, occ_grid=pg), None, draws)
    pg1, m = tstep.apply_occ_update(setup, pg, tb, m)
    assert set(m) == set(jm) and "occ_ray_frac" in m
    for k in jm:
        assert float(m[k]) == pytest.approx(float(jm[k]), rel=1e-5,
                                            abs=1e-7), k
    for n, got, ref in _tensors(ps, js1):
        np.testing.assert_allclose(got, ref, atol=1e-7, rtol=1e-5,
                                   err_msg=n)
    _same_grid(pg1, jg1, density_tol=1e-5)
