"""The port's NVS training (plnerf_torch/train/: optim, batching, step)
against the JAX package on the CPU: the schedules and one Adam update
against optax, the batch draws, ``_render_loss`` value and grads against
``jax.value_and_grad``, and 20-step trajectories against JAX
``build_one_step`` on the same batches.  Weights, rays and draws are made
with numpy from a seed; the port's fused MLP runs its plain versions
here."""

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from plnerf.core.config import ModelConfig as JModelConfig
from plnerf.core.config import RenderConfig as JRenderConfig
from plnerf.data import synthetic as jsynthetic
from plnerf.train import batching as jbatching
from plnerf.train import optim as joptim
from plnerf.train import step as jstep
from plnerf.train.state import TrainState as JTrainState
from plnerf_torch.checkpoint import convert_jax
from plnerf_torch.core import mlp, quadrature, sampling
from plnerf_torch.core.config import ModelConfig, RenderConfig
from plnerf_torch.data import synthetic
from plnerf_torch.train import batching, optim
from plnerf_torch.train import step as tstep

from test_torch_mlp import np_params, t, torch_model

torch.set_num_threads(1)

KW = dict(netdepth=3, netwidth=32, multires=4, multires_views=2)


# ------------------------------------------------------------------ optim --

def test_schedules_match_jax():
    for count in (0, 1, 7, 500, 1000, 12345, 250000):
        assert optim.exp_decay_schedule(5e-4, 500)(count) == pytest.approx(
            float(joptim.exp_decay_schedule(5e-4, 500)(jnp.int32(count))),
            rel=1e-6)
        assert optim.staged_decay_schedule(1e-3, 100, 900)(count) == \
            pytest.approx(float(joptim.staged_decay_schedule(
                1e-3, 100, 900)(jnp.int32(count))), rel=1e-6)


@pytest.mark.parametrize("fix", [False, True])
def test_coarse_schedule_quirk(fix):
    """The coarse Adam decays from ``lrate`` (the reference assigns it the
    fine rate) unless ``fix_coarse_lr_decay``."""
    kw = dict(lrate=5e-4, coarse_lrate=2e-3, lrate_decay=1,
              fix_coarse_lr_decay=fix)
    port, ref = tstep.TrainSetup(**kw), jstep.TrainSetup(**kw)
    for count in (0, 1, 500, 1000):
        assert port.coarse_schedule()(count) == pytest.approx(
            float(ref.coarse_schedule()(jnp.int32(count))), rel=1e-6)
        assert port.fine_schedule()(count) == pytest.approx(
            float(ref.fine_schedule()(jnp.int32(count))), rel=1e-6)
    assert port.coarse_schedule()(0) == (2e-3 if fix else 5e-4)


@pytest.mark.parametrize("clip", [None, 0.05])
def test_adam_updates_match_optax(clip):
    """Three updates with a decaying rate (the first at schedule(0)) and
    optional elementwise clip, on the same grads."""
    rng = np.random.default_rng(0)
    w0 = rng.normal(size=(5, 7)).astype(np.float32)
    grads = [rng.normal(size=(5, 7)).astype(np.float32) * 0.1
             for _ in range(3)]
    sched = dict(base_lr=1e-2, lrate_decay=0.001)      # x0.1 per step
    tx = joptim.make_adam(joptim.exp_decay_schedule(**sched), clip)
    w, st = jnp.asarray(w0), None
    st = tx.init(w)
    p = torch.nn.Parameter(torch.from_numpy(w0.copy()))
    opt = optim.make_adam([p], optim.exp_decay_schedule(**sched), clip)
    for g in grads:
        up, st = tx.update(jnp.asarray(g), st, w)
        w = optax.apply_updates(w, up)
        p.grad = torch.from_numpy(g.copy())
        opt.step()
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(w),
                                   atol=1e-7, rtol=1e-6)
    assert opt.count == 3


# --------------------------------------------------------------- batching --

def _scene():
    images, poses, hwf, K = synthetic.make_sphere_dataset(4, 16, 20)
    ref = jsynthetic.make_sphere_dataset(4, 16, 20)
    for a, b in zip((images, poses, K), (ref[0], ref[1], ref[3])):
        np.testing.assert_array_equal(a, b)
    return images, poses, hwf, K


@pytest.mark.parametrize("ndc,precrop", [(False, False), (False, True),
                                         (True, False)])
def test_one_image_batch_matches_jax_on_injected_draws(ndc, precrop):
    images, poses, hwf, K = _scene()
    i_train = np.array([0, 2, 3])
    key = jax.random.PRNGKey(3)
    ref = jbatching.sample_one_image_batch(
        jnp.asarray(images), jnp.asarray(poses), K, jnp.asarray(i_train), key,
        32, 2.0, 6.0, True, precrop, 0.5, ndc, hwf[2])
    # the JAX function's own draws, replayed from its key
    kimg, kpix = jax.random.split(key)
    ti = jax.random.randint(kimg, (), 0, 3)
    y, x = jbatching.select_pixels(kpix, 16, 20, 32, precrop, 0.5)
    draws = tuple(np.asarray(a) for a in (ti, y, x))
    got = batching.sample_one_image_batch(
        t(images), t(poses), K, torch.from_numpy(i_train), None, 32, 2.0,
        6.0, True, precrop, 0.5, ndc, hwf[2], draws=draws)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), atol=1e-6,
                               rtol=1e-6)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    assert int(got[2]) == int(ref[2])


@pytest.mark.parametrize("precrop", [False, True])
def test_select_pixels_bounds(precrop):
    H, W = 40, 30
    g = torch.Generator().manual_seed(0)
    y, x = batching.select_pixels(g, H, W, 4000, precrop, 0.5)
    jy, jx = jbatching.select_pixels(jax.random.PRNGKey(0), H, W, 4000,
                                     precrop, 0.5)
    for a, b in ((y, np.asarray(jy)), (x, np.asarray(jx))):
        assert int(a.min()) == int(b.min()) and int(a.max()) == int(b.max())
    if precrop:
        assert (10, 29, 8, 21) == (int(y.min()), int(y.max()), int(x.min()),
                                   int(x.max()))


def test_ray_pool_matches_jax():
    images, poses, _, K = _scene()
    pool = batching.build_ray_pool(images, poses, K, [1, 3], seed=4)
    ref = jbatching.build_ray_pool(images, poses, K, [1, 3], seed=4)
    np.testing.assert_allclose(pool, ref, atol=1e-6, rtol=1e-6)
    got = batching.pool_batch(t(pool), 40, 24, 2.0, 6.0, True)
    want = jbatching.pool_batch(jnp.asarray(pool), 40, 24, 2.0, 6.0, True)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)


# ------------------------------------------------------------ render loss --

def _ray_batch(R, seed=7):
    """Rays from a radius-4 sphere toward the centre; ray 0 three times as
    long (its transmittance underflows to 0 mid-ray under a lifted
    density)."""
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(R, 3)).astype(np.float32)
    o = 4.0 * o / np.linalg.norm(o, axis=-1, keepdims=True)
    d = -o / 4.0 + 0.1 * rng.normal(size=(R, 3)).astype(np.float32)
    vd = d / np.linalg.norm(d, axis=-1, keepdims=True)
    d[0] *= 3.0
    return np.concatenate([o, d, np.full((R, 1), 2.0, np.float32),
                           np.full((R, 1), 6.0, np.float32), vd],
                          -1).astype(np.float32)


def _params(lift):
    pc, pf = np_params(KW, seed=0), np_params(KW, seed=1)
    for p in (pc, pf):
        p["alpha_linear"]["b"] = p["alpha_linear"]["b"] + lift
    return pc, pf


def _grads_of(models):
    return {f"{i}.{k}": q.grad.numpy() for i, m in enumerate(models)
            for k, q in m.named_parameters()}


def _jax_grads(gc, gf):
    out = {}
    for i, g in enumerate((gc, gf)):
        sd = convert_jax.params_to_state_dict(jax.tree.map(np.asarray, g))
        out.update({f"{i}.{k}": v for k, v in sd.items()})
    return out


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("perturb", [False, True])
def test_render_loss_value_and_grads_match_jax(fused, perturb, monkeypatch):
    rkw = dict(n_samples=16, n_importance=8, mode="linear", white_bkgd=True,
               perturb=perturb)
    R = 12
    pc, pf = _params(lift=12.0)
    rb = _ray_batch(R)
    rng = np.random.default_rng(9)
    target = rng.uniform(size=(R, 3)).astype(np.float32)
    ov = None
    if perturb:
        ov = {"t_rand": rng.uniform(size=(R, 16)).astype(np.float32),
              "u": rng.uniform(size=(R, 8)).astype(np.float32)}
        orig = jstep.render.render_rays
        monkeypatch.setattr(
            jstep.render, "render_rays",
            lambda *a, **k: orig(*a, **k, overrides={
                n: jnp.asarray(v) for n, v in ov.items()}))
    jsetup = jstep.TrainSetup(mcfg=JModelConfig(**KW),
                              rcfg=JRenderConfig(**rkw))
    batch = {"rays": jnp.asarray(rb), "target": jnp.asarray(target)}
    (ref_loss, ref_m), (gc, gf) = jax.value_and_grad(
        lambda both: jstep._render_loss(both[0], both[1], batch,
                                        jax.random.PRNGKey(0), jsetup),
        has_aux=True)((pc, pf))

    setup = tstep.TrainSetup(mcfg=ModelConfig(**KW), rcfg=RenderConfig(
        **rkw, use_fused_mlp=fused, fused_fold_heads=fused))
    mc, mf = torch_model(KW, pc), torch_model(KW, pf)
    loss, metrics = tstep._render_loss(
        mc, mf, {"rays": t(rb), "target": t(target)}, None, setup,
        overrides=ov)
    loss.backward()
    assert float(loss) == pytest.approx(float(ref_loss), rel=1e-5)
    for k in ("img_loss", "psnr", "img_loss0", "psnr0", "sigma0_pos_frac",
              "loss"):
        assert float(metrics[k]) == pytest.approx(float(ref_m[k]), rel=1e-5,
                                                  abs=1e-6), k
    got, ref = _grads_of((mc, mf)), _jax_grads(gc, gf)
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], atol=1e-5, rtol=1e-3,
                                   err_msg=k)

    # ray 0's coarse transmittance reaches 0 before the far boundary
    with torch.no_grad():
        rays = t(rb)
        z = sampling.stratified_z_vals(rays[:, 6:7], rays[:, 7:8], 16, False,
                                       None if ov is None else t(ov["t_rand"]))
        pts = rays[:, None, 0:3] + rays[:, None, 3:6] * z[..., None]
        raw = mlp.query_network(mc, pts, rays[:, 8:11], ModelConfig(**KW))
        _, _, T = quadrature.compute_weights_piecewise_linear(
            raw[..., 3], z, rays[:, 6:7], rays[:, 7:8], rays[:, 3:6])
    assert float(T[0, 1:-1].min()) == 0.0 and float(T[1:, -2].min()) > 0.0


# ------------------------------------------------------------ trajectories --

def _batches(n_steps, R, seed=11):
    images, poses, hwf, K = synthetic.make_sphere_dataset(4, 24, 24)
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_steps):
        draws = (rng.integers(0, 4), rng.integers(0, 24, R),
                 rng.integers(0, 24, R))
        rays, target, _ = batching.sample_one_image_batch(
            t(images), t(poses), K, torch.arange(4), None, R, 2.0, 6.0, True,
            draws=draws)
        out.append((rays.numpy(), target.numpy()))
    return out


TRAJ = {
    "two_optimizers": dict(),
    "joint": dict(joint_optimizer=True),
    "accum_chunks_2": dict(accum_chunks=2),
    "constant_init": dict(constant_init=True),
}


@pytest.mark.parametrize("name", list(TRAJ))
def test_trajectory_matches_jax(name):
    """20 steps, perturb off, the same batches on both sides; the port's
    MLP runs through the fused path (its plain versions here).  Loss per
    step to 1e-3 relative.  Weights after 20 steps: each tensor's update
    (w_20 - w_0) within 5% of the JAX update in L2 norm.  Adam divides
    each grad by its running RMS, so a float32 rounding difference of
    1e-8 in a grad of 1e-7 moves its weight by a visible fraction of the
    rate (up to 3% of the update in the constant-quadrature run, under
    0.2% in the others); the grads themselves are held to 1e-5 in
    ``test_render_loss_value_and_grads_match_jax``."""
    kw = dict(TRAJ[name])
    rkw = dict(n_samples=16, n_importance=8, mode="linear", white_bkgd=True,
               perturb=False, constant_init=kw.pop("constant_init", False))
    skw = dict(lrate=5e-3, coarse_lrate=5e-3, lrate_decay=1, **kw)
    pc, pf = _params(lift=0.5)

    jsetup = jstep.TrainSetup(mcfg=JModelConfig(**KW),
                              rcfg=JRenderConfig(**rkw), **skw)
    fine, coarse, _ = jsetup.make_optimizers()
    if jsetup.joint_optimizer:
        jstate = JTrainState(step=jnp.int32(0), params_coarse=pc,
                             params_fine=pf, opt_coarse=None,
                             opt_fine=fine.init((pc, pf)))
    else:
        jstate = JTrainState(step=jnp.int32(0), params_coarse=pc,
                             params_fine=pf, opt_coarse=coarse.init(pc),
                             opt_fine=fine.init(pf))
    jfn = jax.jit(jstep.build_one_step(jsetup))

    setup = tstep.TrainSetup(mcfg=ModelConfig(**KW), rcfg=RenderConfig(
        **rkw, use_fused_mlp=True, fused_fold_heads=True), **skw)
    state = tstep.init_state(torch.Generator().manual_seed(0), setup, "cpu")
    convert_jax.load_jax_params(state.params_coarse, pc)
    convert_jax.load_jax_params(state.params_fine, pf)
    step_fn = tstep.make_train_step(setup)

    for i, (rays, target) in enumerate(_batches(20, 32)):
        jstate, jm = jfn(jstate, {"rays": jnp.asarray(rays),
                                  "target": jnp.asarray(target)},
                         jax.random.PRNGKey(i))
        state, m = step_fn(state, {"rays": t(rays), "target": t(target)})
        assert float(m["loss"]) == pytest.approx(float(jm["loss"]),
                                                 rel=1e-3), i
    assert state.step == 20 and int(jstate.step) == 20
    for model, params, p0 in ((state.params_coarse, jstate.params_coarse, pc),
                              (state.params_fine, jstate.params_fine, pf)):
        ref, ref0 = (convert_jax.params_to_state_dict(
            jax.tree.map(np.asarray, q)) for q in (params, p0))
        for k, q in model.state_dict().items():
            step = np.linalg.norm(ref[k] - ref0[k])
            assert np.linalg.norm(q.numpy() - ref[k]) <= 0.05 * step, k


def test_train_step_defaults_to_cuda():
    """The training entry point runs on the card unless the CPU is asked
    for; without CUDA it raises instead of falling back."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        tstep.init_state(None, tstep.TrainSetup())


@pytest.mark.parametrize("remat", [False, True])
def test_remat_mlp_keeps_grads(remat):
    """``remat_mlp`` recomputes the MLP query in the backward pass
    (torch.utils.checkpoint) with the same loss and grads."""
    rkw = dict(n_samples=8, n_importance=8, mode="linear", white_bkgd=True,
               perturb=False, use_fused_mlp=True)
    pc, pf = _params(lift=0.5)
    rb, target = t(_ray_batch(6)), torch.rand(6, 3,
                                              generator=torch.Generator())
    out = []
    for flag in (False, remat):
        setup = tstep.TrainSetup(mcfg=ModelConfig(**KW), rcfg=RenderConfig(
            **rkw, remat_mlp=flag))
        mc, mf = torch_model(KW, pc), torch_model(KW, pf)
        loss, _ = tstep._render_loss(mc, mf, {"rays": rb, "target": target},
                                     None, setup)
        loss.backward()
        out.append((float(loss), _grads_of((mc, mf))))
    assert out[0][0] == out[1][0]
    for k in out[0][1]:
        np.testing.assert_array_equal(out[0][1][k], out[1][1][k])
