"""The port's depth supervision against the JAX package on the CPU: the
space-carving loss (every branch, values and gradients against
``jax.grad``) and ``get_space_carving_idx``; one ``make_depth_train_step``
from one converted mid-training state (Adam moments included) in each
flavour; a 20-step trajectory across the warm start and the scale / shift
freeze; the depth loaders; test-time camera optimization; and the depth
state's checkpoint.  Inputs are made with numpy from a seed; the renderer's
draws are injected into both packages; the port's fused MLP runs its plain
versions here.

Tolerances: loss values 1e-6, their gradients 1e-5; a step's loss 1e-5
relative and every tensor it updates 1e-7 + 1e-6 relative (Adam's), its
moments 1e-7 + 1e-5 relative (a tenth of a grad's); trajectories as
``test_torch_train``'s (loss 1e-3 relative, each update within 5% in L2);
loaders equal; the camera embedding 1e-4."""
import dataclasses
import os

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from plnerf.core.config import ModelConfig as JModelConfig
from plnerf.core.config import RenderConfig as JRenderConfig
from plnerf.data import blender as jblender
from plnerf.train import camera_opt as jcamera_opt
from plnerf.train import losses as jlosses
from plnerf.train import step as jstep
from plnerf_torch.checkpoint import convert_jax
from plnerf_torch.checkpoint import io as ckio
from plnerf_torch.core.config import ModelConfig, RenderConfig
from plnerf_torch.data import blender
from plnerf_torch.train import camera_opt, losses
from plnerf_torch.train import step as tstep

from fixtures import make_blender2_scene
from test_torch_mlp import t
from test_torch_render import _ray_batch

torch.set_num_threads(1)

# the depth recipe's topology at a small width: pi bands, no view
# encoding, softplus10 density, Xavier init
MKW = dict(netdepth=3, netwidth=32, multires=4, multires_views=0,
           pi_bands=True, density_activation="softplus10", init="xavier")
N_IMAGES = 4


# ------------------------------------------------------------------ losses --

def _sc_inputs(H, full, seed=0):
    rng = np.random.default_rng(seed)
    R, N = 6, 5
    pred = rng.uniform(2, 6, (R, N)).astype(np.float32)
    target = rng.uniform(2, 6, (H, R, N if full else 1)).astype(np.float32)
    mask = (rng.uniform(size=R) > 0.3).astype(np.float32)
    return pred, target, mask


SC_CASES = [dict(H=H, full=full, is_joint=joint, masked=masked,
                 threshold=thr)
            for H in (1, 3) for full in (False, True)
            for joint in (False, True) for masked in (False, True)
            for thr in (0.0, 0.8)]


@pytest.mark.parametrize(
    "case", SC_CASES,
    ids=[f"H{c['H']}-{'N' if c['full'] else '1'}"
         f"-{'joint' if c['is_joint'] else 'ray'}"
         f"-{'mask' if c['masked'] else 'nomask'}-thr{c['threshold']}"
         for c in SC_CASES])
def test_space_carving_loss_matches_jax(case):
    pred, target, mask = _sc_inputs(case["H"], case["full"])
    m = mask if case["masked"] else None
    kw = dict(is_joint=case["is_joint"], threshold=case["threshold"])

    def jloss(p, tg):
        return jlosses.space_carving_loss(
            p, tg, mask=None if m is None else jnp.asarray(m), **kw)

    ref, (gp_ref, gt_ref) = jax.value_and_grad(jloss, argnums=(0, 1))(
        jnp.asarray(pred), jnp.asarray(target))
    p, tg = t(pred).requires_grad_(), t(target).requires_grad_()
    got = losses.space_carving_loss(p, tg, mask=t(m), **kw)
    got.backward()
    assert float(got.detach()) == pytest.approx(float(ref), abs=1e-6)
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(gp_ref), atol=1e-5)
    np.testing.assert_allclose(tg.grad.numpy(), np.asarray(gt_ref),
                               atol=1e-5)


@pytest.mark.parametrize("is_joint", [False, True])
@pytest.mark.parametrize("masked,threshold", [(False, 0.0), (True, 0.5)])
def test_space_carving_idx_matches_jax(is_joint, masked, threshold):
    rng = np.random.default_rng(1)
    H, W, N, n_hyp = 4, 5, 3, 3
    pred = rng.uniform(2, 6, (H, W, N)).astype(np.float32)
    hyp = rng.uniform(2, 6, (n_hyp, H, W, 1)).astype(np.float32)
    mask = ((rng.uniform(size=(H, W, 1)) > 0.3).astype(np.float32)
            if masked else None)
    kw = dict(is_joint=is_joint, threshold=threshold)
    ref = jlosses.get_space_carving_idx(
        jnp.asarray(pred), jnp.asarray(hyp),
        mask=None if mask is None else jnp.asarray(mask), **kw)
    got = losses.get_space_carving_idx(t(pred), t(hyp), mask=t(mask), **kw)
    assert got.dtype == torch.int32 and got.shape == (H, W, N)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


# -------------------------------------------------------------- the step --

def _setups(skw, rkw, cam):
    mkw = dict(MKW, input_ch_cam=2 if cam else 0)
    skw = dict(lrate=5e-3, joint_optimizer=True, grad_clip_value=0.1,
               space_carving_weight=0.5, scaleshift_lr=1e-3,
               opt_ch_cam=cam, ch_cam_lr=1e-2, start_decay_lrate=4,
               end_decay_lrate=30, **skw)
    rkw = dict(n_samples=12, n_importance=8, mode="linear", white_bkgd=True,
               compute_pred_hyp=True, **rkw)
    jsetup = jstep.TrainSetup(mcfg=JModelConfig(**mkw),
                              rcfg=JRenderConfig(**rkw), **skw)
    setup = tstep.TrainSetup(mcfg=ModelConfig(**mkw), rcfg=RenderConfig(
        **rkw, use_fused_mlp=True, fused_fold_heads=True), **skw)
    return jsetup, setup


def _adam_states(opt_state):
    """The optax Adam state inside an optimizer's state."""
    def is_adam(s):
        return isinstance(s, optax.ScaleByAdamState)

    (adam,) = [s for s in jax.tree_util.tree_leaves(opt_state,
                                                    is_leaf=is_adam)
               if is_adam(s)]
    return adam


def _with_moments(opt_state, rng, count):
    """``opt_state`` with random Adam moments and ``count`` updates made."""
    kinds = (optax.ScaleByAdamState, optax.ScaleByScheduleState)

    def fill(s):
        if isinstance(s, optax.ScaleByAdamState):
            return s._replace(
                count=jnp.int32(count),
                mu=jax.tree.map(lambda x: jnp.asarray(
                    rng.normal(0, 1e-2, x.shape), jnp.float32), s.mu),
                nu=jax.tree.map(lambda x: jnp.asarray(
                    rng.uniform(1e-5, 1e-3, x.shape), jnp.float32), s.nu))
        if isinstance(s, optax.ScaleByScheduleState):
            return s._replace(count=jnp.int32(count))
        return s

    return jax.tree.map(fill, opt_state,
                        is_leaf=lambda s: isinstance(s, kinds))


def _both_states(jsetup, setup, seed=0, count=0):
    """A JAX depth state (random scales, shifts, embeddings and, with
    ``count``, Adam moments) and the port's state converted from it."""
    rng = np.random.default_rng(seed)
    js = jstep.init_state(jax.random.PRNGKey(seed), jsetup,
                          n_images=N_IMAGES)
    rep = dict(depth_scales=jnp.asarray(rng.uniform(0.8, 1.2, (N_IMAGES, 1)),
                                        jnp.float32),
               depth_shifts=jnp.asarray(rng.uniform(-0.2, 0.2, (N_IMAGES, 1)),
                                        jnp.float32))
    if js.cam_embeddings is not None:
        rep["cam_embeddings"] = jnp.asarray(
            rng.normal(0, 0.5, js.cam_embeddings.shape), jnp.float32)
    if count:
        rep.update(step=jnp.int32(count),
                   opt_fine=_with_moments(js.opt_fine, rng, count),
                   opt_ss=_with_moments(js.opt_ss, rng, count))
        if js.opt_latent is not None:
            rep["opt_latent"] = _with_moments(js.opt_latent, rng, count)
    js = js.replace(**rep)

    ps = tstep.init_state(torch.Generator().manual_seed(0), setup, "cpu",
                          n_images=N_IMAGES)
    for module, params in ((ps.params_coarse, js.params_coarse),
                           (ps.params_fine, js.params_fine)):
        convert_jax.load_jax_params(module, jax.tree.map(np.asarray, params))
    convert_jax.load_depth_fields(
        ps, np.asarray(js.depth_scales), np.asarray(js.depth_shifts),
        None if js.cam_embeddings is None else np.asarray(js.cam_embeddings))
    ps.step = int(js.step)
    if count:
        a = _adam_states(js.opt_fine)
        convert_jax.load_adam_state(ps.opt_fine, _net_leaves(ps, a.mu),
                                    _net_leaves(ps, a.nu), count)
        a = _adam_states(js.opt_ss)                  # (scales, shifts)
        convert_jax.load_adam_state(ps.opt_ss, [np.asarray(x) for x in a.mu],
                                    [np.asarray(x) for x in a.nu], count)
        if js.opt_latent is not None:
            a = _adam_states(js.opt_latent)
            convert_jax.load_adam_state(ps.opt_latent, [np.asarray(a.mu)],
                                        [np.asarray(a.nu)], count)
    return js, ps


def _net_leaves(ps, pair):
    """A (coarse, fine) pytree pair of JAX-layout arrays, as the joint
    optimizer's parameter order."""
    return (convert_jax.params_leaves(ps.params_coarse,
                                      jax.tree.map(np.asarray, pair[0]))
            + convert_jax.params_leaves(ps.params_fine,
                                        jax.tree.map(np.asarray, pair[1])))


def _batches(n, R, n_s, n_i, joint, seed=5):
    """n batches of R rays with depth hypotheses, masks and images, and
    the renderer's draws for each (``u_hyp`` one row per batch when
    ``joint``)."""
    rng = np.random.default_rng(seed)
    out = []
    for k in range(n):
        u_hyp = rng.uniform(size=(R, n_i)).astype(np.float32)
        if joint:
            u_hyp = np.broadcast_to(u_hyp[:1], u_hyp.shape).copy()
        out.append(({"rays": _ray_batch(R, seed=seed + k),
                     "target": rng.uniform(size=(R, 3)).astype(np.float32),
                     "target_h": rng.uniform(2.5, 5.5, (1, R, 1)).astype(
                         np.float32),
                     "sc_mask": (rng.uniform(size=R) > 0.2).astype(
                         np.float32),
                     "img_idx": int(rng.integers(0, N_IMAGES))},
                    {"t_rand": rng.uniform(size=(R, n_s)).astype(np.float32),
                     "u": rng.uniform(size=(R, n_i)).astype(np.float32),
                     "u_hyp": u_hyp}))
    return out


def _inject_jax_draws(monkeypatch, draws):
    """Make the JAX renderer take step k's draws when its key is
    ``PRNGKey(k)`` (one jit serves every step)."""
    table = {n: jnp.asarray(np.stack([d[n] for d in draws]))
             for n in draws[0]}
    orig = jstep.render.render_rays

    def wrapped(*a, **k):
        i = a[3][-1]
        return orig(*a, **k, overrides={n: v[i] for n, v in table.items()})

    monkeypatch.setattr(jstep.render, "render_rays", wrapped)


def _jbatch(b):
    return {k: (jnp.int32(v) if k == "img_idx" else jnp.asarray(v))
            for k, v in b.items()}


def _tbatch(b):
    return {k: (v if k == "img_idx" else t(v)) for k, v in b.items()}


def _port_tensors(ps):
    """{name: array} of every tensor a port depth step updates."""
    out = {f"{i}.{k}": q.detach().numpy().copy()
           for i, module in enumerate((ps.params_coarse, ps.params_fine))
           for k, q in module.named_parameters()}
    for name in ("depth_scales", "depth_shifts", "cam_embeddings"):
        if getattr(ps, name) is not None:
            out[name] = getattr(ps, name).detach().numpy().copy()
    return out


def _tensors(ps, js):
    """(name, port array, JAX array) of every tensor a step updates."""
    got, ref = _port_tensors(ps), {}
    for i, params in enumerate((js.params_coarse, js.params_fine)):
        sd = convert_jax.params_to_state_dict(jax.tree.map(np.asarray,
                                                           params))
        ref.update({f"{i}.{k}": v for k, v in sd.items()})
    for name in ("depth_scales", "depth_shifts", "cam_embeddings"):
        if getattr(js, name) is not None:
            ref[name] = np.asarray(getattr(js, name))
    assert set(got) == set(ref)
    return [(n, got[n], ref[n]) for n in ref]


STEP_CASES = {
    "space_carving": (dict(freeze_ss=100), dict(), False),
    "warm_start": (dict(freeze_ss=100, warm_start_nerf=50), dict(), False),
    "frozen": (dict(freeze_ss=0), dict(), False),
    "is_joint": (dict(freeze_ss=100, is_joint=True), dict(is_joint=True),
                 False),
    "opt_ch_cam": (dict(freeze_ss=100), dict(), True),
}


@pytest.mark.parametrize("name", list(STEP_CASES))
def test_depth_step_matches_jax(name, monkeypatch):
    """One step from a converted state with 3 updates' worth of Adam
    moments, on the same batch and draws.  ``warm_start``: the
    space-carving weight is 0 but its term stays in the graph, so the
    scale / shift Adam still steps on zero grads (their stale moments move
    every image's row).  ``frozen``: the values hold while the moments
    advance."""
    skw, rkw, cam = STEP_CASES[name]
    jsetup, setup = _setups(skw, rkw, cam)
    js, ps = _both_states(jsetup, setup, count=3)
    (batch, draws), = _batches(1, 16, 12, 8, rkw.get("is_joint", False))
    _inject_jax_draws(monkeypatch, [draws])
    js1, jm = jstep.make_depth_train_step(jsetup)(js, _jbatch(batch),
                                                  jax.random.PRNGKey(0))
    before = _port_tensors(ps)
    ps, m = tstep.make_depth_train_step(setup)(ps, _tbatch(batch), None,
                                               draws)
    assert ps.step == int(js1.step) == 4
    assert set(m) == set(jm)
    for k in jm:
        assert float(m[k]) == pytest.approx(float(jm[k]), rel=1e-5,
                                            abs=1e-7), k
    for n, got, ref in _tensors(ps, js1):
        np.testing.assert_allclose(got, ref, atol=1e-7, rtol=1e-6,
                                   err_msg=n)
    moved = {n: not np.array_equal(a, before[n])
             for n, a, _ in _tensors(ps, js1)}
    assert moved["depth_scales"] == moved["depth_shifts"] == (
        name != "frozen")
    if name == "opt_ch_cam":
        assert moved["cam_embeddings"]
    # the scale / shift moments advance, frozen or not
    ref_ss = _adam_states(js1.opt_ss)
    for q, mu, nu in zip((ps.depth_scales, ps.depth_shifts), ref_ss.mu,
                         ref_ss.nu):
        st = ps.opt_ss.state[q]
        assert float(st["step"]) == int(ref_ss.count) == 4
        np.testing.assert_allclose(st["exp_avg"].numpy(), np.asarray(mu),
                                   atol=1e-7, rtol=1e-5)
        np.testing.assert_allclose(st["exp_avg_sq"].numpy(), np.asarray(nu),
                                   atol=1e-7, rtol=1e-5)


def test_depth_trajectory_matches_jax():
    """20 steps from one init, perturb off, camera embeddings trained,
    across the warm start (space carving from step 5) and the scale /
    shift freeze (held from step 12): loss per step to 1e-3 relative, each
    tensor's 20-step update within 5% of the JAX update in L2 (see
    ``test_torch_train.test_trajectory_matches_jax``)."""
    jsetup, setup = _setups(dict(warm_start_nerf=5, freeze_ss=12),
                            dict(perturb=False), cam=True)
    js, ps = _both_states(jsetup, setup)
    js0 = jax.tree.map(np.asarray, js)
    jfn = jstep.make_depth_train_step(jsetup)
    step_fn = tstep.make_depth_train_step(setup)
    scales = []
    for i, (batch, _) in enumerate(_batches(20, 24, 12, 8, False, seed=9)):
        js, jm = jfn(js, _jbatch(batch), jax.random.PRNGKey(i))
        ps, m = step_fn(ps, _tbatch(batch))
        assert float(m["loss"]) == pytest.approx(float(jm["loss"]),
                                                 rel=1e-3), i
        assert float(m["space_carving_loss"]) == pytest.approx(
            float(jm["space_carving_loss"]), rel=1e-3), i
        scales.append(ps.depth_scales.detach().clone())
    assert ps.step == int(js.step) == 20
    # frozen once step + 1 >= 12: the values after step 11 hold
    assert all(torch.equal(s, scales[10]) for s in scales[11:])
    assert not torch.equal(scales[10], scales[0])
    ref0 = {n: r for n, _, r in _tensors(ps, js0)}
    for n, got, ref in _tensors(ps, js):
        step = np.linalg.norm(ref - ref0[n])
        assert np.linalg.norm(got - ref) <= 0.05 * step + 1e-9, n


# ----------------------------------------------------------------- loaders --

def _write_bgr_depths(scene):
    """Replace every depth png by an 8-bit 3-channel png whose channels
    differ, written by cv2 (so the file's first channel is cv2's blue)."""
    import cv2

    rng = np.random.default_rng(0)
    for split in ("train", "test"):
        for name in os.listdir(os.path.join(scene, split)):
            if name.startswith("d_"):
                d = rng.integers(0, 256, (32, 32, 3)).astype(np.uint8)
                d[..., 1] = 255 - d[..., 0]
                cv2.imwrite(os.path.join(scene, split, name), d)


@pytest.mark.parametrize("half_res", [False, True])
@pytest.mark.parametrize("depth_png", ["gray16", "bgr8"])
def test_blender2_depth_loader_matches_jax(tmp_path, half_res, depth_png):
    """The fixture's 16-bit gray depth pngs, or 8-bit 3-channel ones."""
    scene = make_blender2_scene(str(tmp_path / "s"), n_train=3, n_test=9,
                                with_depth=True)
    if depth_png == "bgr8":
        _write_bgr_depths(scene)
    got = blender.load_blender2_depth(scene, half_res=half_res,
                                      near_plane=2.0)
    ref = jblender.load_blender2_depth(scene, half_res=half_res,
                                       near_plane=2.0)
    for k in ("images", "poses", "intrinsics", "depths", "valid_depths",
              "gt_depths", "gt_valid_depths", "render_poses"):
        a, b = getattr(got, k), getattr(ref, k)
        assert a.shape == b.shape and a.dtype == b.dtype, k
        np.testing.assert_array_equal(a, b, err_msg=k)
    assert got.hwf == ref.hwf and (got.near, got.far) == (ref.near, ref.far)
    assert [list(s) for s in got.i_split] == [list(s) for s in ref.i_split]
    # 3 train, no val, test frames 0 and 8, 40 made-up video poses; depth
    # at full size under half_res
    assert [len(s) for s in got.i_split] == [3, 0, 2, 40]
    assert got.depths.shape == (5, 32, 32, 3 if depth_png == "bgr8" else 1)
    assert got.valid_depths.any()
    if depth_png == "bgr8":
        assert not np.array_equal(got.depths[..., 0], got.depths[..., 2])


def test_blender_depth_loader_matches_jax(tmp_path):
    """``transforms_{split}.json`` naming, depth png at ``depth_file_path``
    + "0001.png" for a scene whose path names no chair."""
    scene = make_blender2_scene(str(tmp_path / "s"), n_train=2, n_test=2,
                                with_depth=True)
    for split in ("train", "test"):
        os.rename(os.path.join(scene, f"{split}_transforms.json"),
                  os.path.join(scene, f"transforms_{split}.json"))
        for i in range(2):
            os.rename(os.path.join(scene, split, f"d_{i}.png"),
                      os.path.join(scene, split, f"d_{i}x0001.png"))
    got = blender.load_blender_depth(scene, half_res=False)
    ref = jblender.load_blender_depth(scene, half_res=False)
    for k in ("images", "poses", "intrinsics", "depths", "valid_depths"):
        np.testing.assert_array_equal(getattr(got, k), getattr(ref, k),
                                      err_msg=k)


# -------------------------------------------------------------- camera opt --

def test_camera_optimization_matches_jax():
    """Three epochs of test-time optimization of a 4-channel embedding on
    a 12x16 image (6 batches of 32 rays), the network frozen."""
    mkw = dict(MKW, input_ch_cam=4)
    rkw = dict(n_samples=8, n_importance=8, mode="linear", white_bkgd=True)
    jsetup = jstep.TrainSetup(mcfg=JModelConfig(**mkw),
                              rcfg=JRenderConfig(**rkw))
    js = jstep.init_state(jax.random.PRNGKey(2), jsetup)
    rng = np.random.default_rng(4)
    image = rng.uniform(size=(12, 16, 3)).astype(np.float32)
    from plnerf_torch.data.synthetic import pose_spherical_np

    pose = pose_spherical_np(30.0, -30.0, 4.0)
    intr = np.array([14.0, 14.0, 8.0, 6.0], np.float32)
    kw = dict(near=2.0, far=6.0, n_rand=16, epochs=3, lr=0.5, seed=3)
    ref = jcamera_opt.optimize_camera_embedding(
        js.params_coarse, js.params_fine, image, pose, intr, JModelConfig(
            **mkw), JRenderConfig(**rkw), **kw)
    setup = tstep.TrainSetup(mcfg=ModelConfig(**mkw), rcfg=RenderConfig(
        **rkw, use_fused_mlp=True, fused_fold_heads=True))
    ps = tstep.init_state(None, setup, "cpu")
    for module, params in ((ps.params_coarse, js.params_coarse),
                           (ps.params_fine, js.params_fine)):
        convert_jax.load_jax_params(module, jax.tree.map(np.asarray, params))
    history = []
    got = camera_opt.optimize_camera_embedding(
        ps.params_coarse, ps.params_fine, image, pose, intr, setup.mcfg,
        setup.rcfg, history=history, **kw)
    assert len(history) == 3 and np.isfinite(history).all()
    assert float(np.abs(np.asarray(ref)).max()) > 0.1     # it moved
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4)
    assert all(q.grad is None for q in ps.params_fine.parameters())


# -------------------------------------------------------------- checkpoint --

def test_depth_checkpoint_round_trip_and_resume(tmp_path, monkeypatch):
    """A depth state after 3 steps (embeddings trained) saves and loads
    bit for bit into a fresh state, and its next step is bit-identical to
    the uninterrupted state's on the same batch and draws."""
    _, setup = _setups(dict(freeze_ss=100), dict(), cam=True)
    batches = _batches(4, 16, 12, 8, False, seed=21)
    step_fn = tstep.make_depth_train_step(setup)
    a = tstep.init_state(torch.Generator().manual_seed(0), setup, "cpu",
                         n_images=N_IMAGES)
    for batch, draws in batches[:3]:
        a, _ = step_fn(a, _tbatch(batch), None, draws)
    path = ckio.save_checkpoint(str(tmp_path), a.step, a.state_dict())
    b = tstep.init_state(torch.Generator().manual_seed(7), setup, "cpu",
                         n_images=N_IMAGES)
    ckio.restore_checkpoint(path, b, "cpu")
    sd_a, sd_b = a.state_dict(), b.state_dict()
    assert set(sd_a) == set(sd_b) >= {"depth_scales", "depth_shifts",
                                      "cam_embeddings", "opt_ss",
                                      "opt_latent"}
    assert b.step == 3 and b.opt_fine.count == b.opt_ss.count == 3
    for x, y in ((a.depth_scales, b.depth_scales),
                 (a.cam_embeddings, b.cam_embeddings)):
        assert torch.equal(x, y)
    batch, draws = batches[3]
    a, ma = step_fn(a, _tbatch(batch), None, draws)
    b, mb = step_fn(b, _tbatch(batch), None, draws)
    assert all(float(ma[k]) == float(mb[k]) for k in ma)
    ta, tb = _port_tensors(a), _port_tensors(b)
    for n in ta:
        np.testing.assert_array_equal(ta[n], tb[n], err_msg=n)
    # the optimizers still hold the loaded tensors
    assert b.opt_ss.param_groups[0]["params"][0] is b.depth_scales
    assert b.opt_latent.param_groups[0]["params"][0] is b.cam_embeddings


def test_nvs_state_refuses_a_depth_checkpoint(tmp_path):
    """A depth checkpoint's fields have no place in an NVS state."""
    _, setup = _setups(dict(), dict(), cam=False)
    a = tstep.init_state(None, setup, "cpu", n_images=N_IMAGES)
    nvs = tstep.init_state(None, dataclasses.replace(
        setup, space_carving_weight=0.0), "cpu")
    with pytest.raises(ValueError, match="depth_scales"):
        nvs.load_state_dict(a.state_dict())


# ------------------------------------------------------- the depth scene --

def test_multi_object_scene_matches_jax():
    """The multi-object scene and its expected-depth maps, numpy on both
    sides: equal to the JAX package's at a small size."""
    from plnerf.data import synthetic as jsynthetic
    from plnerf_torch.data import synthetic

    got = synthetic.make_multi_object_dataset(n_train=2, n_test=1, H=8,
                                              W=10, density=40.0)
    ref = jsynthetic.make_multi_object_dataset(n_train=2, n_test=1, H=8,
                                               W=10, density=40.0)
    assert set(got) == set(ref)
    for k in ("images", "poses", "depths", "K", "i_train", "i_test"):
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    assert got["hwf"] == ref["hwf"] and got["depths"].max() > 2.0
    for slab in (True, False):
        a = synthetic.render_scene_image(got["poses"][0], 6, 6, 7.0,
                                         slab=slab, n_march=64)
        b = jsynthetic.render_scene_image(ref["poses"][0], 6, 6, 7.0,
                                          slab=slab, n_march=64)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


def test_depth_scene_writer_reads_back(tmp_path):
    """``write_blender2_depth_scene`` in the layout both packages' loaders
    read alike; the depth comes back within one stored step of the
    render's, the images as the white-background render within 8-bit
    rounding."""
    from plnerf_torch.data import synthetic

    angle = 0.6911112070083618
    scene = synthetic.write_blender2_depth_scene(
        str(tmp_path / "mobj"), {"train": 2, "val": 1, "test": 9}, 16, 16,
        angle, n_march=128, workers=2)
    got = blender.load_blender2_depth(scene, half_res=False)
    ref = jblender.load_blender2_depth(scene, half_res=False)
    for k in ("images", "poses", "intrinsics", "depths", "valid_depths"):
        np.testing.assert_array_equal(getattr(got, k), getattr(ref, k),
                                      err_msg=k)
    assert [len(s) for s in got.i_split] == [2, 1, 2, 40]
    focal = 0.5 * 16 / np.tan(0.5 * angle)
    rgb, depth = synthetic.render_scene_image(
        got.poses[0], 16, 16, focal, n_march=128, pixel_center=True)
    step = synthetic.DEPTH_PNG_MAX_DEPTH / 255.0
    valid = got.valid_depths[0]
    assert valid.mean() > 0.3
    np.testing.assert_allclose(got.depths[0, ..., 0][valid], depth[valid],
                               atol=step)
    white = blender.apply_background(got.images[:1], True)[0]
    np.testing.assert_allclose(white, rgb, atol=2 / 255)
