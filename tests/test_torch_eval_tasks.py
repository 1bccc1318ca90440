"""The paper's two eval tasks in the port against the JAX package, on the
CPU: ``sample_pdf_reformulation_cdf``; ``render_rays`` with
``compute_pred_hyp`` (values and gradients through ``pred_hyp``), with
numpy-made draws injected into both renderers; ``test_images_samples``;
and the ``--task test_samples_error`` and ``--task test_fixed_dist``
drivers, from one set of weights, through the files they write.

Tolerances: values 1e-4 (fp32 renders of small MLPs); gradients 1e-4 in
float64, 1e-3 relative L2 in fp32 (see the gradient tests)."""
import dataclasses
import os
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from plnerf.checkpoint import io as jckio
from plnerf.cli import config as jconfig
from plnerf.cli import run_plnerf as jrun
from plnerf.core import render as jrender
from plnerf.core import sampling as jsamp
from plnerf.core.config import ModelConfig as JModelConfig
from plnerf.core.config import RenderConfig as JRenderConfig
from plnerf.eval import images as jimages
from plnerf.train import step as jstep
from plnerf_torch.checkpoint import convert_jax
from plnerf_torch.checkpoint import io as ckio
from plnerf_torch.cli import run_plnerf
from plnerf_torch.core import render, sampling
from plnerf_torch.core.config import ModelConfig, RenderConfig
from plnerf_torch.eval import images

from fixtures import make_blender_scene, make_fixed_dist_scene
from test_torch_mlp import np_params, t, torch_model
from test_torch_render import _ray_batch, close, j_render_rays

torch.set_num_threads(1)

KW = dict(netdepth=2, netwidth=16, multires=4, multires_views=2)


def test_sample_pdf_reformulation_cdf_matches_jax():
    rng = np.random.default_rng(0)
    R, S = 5, 12
    bins = np.sort(rng.uniform(2, 6, (R, S)).astype(np.float32), -1)
    w = rng.uniform(size=(R, S + 1)).astype(np.float32)
    w /= w.sum(-1, keepdims=True) * 1.01
    near = np.full((R, 1), 2.0, np.float32)
    far = np.full((R, 1), 6.0, np.float32)
    ref = jsamp.sample_pdf_reformulation_cdf(*map(jnp.asarray,
                                                  (bins, w, near, far)))
    got = sampling.sample_pdf_reformulation_cdf(*map(t, (bins, w, near,
                                                         far)))
    assert got.shape == (R, S + 2)
    close(got, ref, atol=1e-6)
    assert (got[:, 0] == 0).all() and (got[:, -1] == 1).all()


def _hyp_case(mode, n_importance, trim, seed=8):
    params_c, params_f = np_params(KW, seed=0), np_params(KW, seed=1)
    for p in (params_c, params_f):             # visible content
        p["alpha_linear"]["b"] = p["alpha_linear"]["b"] + 2.0
    rkw = dict(n_samples=16, n_importance=n_importance, mode=mode,
               white_bkgd=True, perturb=True, compute_pred_hyp=True,
               trim_first_weight=trim)
    R = 10
    rng = np.random.default_rng(seed)
    n_hyp = n_importance or rkw["n_samples"]
    ov = {"t_rand": rng.uniform(size=(R, 16)).astype(np.float32),
          "u": rng.uniform(size=(R, max(n_importance, 1))).astype(
              np.float32),
          "u_hyp": rng.uniform(size=(R, n_hyp)).astype(np.float32)}
    return params_c, params_f, rkw, _ray_batch(R), ov


@pytest.mark.parametrize("mode", ["linear", "constant"])
@pytest.mark.parametrize("n_importance", [8, 0])
@pytest.mark.parametrize("trim", [True, False])
def test_render_rays_pred_hyp_matches_jax(mode, n_importance, trim):
    params_c, params_f, rkw, rb, ov = _hyp_case(mode, n_importance, trim)
    ref = j_render_rays(params_c, params_f, jnp.asarray(rb),
                        jax.random.PRNGKey(0), mcfg=JModelConfig(**KW),
                        rcfg=JRenderConfig(**rkw),
                        overrides={k: jnp.asarray(v) for k, v in ov.items()})
    with torch.no_grad():
        got = render.render_rays(
            torch_model(KW, params_c), torch_model(KW, params_f), t(rb),
            None, ModelConfig(**KW), RenderConfig(**rkw), overrides=ov)
    hyp_keys = {"pred_hyp", "u", "weights", "z_vals"}
    if n_importance:
        hyp_keys |= {"weights0", "z_vals0"}
    assert hyp_keys <= set(got) and set(got) == set(ref)
    for k in sorted(hyp_keys | {"rgb_map", "depth_map"}):
        close(got[k], ref[k], atol=1e-4, rtol=1e-4, msg=k)
    # linear: one weight per interval of [near, z, far]; constant: per z
    n_w = rkw["n_samples"] + n_importance + (mode == "linear")
    assert got["weights"].shape[-1] == n_w - (mode == "linear" and trim)


def test_pred_hyp_joint_draws_share_one_vector():
    params_c, params_f, rkw, rb, _ = _hyp_case("linear", 8, True)
    rcfg = RenderConfig(**dict(rkw, is_joint=True))
    with torch.no_grad():
        got = render.render_rays(
            torch_model(KW, params_c), torch_model(KW, params_f), t(rb),
            torch.Generator().manual_seed(0), ModelConfig(**KW), rcfg)
    u = got["u"]
    assert u.shape == (rb.shape[0], 8) and (u == u[:1]).all()
    assert u.std() > 0


@pytest.mark.parametrize("n_importance", [8, 0])
@pytest.mark.parametrize("fused", [False, True])
def test_pred_hyp_grad_matches_jax(n_importance, fused):
    """pred_hyp is not detached: a loss on it reaches the weights of the
    pass it comes from (the fine pass, or the coarse without one) through
    tau and T, and no other weights.  In fp32 the inverse CDF's clamped
    denominators amplify rounding: on these inputs the port's fp32
    gradients lie up to 1.3e-3 in relative L2 from its float64 ones, the
    JAX package's up to 2.4e-3, in other directions.  So each tensor is
    held to the JAX package's within 1e-4 plus both packages' distances
    from the port's float64 gradient (the JAX one's at most 5e-3; the
    heads, which pred_hyp does not reach, exactly 0); the float64 test
    below holds the chain from the raw outputs to pred_hyp against the
    JAX package's at 1e-4."""
    params_c, params_f, rkw, rb, ov = _hyp_case("linear", n_importance,
                                                True)
    c = np.random.default_rng(9).normal(
        size=(rb.shape[0], n_importance or 16)).astype(np.float32)
    jov = {k: jnp.asarray(v) for k, v in ov.items()}

    def jloss(pc, pf):
        ret = jrender.render_rays(pc, pf, jnp.asarray(rb),
                                  jax.random.PRNGKey(0),
                                  JModelConfig(**KW), JRenderConfig(**rkw),
                                  overrides=jov)
        return jnp.sum(ret["pred_hyp"] * c)

    ref_c, ref_f = jax.jit(jax.grad(jloss, argnums=(0, 1)))(params_c,
                                                           params_f)
    grads = {}
    for dtype in (torch.float32, torch.float64):
        models = [torch_model(KW, p).to(dtype) for p in (params_c, params_f)]
        got = render.render_rays(
            *models, t(rb).to(dtype), None, ModelConfig(**KW),
            RenderConfig(**dict(rkw, use_fused_mlp=fused
                                and dtype == torch.float32)),
            overrides={k: t(v).to(dtype) for k, v in ov.items()})
        assert got["pred_hyp"].requires_grad
        (got["pred_hyp"] * t(c).to(dtype)).sum().backward()
        grads[dtype] = [[torch.zeros(p.shape, dtype=torch.float64)
                         if p.grad is None else p.grad.double()
                         for p in m.parameters()] for m in models]
    live = 1 if n_importance else 0
    for k, ref in enumerate((ref_c, ref_f)):
        conv = convert_jax.load_jax_params(
            torch_model(KW, params_c), jax.tree.map(np.array, ref))
        for (name, r), g, g64 in zip(conv.named_parameters(),
                                     grads[torch.float32][k],
                                     grads[torch.float64][k]):
            r = r.detach().double()
            if k != live or float(g64.norm()) == 0:    # no path to pred_hyp
                assert float(g.abs().max()) == float(r.abs().max()) == 0
                continue
            err = float((g - r).norm() / r.norm())
            own = float((g - g64).norm() / g64.norm())
            own_jax = float((r - g64).norm() / g64.norm())
            assert own_jax <= 5e-3, (name, own_jax)
            assert err <= 1e-4 + own + own_jax, (name, err, own, own_jax)


@pytest.mark.parametrize("seed", [0, 1])
def test_pred_hyp_grad_float64_matches_jax(seed):
    """The chain render_rays runs from a pass's raw outputs to pred_hyp
    (raw2outputs, then the analytic inverse CDF), in float64 in both
    packages: gradients with respect to the raw densities at 1e-4."""
    from plnerf.core import quadrature as jquad
    from plnerf_torch.core import quadrature

    rng = np.random.default_rng(seed)
    R, S, N = 6, 12, 16
    raw = rng.normal(size=(R, S, 4)) * 2
    raw[..., 3] += 1.0
    z = np.sort(rng.uniform(2, 6, (R, S)), -1)
    near, far = np.full((R, 1), 2.0), np.full((R, 1), 6.0)
    d = rng.normal(size=(R, 3))
    u = rng.uniform(size=(R, N))
    c = rng.normal(size=(R, N))

    def chain(q, s, lib, raw, z, near, far, d, u):
        out = q.raw2outputs(raw, z, near, far, d, "linear", "midpoint", 0.0,
                            True, False)
        return s.sample_pdf_reformulation(z, out["weights"], out["tau"],
                                          out["T"], near, far, u)[0]

    with jax.enable_x64(True):
        args = [jnp.asarray(a) for a in (raw, z, near, far, d, u)]
        ref = jax.grad(lambda r: jnp.sum(chain(jquad, jsamp, jnp, r,
                                               *args[1:]) * c))(args[0])
        ref = np.asarray(ref)
    targs = [torch.from_numpy(a) for a in (raw, z, near, far, d, u)]
    targs[0].requires_grad_(True)
    (chain(quadrature, sampling, torch, *targs) * torch.from_numpy(c)
     ).sum().backward()
    g = targs[0].grad.numpy()
    assert ref.dtype == g.dtype == np.float64 and np.abs(ref).max() > 0
    np.testing.assert_allclose(g, ref, atol=1e-4 * np.abs(ref).max())


def _tiny_dataset(seed=3):
    """A 10x12 two-view dataset with a valid-depth mask."""
    rng = np.random.default_rng(seed)
    H, W = 10, 12
    focal = 14.0
    poses = []
    for theta in (10.0, 70.0):
        c2w = np.eye(4, dtype=np.float32)
        a = np.deg2rad(theta)
        c2w[:3, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                       [-np.sin(a), 0, np.cos(a)]]
        c2w[:3, 3] = 4.0 * c2w[:3, 2]
        poses.append(c2w)
    return types.SimpleNamespace(
        images=rng.uniform(size=(2, H, W, 3)).astype(np.float32),
        poses=np.stack(poses), hwf=[H, W, focal],
        K=np.array([[focal, 0, W / 2], [0, focal, H / 2], [0, 0, 1]],
                   np.float32),
        intrinsics=None, near=2.0, far=6.0, gt_depths=None,
        gt_valid_depths=rng.uniform(size=(2, H, W, 1)) > 0.3)


@pytest.mark.parametrize("mode,count,masked", [("linear", None, False),
                                               ("constant", 1, True)])
def test_images_samples_matches_jax(tmp_path, mode, count, masked):
    params_c, params_f = np_params(KW, seed=0), np_params(KW, seed=1)
    rkw = dict(n_samples=16, n_importance=8, mode=mode, white_bkgd=True,
               perturb=False)
    ds = _tiny_dataset()
    kw = dict(count=count, chunk=64, verbose=False,
              valid_mask_from_dataset=masked)
    ref = jimages.test_images_samples(
        params_c, params_f, ds, [0, 1], JModelConfig(**KW),
        JRenderConfig(**rkw), str(tmp_path / "jax"), **kw)
    got = images.test_images_samples(
        torch_model(KW, params_c), torch_model(KW, params_f), ds, [0, 1],
        ModelConfig(**KW), RenderConfig(**rkw), str(tmp_path / "port"),
        **kw)
    err = got.get("importance_sampling_error")
    assert err > 0 and err == pytest.approx(
        ref.get("importance_sampling_error"), rel=1e-4)
    texts = [open(tmp_path / d / "metrics_expecteddepth.txt").read()
             for d in ("port", "jax")]
    assert all(x.startswith("importance_sampling_error: ") for x in texts)


TINY = [
    "--dataset", "blender", "--no_batching", "--use_viewdirs",
    "--white_bkgd", "--N_rand", "64", "--N_samples", "8",
    "--N_importance", "8", "--netdepth", "2", "--netwidth", "16",
    "--multires", "4", "--multires_views", "2", "--chunk", "256",
    "--lrate", "5e-3", "--i_print", "5", "--i_img", "1000000",
    "--i_testset", "1000000", "--i_video", "1000000", "--testskip", "1",
    "--mode", "linear", "--constant_init", "3", "--precrop_iters", "4",
]


def _values(path):
    out = {}
    for line in open(path):
        k, v = line.split(": ", 1)
        if k != "lpips":
            out[k] = float(v)
    return out


def test_eval_task_clis_match_jax(tmp_path):
    """JAX trains 8 tiny steps; its weights, carried into a port
    checkpoint, go through both drivers' ``--task test_samples_error`` and
    ``--task test_fixed_dist`` with ``--eval_det``."""
    data = tmp_path / "data"
    make_blender_scene(str(data / "scene"), n_train=3, n_val=1, n_test=1)
    make_fixed_dist_scene(str(data / "fix"), dists=(0.25, 0.5, 0.75, 1.0),
                          n=2)
    ckpt_dir = str(tmp_path / "ckpt")
    common = TINY + ["--data_dir", str(data), "--scene_id", "scene",
                     "--ckpt_dir", ckpt_dir]
    jrun.main(common + ["--task", "train", "--expname", "jax",
                        "--num_iterations", "8", "--i_weights", "8"])
    jargs = jconfig.config_parser().parse_args(common + ["--expname", "jax"])
    _, _, jsetup = jrun.build_configs(jargs)
    jstate = jckio.restore_checkpoint(
        os.path.join(ckpt_dir, "jax", "000008.ckpt"),
        jstep.init_state(jax.random.PRNGKey(0), jsetup))
    state = run_plnerf.main(common + ["--device", "cpu", "--task", "train",
                                      "--expname", "port",
                                      "--num_iterations", "0"])
    for module, params in ((state.params_coarse, jstate.params_coarse),
                           (state.params_fine, jstate.params_fine)):
        convert_jax.load_jax_params(module, jax.tree.map(np.array, params))
    state.step = 8
    ckio.save_checkpoint(os.path.join(ckpt_dir, "port"), 8,
                         state.state_dict())

    ev = ["--ckpt_dir", ckpt_dir, "--data_dir", str(data), "--scene_id",
          "scene", "--white_bkgd", "--eval_det", "--eval_data_dir",
          str(data), "--eval_scene_id", "fix"]
    for task in ("test_samples_error", "test_fixed_dist"):
        jrun.main(ev + ["--task", task, "--expname", "jax"])
        run_plnerf.main(ev + ["--task", task, "--expname", "port",
                              "--device", "cpu"])
    files = [os.path.join("test_samples_error_8",
                          "metrics_expecteddepth.txt")]
    files += [os.path.join(f"test_images_dist{d}_scene", "metrics.txt")
              for d in run_plnerf.FIXED_DIST_NEAR]
    for f in files:
        got = _values(os.path.join(ckpt_dir, "port", f))
        ref = _values(os.path.join(ckpt_dir, "jax", f))
        assert got and set(got) == set(ref), f
        for k in ref:
            assert got[k] == pytest.approx(ref[k], rel=1e-4), (f, k)
    assert run_plnerf.FIXED_DIST_NEAR == jrun.FIXED_DIST_NEAR
