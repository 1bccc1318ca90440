"""A window of train steps as one device program (``train/graph.py``,
``train/step.make_multi_train_step``) on the CPU, where its body runs
eagerly.

* The window body, fed the host's staged rates, step counts, pool
  offsets and images, equals the same steps taken one at a time bit for
  bit: sampled fp32, pool, the grid carried from step to step, the depth
  step across its warm start and scale / shift freeze, the vanilla joint
  Adam.
* The port's windows against the JAX package's fused ones, draws off:
  ``make_multi_train_step(setup, 4)`` on the same stacked batches, the
  pool window of ``run_plnerf._make_pool_step(..., n_inner=4)`` on the
  same pool and offset, the depth window against four JAX depth steps;
  the loss to 1e-3 relative and each tensor's update within 5% in L2
  (``test_torch_train.test_trajectory_matches_jax`` says why).
* The drivers' window plan: which windows a CUDA run replays and which
  it runs eagerly is the JAX drivers' choice of their fused program
  (``n_this == n_inner``), at phase boundaries, the pool's epoch tail and
  the grid's warm-up; a variant that comes back after another was
  captured (the occupancy advisory's fallback) is captured anew.
* Adam's step counts kept where the optimizer keeps them (on the CPU
  here; on the card, where Adam is capturable, in
  ``test_torch_kernel_cuda.py``) survive a save and load, a JAX package
  checkpoint and a reference ``.tar``; ``utils/profile`` counts the fused
  kernels' launches in a trace.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from plnerf.checkpoint import convert_torch as jconvert
from plnerf.checkpoint import io as jio
from plnerf.cli import run_depth as jrun_depth
from plnerf.cli import run_plnerf as jrun
from plnerf.core.config import ModelConfig as JModelConfig
from plnerf.core.config import RenderConfig as JRenderConfig
from plnerf.train import step as jstep
from plnerf.train.state import TrainState as JTrainState
from plnerf_torch.checkpoint import convert_jax
from plnerf_torch.checkpoint import io as ckio
from plnerf_torch.cli import run_depth, run_plnerf
from plnerf_torch.core import occgrid
from plnerf_torch.core.config import ModelConfig, RenderConfig
from plnerf_torch.data.synthetic import make_sphere_dataset
from plnerf_torch.train import batching, graph
from plnerf_torch.train import step as tstep

from fixtures import make_blender2_scene, make_blender_scene
from test_torch_cli import CPU, TINY
from test_torch_depth import (_batches as _depth_batches, _both_states,
                              _jbatch, _setups as _depth_setups, _tbatch,
                              _tensors)
from test_torch_mlp import np_params, t

torch.set_num_threads(1)

N = 3
R = 32


def _scene():
    images, poses, hwf, K = make_sphere_dataset(n_views=4, H=16, W=16)
    return (torch.as_tensor(images), torch.as_tensor(poses[:, :3, :4]),
            torch.as_tensor(K), torch.arange(4))


def _same_tree(a, b, where=""):
    if isinstance(a, torch.Tensor):
        assert isinstance(b, torch.Tensor) and a.dtype == b.dtype, where
        assert torch.equal(a, b), where
    elif isinstance(a, dict):
        assert set(a) == set(b), where
        for k in a:
            _same_tree(a[k], b[k], f"{where}/{k}")
    else:
        assert a == b, where


# ---------------------------------------------------------------------------
# (a) the window body against single steps
# ---------------------------------------------------------------------------

MKW = dict(netdepth=2, netwidth=32, skips=(), multires=4, multires_views=2)
FLAVOURS = {
    "sampled_fp32": dict(),
    "pool": dict(pool=True),
    "occ": dict(occ=True),
    "vanilla": dict(vanilla=True),
    "depth": dict(depth=True),
}
# the depth flavour's images, one per step of its two windows
IMGS = [3, 0, 2, 1, 1, 3]


def _flavour(name):
    """(setup, depth, fresh(), batch(k, g, feed)): ``fresh`` makes the
    seeded state and grid, ``batch`` step k's batch, from the host's
    values without ``feed``, from the window's staged ones with it."""
    kw = FLAVOURS[name]
    images, poses, K, i_train = _scene()
    occ = (occgrid.OccGridConfig(resolution=8, candidates=16)
           if kw.get("occ") else None)
    depth = kw.get("depth", False)
    if depth:
        mcfg = ModelConfig(**MKW, pi_bands=True, input_ch_cam=3,
                           density_activation="softplus10", init="xavier")
        rcfg = RenderConfig(n_samples=8, n_importance=8, mode="linear",
                            white_bkgd=True, perturb=True,
                            compute_pred_hyp=True, trim_first_weight=True,
                            use_fused_mlp=True, fused_fold_heads=True)
        # the warm start ends at step 1 and the freeze at step 2 (step + 1
        # >= 3): inside the first window
        setup = tstep.TrainSetup(
            mcfg=mcfg, rcfg=rcfg, lrate=5e-3, joint_optimizer=True,
            grad_clip_value=0.1, space_carving_weight=0.007,
            warm_start_nerf=1, freeze_ss=3, scaleshift_lr=1e-3,
            start_decay_lrate=2, end_decay_lrate=5, opt_ch_cam=True)
    else:
        rcfg = RenderConfig(n_samples=8, n_importance=8, mode="linear",
                            white_bkgd=True, perturb=True, raw_noise_std=1.0,
                            use_fused_mlp=True, fused_fold_heads=True,
                            occ=occ)
        setup = tstep.TrainSetup(mcfg=ModelConfig(**MKW), rcfg=rcfg,
                                 lrate=5e-3, lrate_decay=1,
                                 joint_optimizer=kw.get("vanilla", False))
    rows = torch.as_tensor(batching.build_ray_pool(
        images.numpy(), poses.numpy(), K.numpy(), [0, 1, 2, 3]))
    intr = torch.stack([K[0, 0], K[1, 1], K[0, 2], K[1, 2]]).expand(
        4, 4).contiguous()
    depths = torch.full((4, 16, 16), 4.0)
    mask = (torch.arange(4 * 16 * 16).reshape(4, 16, 16) % 5 > 0).float()

    def fresh():
        state = tstep.init_state(torch.Generator().manual_seed(0), setup,
                                 "cpu", n_images=4 if depth else 0)
        grid = (occgrid.init_grid([-1.5] * 3, [1.5] * 3, occ, "cpu")
                if occ else None)
        return state, grid

    def batch(k, g, feed=None, j=None):
        """Step ``k`` of the run; ``j``: its row of ``feed``."""
        if depth:
            img = IMGS[k] if feed is None else feed.row("img")[j]
            return run_depth.depth_batch(images, poses, intr, depths, mask,
                                         img, R, 2.0, 6.0, True, g)
        if kw.get("pool"):
            off = R * k if feed is None else feed.row("offset")[j]
            rays, target = batching.pool_batch(rows, off, R, 2.0, 6.0, True)
        else:
            rays, target, _ = batching.sample_one_image_batch(
                images, poses, K, i_train, g, R, 2.0, 6.0, True)
        return {"rays": rays, "target": target}

    return setup, depth, fresh, batch


def _single_steps(setup, depth, state, grid, batch, g, n):
    """``n`` steps one at a time through the public step functions."""
    if depth:
        step = tstep.make_depth_train_step(setup)
    elif setup.rcfg.occ is not None:
        step = tstep.make_occ_train_step(setup)
    else:
        step = tstep.make_train_step(setup)
    for k in range(n):
        b = batch(k, g)
        if depth:
            state, m = step(state, b, g)
        elif grid is not None:
            state, grid, m = step(state, grid, b, g)
        else:
            state, m = step(state, b, g)
    return state, grid, m


@pytest.mark.parametrize("name", list(FLAVOURS))
def test_window_body_is_single_steps(name):
    """Two windows of N steps, each fed the staged rates, step counts,
    offsets and images, against 2N single steps from the same seeds: the
    states (Adam's moments and counts included), the grid, the last
    metrics and the generator's state bit for bit."""
    setup, depth, fresh, batch = _flavour(name)
    state1, grid1 = fresh()
    g1 = torch.Generator().manual_seed(1)
    state1, grid1, m1 = _single_steps(setup, depth, state1, grid1, batch, g1,
                                      2 * N)

    state2, grid2 = fresh()
    g2 = torch.Generator().manual_seed(1)
    multi = tstep.make_multi_train_step(setup, N, depth=depth)
    feed = graph.Feed(N, "cpu", len(state2.optimizers()))
    for w in range(2):
        ints = {}
        if name == "pool":
            ints["offset"] = [R * (w * N + k) for k in range(N)]
        if depth:
            ints["img"] = IMGS[w * N:(w + 1) * N]
        tstep.stage_window(feed, state2, N, **ints)
        m2 = multi.window(state2, N, lambda k: batch(w * N + k, g2, feed, k),
                          g2, feed, grid2)

    assert state1.step == state2.step == 2 * N
    assert [o.count for o in state2.optimizers()] == [2 * N] * len(
        state2.optimizers())
    _same_tree(state1.state_dict(), state2.state_dict())
    if grid1 is not None:
        _same_tree(grid1, grid2)
        assert not torch.equal(grid2["density"], fresh()[1]["density"])
    assert set(m1) == set(m2)
    for k in m1:
        assert torch.equal(m1[k], m2[k]), k
    assert torch.equal(g1.get_state(), g2.get_state())
    if depth:
        # the scales moved at step 1 only (zero grads before, frozen
        # after)
        s0 = fresh()[0].depth_scales
        assert not torch.equal(state2.depth_scales, s0)


def test_feed_stages_rows_and_refuses_bad_ones():
    feed = graph.Feed(4, "cpu", 2)
    feed.fill([[1e-3, 2e-3], [3e-3, 4e-3]], step=[5, 6], img=[2, 0])
    assert feed.rates.dtype == torch.float64
    assert feed.rates[0, 1].item() == 2e-3 and feed.rates[1, 2].item() == 0
    assert feed.row("step").tolist() == [5, 6, 0, 0]
    assert feed.row("img").tolist() == [2, 0, 0, 0]
    assert feed.row("offset").tolist() == [0, 0, 0, 0]
    with pytest.raises(ValueError):
        feed.fill([[1e-3] * 5, [1e-3] * 5])
    with pytest.raises(ValueError):
        feed.fill([[1e-3]], step=[1])
    with pytest.raises(ValueError):
        feed.fill([[1e-3], [1e-3]], nope=[1])


# ---------------------------------------------------------------------------
# (b) against the JAX package's fused windows
# ---------------------------------------------------------------------------

KW = dict(netdepth=3, netwidth=32, multires=4, multires_views=2)
JN = 4


def _nvs_pair(joint=False):
    """(jsetup, jstate, setup, state) from one init, draws off."""
    rkw = dict(n_samples=16, n_importance=8, mode="linear", white_bkgd=True,
               perturb=False, raw_noise_std=0.0)
    skw = dict(lrate=5e-3, coarse_lrate=5e-3, lrate_decay=1,
               joint_optimizer=joint)
    pc, pf = np_params(KW, seed=0), np_params(KW, seed=1)
    for p in (pc, pf):
        p["alpha_linear"]["b"] = p["alpha_linear"]["b"] + 0.5
    jsetup = jstep.TrainSetup(mcfg=JModelConfig(**KW),
                              rcfg=JRenderConfig(**rkw), **skw)
    fine, coarse, _ = jsetup.make_optimizers()
    jstate = JTrainState(step=jnp.int32(0), params_coarse=pc, params_fine=pf,
                         opt_coarse=None if joint else coarse.init(pc),
                         opt_fine=fine.init((pc, pf) if joint else pf))
    setup = tstep.TrainSetup(mcfg=ModelConfig(**KW), rcfg=RenderConfig(
        **rkw, use_fused_mlp=True, fused_fold_heads=True), **skw)
    state = tstep.init_state(torch.Generator().manual_seed(0), setup, "cpu")
    convert_jax.load_jax_params(state.params_coarse, pc)
    convert_jax.load_jax_params(state.params_fine, pf)
    return jsetup, jstate, setup, state, (pc, pf)


def _held_updates(state, jstate, p0):
    """Each tensor's update within 5% of the JAX update in L2."""
    for model, params, q0 in ((state.params_coarse, jstate.params_coarse,
                               p0[0]),
                              (state.params_fine, jstate.params_fine,
                               p0[1])):
        ref, ref0 = (convert_jax.params_to_state_dict(
            jax.tree.map(np.asarray, q)) for q in (params, q0))
        for k, q in model.state_dict().items():
            step = np.linalg.norm(ref[k] - ref0[k])
            assert np.linalg.norm(q.numpy() - ref[k]) <= 0.05 * step, k


def _sphere_pool():
    images, poses, hwf, K = make_sphere_dataset(4, 24, 24)
    return batching.build_ray_pool(images, poses[:, :3, :4], K, [0, 1, 2, 3])


@pytest.mark.parametrize("joint", [False, True])
def test_multi_train_step_matches_jax(joint):
    """Two windows of 4 on the same stacked batches: the windows' mean
    losses to 1e-3, the weights' updates within 5%.  The port's window
    body runs each window; the mean of its steps' losses comes from the
    same steps run as windows of one on a second state, which the test
    holds bit-equal to the first."""
    jsetup, jstate, setup, state, p0 = _nvs_pair(joint)
    state1 = _nvs_pair(joint)[3]
    jfn = jstep.make_multi_train_step(jsetup, JN)
    multi = tstep.make_multi_train_step(setup, JN)
    pool = _sphere_pool()
    for w in range(2):
        rows = pool[w * JN * R:(w + 1) * JN * R].reshape(JN, R, 9)
        vd = rows[..., 3:6] / np.linalg.norm(rows[..., 3:6], axis=-1,
                                             keepdims=True)
        rays = np.concatenate([rows[..., 0:6], np.full((JN, R, 1), 2.0),
                               np.full((JN, R, 1), 6.0), vd],
                              -1).astype(np.float32)
        target = np.ascontiguousarray(rows[..., 6:9])
        jstate, jm = jfn(jstate, {"rays": jnp.asarray(rays),
                                  "target": jnp.asarray(target)},
                         jax.random.PRNGKey(w))
        stacked = {"rays": t(rays), "target": t(target)}
        last = multi.window(state, JN, lambda k: {
            key: v[k] for key, v in stacked.items()})
        losses = [multi.window(state1, 1, lambda _: {
            key: v[k] for key, v in stacked.items()})["loss"]
            for k in range(JN)]
        assert torch.equal(last["loss"], losses[-1])
        assert float(sum(losses) / JN) == pytest.approx(float(jm["loss"]),
                                                        rel=1e-3), w
    assert state.step == state1.step == int(jstate.step) == 2 * JN
    _same_tree(state.state_dict(), state1.state_dict())
    _held_updates(state, jstate, p0)


def test_pool_window_matches_jax():
    """The driver's pool window: ``run_plnerf._make_pool_step(...,
    n_inner=4)`` against the port's window body at the same offsets of
    the same pool (its last step's loss, each window)."""
    jsetup, jstate, setup, state, p0 = _nvs_pair()
    jfn = jrun._make_pool_step(jsetup, 2.0, 6.0, R, None, n_inner=JN)
    pool = _sphere_pool()
    pool_t, pool_j = torch.as_tensor(pool), jnp.asarray(pool)
    multi = tstep.make_multi_train_step(setup, JN)
    feed = graph.Feed(JN, "cpu", len(state.optimizers()))

    def batch_of(k):
        rays, target = batching.pool_batch(pool_t, feed.row("offset")[k], R,
                                           2.0, 6.0, True)
        return {"rays": rays, "target": target}

    for w, i_batch in enumerate((5, 5 + JN * R)):
        jstate, jm = jfn(jstate, pool_j, jnp.int32(i_batch),
                         jax.random.PRNGKey(w))
        tstep.stage_window(feed, state, JN, offset=[
            i_batch + k * R for k in range(JN)])
        m = multi.window(state, JN, batch_of, None, feed)
        assert float(m["loss"]) == pytest.approx(float(jm["loss"]),
                                                 rel=1e-3), w
    assert state.step == int(jstate.step) == 2 * JN
    _held_updates(state, jstate, p0)


def test_depth_window_matches_jax():
    """The depth window body (warm start ending at step 1, the freeze at
    step 3, camera embeddings trained) against four JAX depth steps on
    the same batches: the last step's loss and space-carving loss to
    1e-3, every tensor's update within 5% in L2."""
    jsetup, setup = _depth_setups(dict(warm_start_nerf=1, freeze_ss=3),
                                  dict(perturb=False), cam=True)
    js, ps = _both_states(jsetup, setup)
    js0 = jax.tree.map(np.asarray, js)
    batches = [b for b, _ in _depth_batches(JN, 24, 12, 8, False, seed=9)]
    jfn = jstep.make_depth_train_step(jsetup)
    for k, b in enumerate(batches):
        js, jm = jfn(js, _jbatch(b), jax.random.PRNGKey(k))
    multi = tstep.make_multi_train_step(setup, JN, depth=True)
    feed = graph.Feed(JN, "cpu", len(ps.optimizers()))
    tstep.stage_window(feed, ps, JN)
    m = multi.window(ps, JN, lambda k: _tbatch(batches[k]), None, feed)
    assert ps.step == int(js.step) == JN
    for key in ("loss", "space_carving_loss"):
        assert float(m[key]) == pytest.approx(float(jm[key]), rel=1e-3), key
    ref0 = {n: r for n, _, r in _tensors(ps, js0)}
    for n, got, ref in _tensors(ps, js):
        step = np.linalg.norm(ref - ref0[n])
        assert np.linalg.norm(got - ref) <= 0.05 * step + 1e-9, n


# ---------------------------------------------------------------------------
# (c) the drivers' window plan against the JAX drivers'
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def scene_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("data") / "tinyscene"
    make_blender_scene(str(d), n_train=3, n_val=1, n_test=1)
    return str(d.parent), "tinyscene"


@pytest.fixture(scope="module")
def depth_scene(tmp_path_factory):
    d = tmp_path_factory.mktemp("ddata") / "depthscene"
    make_blender2_scene(str(d), n_train=3, n_test=2, with_depth=True)
    return str(d.parent), "depthscene"


def _where(scene, ckpt, name):
    return ["--data_dir", scene[0], "--scene_id", scene[1], "--ckpt_dir",
            ckpt, "--expname", name]


OCC = ["--occ_grid", "--occ_res", "16", "--occ_candidates", "16",
       "--occ_bound", "1.5"]
POOL = [a for a in TINY if a != "--no_batching"]
POOL[POOL.index("64")] = "80"
# tests/test_torch_dispatch.py's WINDOWS_HELD: phase boundaries at 5
# (precrop) and 10 (constant_init) splitting windows of 7; the pool's
# epoch tail (38 full batches of 80) splitting windows of 8; the grid's
# warm-up (6) splitting windows of 4
PLANS = {
    "boundaries": (TINY + ["--mode", "linear", "--steps_per_dispatch", "7",
                           "--num_iterations", "30", "--constant_init",
                           "10", "--precrop_iters", "5", "--i_print", "5",
                           "--i_weights", "100"]),
    "pool_tail": (POOL + ["--mode", "constant", "--steps_per_dispatch", "8",
                          "--num_iterations", "50", "--i_weights", "100"]),
    "occ": (TINY + ["--mode", "linear", "--constant_init", "2",
                    "--steps_per_dispatch", "4", "--num_iterations", "22",
                    "--i_print", "3", "--i_weights", "100", "--occ_warmup",
                    "6"] + OCC),
}


class _Recorded(graph.Graphs):
    made = []

    def __init__(self, *a, **k):
        super().__init__(*a, **k)
        _Recorded.made.append(self)


def _jax_programs(monkeypatch, module, name, key_of):
    """Record each call of the JAX driver's programs made by
    ``module.name``: (variant key, n_inner of the program)."""
    import inspect

    orig = getattr(module, name)
    sig = inspect.signature(orig)
    calls = []

    def make(*a, **k):
        bound = sig.bind(*a, **k)
        bound.apply_defaults()
        fn = orig(*a, **k)
        key, n = key_of(bound.arguments), bound.arguments["n_inner"]

        def call(*x, **y):
            calls.append((key, n))
            return fn(*x, **y)

        return call

    monkeypatch.setattr(module, name, make)
    return calls


def _held_plan(port_plan, jax_calls, n_inner):
    """The port's full windows are the JAX driver's fused calls, in order
    and by variant; its eager steps are the JAX single-step calls; each
    variant's first full window is its eager one, its second a capture,
    the rest replays."""
    full = [(key, kind) for key, n, kind in port_plan if kind != "eager"]
    assert [k for k, _ in full] == [k for k, n in jax_calls if n > 1]
    assert all(n == n_inner for key, n, kind in port_plan if kind != "eager")
    assert sum(n for _, n, kind in port_plan if kind == "eager") == sum(
        1 for _, n in jax_calls if n == 1)
    seen = {}
    for key, kind in full:
        n = seen[key] = seen.get(key, 0) + 1
        assert kind == ("first", "capture", "replay")[min(n, 3) - 1], (
            key, kind)
    assert any(kind == "capture" for _, kind in full)
    assert any(kind == "eager" for _, _, kind in port_plan)


@pytest.mark.parametrize("case", list(PLANS))
def test_window_plan_matches_the_jax_driver(scene_dir, tmp_path, monkeypatch,
                                            case):
    argv = ["--task", "train"] + PLANS[case]
    pool = case == "pool_tail"

    def key_of(a):
        s = a["setup"].rcfg
        return (bool(s.constant_init), s.occ is not None,
                False if pool else bool(a["precrop"]))

    calls = _jax_programs(monkeypatch, jrun, "_make_pool_step" if pool
                          else "_make_sampled_step", key_of)
    jrun.main(argv + _where(scene_dir, str(tmp_path / "jax"), "e"))
    _Recorded.made = []
    monkeypatch.setattr(graph, "Graphs", _Recorded)
    run_plnerf.main(argv + CPU + _where(scene_dir, str(tmp_path / "port"),
                                        "e"))
    (graphs,) = _Recorded.made
    assert graphs.graphs and not graphs.capture   # planned, run eagerly
    _held_plan(graphs.windows(), calls, graphs.n_inner)


def test_depth_window_plan_matches_the_jax_driver(depth_scene, tmp_path,
                                                  monkeypatch):
    """``run_depth`` at N 4 with the grid's warm-up ending at 6."""
    argv = ["train", "--dataset", "blender2_depth", "--N_rand", "64",
            "--N_samples", "8", "--N_importance", "8", "--netdepth", "2",
            "--netwidth", "16", "--netdepth_fine", "2", "--netwidth_fine",
            "16", "--multires", "4", "--multires_views", "2", "--chunk",
            "256", "--lrate", "5e-3", "--i_print", "4", "--mode", "linear",
            "--set_near_plane", "2.0", "--white_bkgd", "--occ_warmup", "6",
            "--num_iterations", "17", "--i_weights", "100",
            "--steps_per_dispatch", "4"] + OCC
    calls = _jax_programs(monkeypatch, jrun_depth, "_make_depth_step",
                          lambda a: a["setup"].rcfg.occ is not None)
    jrun_depth.main(argv + _where(depth_scene, str(tmp_path / "jax"), "d"))
    _Recorded.made = []
    monkeypatch.setattr(graph, "Graphs", _Recorded)
    run_depth.main(argv + CPU + _where(depth_scene, str(tmp_path / "port"),
                                       "d"))
    (graphs,) = _Recorded.made
    # windows 1-4, 5-6 | 7-10, 11-14, 15-17
    assert graphs.windows() == [
        (False, 4, "first"), (False, 2, "eager"), (True, 4, "first"),
        (True, 4, "capture"), (True, 3, "eager")]
    _held_plan(graphs.windows(), calls, 4)


def test_a_returning_variant_is_captured_anew():
    """Graphs that share a pool replay in the order of their captures: a
    variant replays only while it holds the latest capture, and one that
    comes back after another was captured is captured anew.  A window
    planned and not run refuses another."""
    g = graph.Graphs(torch.device("cpu"), 4)
    for key in "aaabbba":
        g.run(key, lambda n: {}, 4)
    g.run("a", lambda n: {}, 2)
    g.run("a", lambda n: {}, 4)
    assert g.windows() == [
        ("a", 4, "first"), ("a", 4, "capture"), ("a", 4, "replay"),
        ("b", 4, "first"), ("b", 4, "capture"), ("b", 4, "replay"),
        ("a", 4, "capture"), ("a", 2, "eager"), ("a", 4, "replay")]
    assert [k in graph.STAGED for _, _, k in g.windows()] == [
        False, True, True, False, True, True, True, False, True]
    assert g.schedule("b", 4) == "capture"
    with pytest.raises(RuntimeError, match="planned"):
        g.schedule("b", 4)
    with pytest.raises(RuntimeError, match="planned"):
        g.run("a", lambda n: {}, 4)


def test_occ_fallback_captures_the_uniform_phase_anew(scene_dir, tmp_path,
                                                      monkeypatch):
    """The NVS driver at N 4, its grid's warm-up ending at 12 and the
    degenerate-guidance guard firing after step 24 (its grace cut to 8,
    its threshold to 0): the uniform phase, captured during the warm-up,
    comes back after the guided phase's capture and is captured anew;
    the run trains on to its end."""
    monkeypatch.setattr(run_plnerf, "OCC_ADVISORY_GRACE", 8)
    monkeypatch.setattr(run_plnerf, "OCC_DEGENERATE_RAY_FRAC", 0.0)
    _Recorded.made = []
    monkeypatch.setattr(graph, "Graphs", _Recorded)
    state = run_plnerf.main(
        ["--task", "train"] + TINY + CPU
        + _where(scene_dir, str(tmp_path / "ck"), "f")
        + ["--mode", "linear", "--constant_init", "0", "--precrop_iters",
           "0", "--steps_per_dispatch", "4", "--num_iterations", "30",
           "--i_print", "4", "--i_weights", "100", "--occ_warmup", "12"]
        + OCC)
    (graphs,) = _Recorded.made
    uniform, guided = (False, False, False), (False, True, False)
    assert graphs.windows() == [
        (uniform, 4, "first"), (uniform, 4, "capture"),
        (uniform, 4, "replay"), (guided, 4, "first"),
        (guided, 4, "capture"), (guided, 4, "replay"),
        (uniform, 4, "capture"), (uniform, 2, "eager")]
    assert state.step == 30


def test_trace_kernel_counts_reads_the_fused_launches():
    """The fused kernels by their names as the card's traces show them
    (one ``bf16_kernel`` or one ``fp32_kernel`` per product for a forward
    call, one ``weight_kernel`` and ``reduce_kernel`` per backward call);
    other kernels of like names and host events do not count."""
    from plnerf_torch.utils import profile as uprofile

    def k(name, ts, cat="kernel"):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": 1.0}

    ns = "(anonymous namespace)::"
    trace = {"traceEvents": [
        k(ns + "fp32_kernel((anonymous namespace)::FOp, long long)", 10),
        k(ns + "fp32_kernel((anonymous namespace)::FOp, long long)", 11),
        k(ns + "bf16_kernel((anonymous namespace)::Plan, ...)", 20),
        k("void " + ns + "weight_kernel<float>((anonymous namespace)"
          "::Jobs, long long, long long, float*)", 30),
        k("void " + ns + "weight_kernel<__nv_bfloat16>(...)", 40),
        k(ns + "reduce_kernel(float const*, long long, long long, float*)",
          41),
        k(ns + "sgemm_data_kernel((anonymous namespace)::FOp, long long)",
          42),
        k("void " + ns + "cot_data_kernel<float>(float const*, ...)", 43),
        k("void at::native::reduce_kernel<512, 1>(...)", 44),
        k("void at::native::weight_norm_kernel<float>(...)", 45),
        k(ns + "bf16_kernel((anonymous namespace)::Plan, ...)", 90),
        k(ns + "bf16_kernel((anonymous namespace)::Plan, ...)", 50,
          "cpu_op")]}
    assert uprofile.trace_kernel_counts(trace) == {
        "fp32_kernel": 2, "bf16_kernel": 2, "weight_kernel": 2,
        "reduce_kernel": 1, "sgemm_data_kernel": 1, "cot_data_kernel": 1}
    assert uprofile.trace_kernel_counts(trace, r"weight_norm") == {
        "void at::native::weight_norm_kernel<float>(...)": 1}


def test_trace_kernel_counts_keeps_kernels_stamped_before_the_span():
    """The shape of a replayed window's trace whose kernel stamps ran
    early against the host's clock (the card's census once counted 157
    of 160 ``fp32_kernel`` records): a graph's first kernels stamped
    before the host's ``dispatch_window`` span began, its copies after
    the launch.  Counted over the session, as the census and the drivers'
    traces count a window, every kernel stays (a cut at the span's host
    start lost them)."""
    from plnerf_torch.utils import profile as uprofile

    ns = "(anonymous namespace)::"

    def ev(cat, name, ts, dur=1.0):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}

    trace = {"traceEvents": [
        ev("user_annotation", "dispatch_window", 100.0, 50.0),
        ev("cuda_runtime", "cudaGraphLaunch", 120.0, 10.0),
        ev("gpu_memset", "Memset (Device)", 125.0),
        ev("kernel", ns + "fp32_kernel((anonymous namespace)::FOp, long "
           "long)", 88.0),
        ev("kernel", ns + "fp32_kernel((anonymous namespace)::FOp, long "
           "long)", 99.5),
        ev("kernel", ns + "fp32_kernel((anonymous namespace)::FOp, long "
           "long)", 130.0),
        ev("kernel", "void " + ns + "weight_kernel<float>(...)", 140.0)]}
    assert uprofile.trace_kernel_counts(trace) == {"fp32_kernel": 3,
                                                   "weight_kernel": 1}
    assert uprofile.TRACE_MARGIN_S > 0


def test_data_parallel_windows_are_eager(scene_dir, tmp_path, monkeypatch):
    """The rule that replaced eager windows under a mesh: the NVS driver
    under a data-parallel mesh (a gloo group of one rank in this process,
    ``WORLD_SIZE=1`` as ``torchrun`` sets it) plans its windows as one
    device does, every full window a graph (first, capture, replay) and
    none eager for the mesh's sake; and its state is the one device's
    bit for bit.  Only ``capture=False`` plans every window eagerly."""
    import torch.distributed as dist

    argv = ["--task", "train"] + PLANS["occ"] + CPU
    monkeypatch.setattr(graph, "Graphs", _Recorded)
    _Recorded.made = []
    one = run_plnerf.main(argv + _where(scene_dir, str(tmp_path / "one"),
                                        "e"))
    monkeypatch.setenv("WORLD_SIZE", "1")
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdv",
                            rank=0, world_size=1)
    try:
        meshed = run_plnerf.main(argv + _where(
            scene_dir, str(tmp_path / "mesh"), "e"))
    finally:
        dist.destroy_process_group()
    plain, under_mesh = _Recorded.made
    assert under_mesh.graphs and under_mesh.windows() == plain.windows()
    assert {kind for _, _, kind in plain.windows()} == {
        "first", "capture", "replay", "eager"}
    _same_tree(meshed.state_dict(), one.state_dict())
    g = graph.Graphs(torch.device("cpu"), 4, capture=False)
    g.run("k", lambda n: {}, 4)
    assert g.windows() == [("k", 4, "eager")] and not g.graphs


# ---------------------------------------------------------------------------
# (d) Adam's step counts where the optimizer keeps them
# ---------------------------------------------------------------------------

def _steps_where_kept(state, count):
    """Each optimizer's update count and Adam's float32 step per
    parameter at ``count``, the step where Adam keeps it (the CPU here:
    a CPU Adam is not capturable, its rate a float)."""
    for o in state.optimizers():
        assert o.count == count and isinstance(o.param_groups[0]["lr"],
                                               float)
        assert o.state and all(
            s["step"].dtype == torch.float32
            and s["step"].device.type == "cpu"
            and float(s["step"]) == count for p, s in o.state.items())


def test_device_steps_survive_save_and_load(tmp_path):
    setup, depth, fresh, batch = _flavour("depth")
    state, _ = fresh()
    state, _, _ = _single_steps(setup, depth, state, None, batch,
                                torch.Generator().manual_seed(1), 2)
    path = ckio.save_checkpoint(str(tmp_path), state.step,
                                state.state_dict())
    back = ckio.restore_checkpoint(path, fresh()[0], "cpu")
    _steps_where_kept(back, 2)
    _same_tree(back.state_dict(), state.state_dict())
    again = ckio.save_checkpoint(str(tmp_path / "again"), back.step,
                                 back.state_dict())
    _same_tree(torch.load(again, weights_only=True),
               torch.load(path, weights_only=True))


def test_device_steps_from_jax_and_reference_checkpoints(tmp_path):
    """A JAX package checkpoint (3 updates' worth of Adam state) and a
    reference ``.tar`` load their steps and counts where the optimizers
    keep them."""
    jsetup, setup = _depth_setups(dict(freeze_ss=100), dict(), cam=True)
    js, _ = _both_states(jsetup, setup, count=3)
    path = jio.save_checkpoint(str(tmp_path / "jax"), 3, js)

    def fresh():
        return tstep.init_state(torch.Generator().manual_seed(0), setup,
                                "cpu", n_images=4)

    _steps_where_kept(ckio.restore_checkpoint(path, fresh(), "cpu"), 3)

    _, _, nsetup, nstate, (pc, pf) = _nvs_pair()
    adam = (jax.tree.map(np.zeros_like, pf),
            jax.tree.map(np.ones_like, pf), 17)
    tar = str(tmp_path / "ref.tar")
    jconvert.save_reference_checkpoint(tar, 40, pc, pf, fine_adam=adam)
    back = ckio.restore_checkpoint(tar, tstep.init_state(
        torch.Generator().manual_seed(0), nsetup, "cpu"), "cpu")
    assert back.step == 40 and back.opt_fine.count == 17
    for s in back.opt_fine.state.values():
        assert s["step"].dtype == torch.float32 and float(s["step"]) == 17

    # optax's moments set directly (the depth tests' path)
    opt = fresh().opt_ss
    convert_jax.load_adam_state(opt, [np.zeros((4, 1))] * 2,
                                [np.ones((4, 1))] * 2, 5)
    assert opt.count == 5 and all(
        float(s["step"]) == 5 and s["step"].dtype == torch.float32
        and s["step"].device.type == "cpu" for s in opt.state.values())
