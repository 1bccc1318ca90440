"""Data parallelism (``plnerf_torch/parallel/mesh.py``) on the CPU: two
gloo ranks (``torch.multiprocessing.spawn``, a ``file://`` rendezvous, no
TCP port) against one process without a process group, and one rank with
one against none.

Every rank runs the same scenarios: the NVS step (perturb off, and on
with density noise: the ranks slice one global draw, so the step does not
depend on the world size), the depth step with space carving (per-ray and
joint: the joint minimum over hypotheses reduces its ray means inside the
forward) under the +-0.1 clip and the scale / shift Adam, the occupancy
step, one image through ``render_image`` in ragged chunks with perturb
kept, and a density grid through ``extract_density_grid``; then the NVS
driver itself, ``run_plnerf.main``, trains, tests and extracts a mesh
under two ranks.  Tolerances against one device: losses 1e-6 relative,
parameters 1e-5 relative L2 after the steps (the two ranks' means of
equal halves round differently from one mean); the occupancy grid's first
update (from one set of weights) and its occupancy after the steps, the
renders, the density grid and the driver's test maps and mesh of one
checkpoint bit for bit (chunk ``i`` keeps its seed on any rank); the
grid's densities after the steps 1e-5 relative, as the JAX package's
sharded occ test holds them.  One rank with a mesh is the run
without one, bit for bit.  The models are those of the JAX package's
``tests/test_train_smoke.py`` sharded-step tests.

Every rank also runs windows of 4 steps (NVS, occ, joint depth) through
``MultiTrainStep.window`` and ``graph.Graphs`` as the drivers run them
(on the card each full window but the first is a CUDA graph with its
collectives inside; here every one runs eagerly): bit-equal to the same
steps one at a time under the same mesh, two ranks to one device within
the tolerances above, and planned as one device plans them.  Two ranks'
pool window is held against the JAX package's sharded fused window on
two virtual devices.  The serving artifact across devices (one process)
and the module's refusals close the file."""
import json
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from plnerf_torch.core import occgrid as og
from plnerf_torch.core.config import ModelConfig, RenderConfig
from plnerf_torch.eval import images as EI
from plnerf_torch.mesh import extract as MX
from plnerf_torch.parallel import mesh as pmesh
from plnerf_torch.train import step as tstep

torch.set_num_threads(1)

MCFG = ModelConfig(netdepth=4, netwidth=32, skips=(2,), multires=4,
                   multires_views=2)
RKW = dict(n_samples=8, n_importance=8, mode="linear", white_bkgd=True,
           perturb=False)
N_RAND, STEPS = 64, 3


def _rays(n, seed):
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(n, 3))
    o = 4.0 * o / np.linalg.norm(o, axis=-1, keepdims=True)
    d = -o / 4.0 + 0.1 * rng.normal(size=(n, 3))
    vd = d / np.linalg.norm(d, axis=-1, keepdims=True)
    return torch.from_numpy(np.concatenate(
        [o, d, np.full((n, 1), 2.0), np.full((n, 1), 6.0), vd],
        -1).astype(np.float32))


def _batch(seed, n=N_RAND):
    rng = np.random.default_rng(100 + seed)
    return {"rays": _rays(n, seed),
            "target": torch.from_numpy(rng.random((n, 3)).astype(
                np.float32))}


def _flat(state):
    ts = [p.detach().reshape(-1) for p in state.params_coarse.parameters()]
    ts += [p.detach().reshape(-1) for p in state.params_fine.parameters()]
    ts += [t.detach().reshape(-1) for t in (state.depth_scales,
                                            state.depth_shifts)
           if t is not None]
    return torch.cat(ts)


def nvs(mesh, perturb):
    rcfg = RenderConfig(**dict(RKW, perturb=perturb,
                               raw_noise_std=1.0 if perturb else 0.0))
    setup = tstep.TrainSetup(mcfg=MCFG, rcfg=rcfg, lrate=5e-3)
    state = tstep.init_state(torch.Generator().manual_seed(0), setup, "cpu")
    step = tstep.make_train_step(setup, mesh)
    g = torch.Generator().manual_seed(3)
    losses = []
    for s in range(STEPS):
        state, m = step(state, _batch(s), g)
        losses.append(m["loss"])
    return {"loss": torch.stack(losses), "params": _flat(state),
            "psnr": m["psnr"]}


def depth(mesh, joint):
    rcfg = RenderConfig(**dict(RKW, compute_pred_hyp=True, is_joint=joint))
    setup = tstep.TrainSetup(
        mcfg=MCFG, rcfg=rcfg, lrate=5e-3, joint_optimizer=True,
        grad_clip_value=0.1, space_carving_weight=0.5, is_joint=joint,
        scaleshift_lr=1e-2, start_decay_lrate=10, end_decay_lrate=20)
    state = tstep.init_state(torch.Generator().manual_seed(0), setup, "cpu",
                             n_images=2)
    step = tstep.make_depth_train_step(setup, mesh)
    g = torch.Generator().manual_seed(3)
    losses, sc = [], []
    for s in range(STEPS):
        rng = np.random.default_rng(200 + s)
        b = _batch(s)
        b["target_h"] = torch.from_numpy(
            rng.uniform(3.0, 5.0, (3, N_RAND, 1)).astype(np.float32))
        b["sc_mask"] = torch.from_numpy(
            (rng.random(N_RAND) > 0.2).astype(np.float32))
        b["img_idx"] = s % 2
        state, m = step(state, b, g)
        losses.append(m["loss"])
        sc.append(m["space_carving_loss"])
    return {"loss": torch.stack(losses), "sc": torch.stack(sc),
            "params": _flat(state)}


def occ(mesh):
    cfg = og.OccGridConfig(resolution=16, candidates=32, warmup=0)
    setup = tstep.TrainSetup(mcfg=MCFG, rcfg=RenderConfig(**RKW, occ=cfg),
                             lrate=5e-3)
    state = tstep.init_state(torch.Generator().manual_seed(0), setup, "cpu")
    grid = og.init_grid([-1.5] * 3, [1.5] * 3, cfg, "cpu")
    step = tstep.make_occ_train_step(setup, mesh)
    g = torch.Generator().manual_seed(3)
    losses, fracs, first = [], [], {}
    for s in range(STEPS):
        state, grid, m = step(state, grid, _batch(s), g)
        losses.append(m["loss"])
        fracs.append(m["occ_ray_frac"])
        first = first or {k + "_1": grid[k] for k in ("density", "occ")}
    return {"loss": torch.stack(losses), "params": _flat(state),
            "occ_ray_frac": torch.stack(fracs), "density": grid["density"],
            "occ": grid["occ"], **first}


def render(mesh):
    """One 12x12 image in 40-ray chunks (4, the last of 24) with perturb
    kept (the test config), and the importance-sampling quantiles."""
    setup = tstep.TrainSetup(mcfg=MCFG, rcfg=RenderConfig(**RKW))
    state = tstep.init_state(torch.Generator().manual_seed(0), setup, "cpu")
    rcfg = EI.test_render_config(RenderConfig(**dict(
        RKW, compute_pred_hyp=True)))
    c2w = np.array([[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 1, 4.0]], np.float32)
    K = np.array([[14.0, 0, 6.0], [0, 14.0, 6.0], [0, 0, 1]], np.float32)
    out = EI.render_image(state.params_coarse, state.params_fine, c2w,
                          (12, 12, 14.0), K, MCFG, rcfg, seed=5, chunk=40,
                          keep_hyp=True, mesh=mesh)
    return {k: torch.from_numpy(v) for k, v in out.items()}


def grid(mesh):
    """A 12^3 grid in queries of 500 points (4, the last of 228) through
    the fused forward's plain version."""
    setup = tstep.TrainSetup(mcfg=MCFG, rcfg=RenderConfig(**RKW))
    state = tstep.init_state(torch.Generator().manual_seed(0), setup, "cpu")
    return {"sigma": torch.from_numpy(MX.extract_density_grid(
        state.params_fine, MCFG, [-1.2] * 3, [1.2] * 3, resolution=12,
        chunk=500, use_kernel=True, mesh=mesh))}


# windows of WINDOW_N steps through graph.Graphs as the drivers run them
# (the plan recorded; the CPU runs every window eagerly): a first, a
# capture, a replay and a short one
WINDOW_N, WINDOW_SIZES = 4, (4, 4, 4, 2)
WINDOW_STEPS = sum(WINDOW_SIZES)


def _window_setup(flavour):
    """(setup, depth) of a window flavour: the NVS step with draws and
    density noise, the grid's step, the joint depth step."""
    if flavour == "depth":
        rcfg = RenderConfig(**dict(RKW, compute_pred_hyp=True, is_joint=True))
        return tstep.TrainSetup(
            mcfg=MCFG, rcfg=rcfg, lrate=5e-3, joint_optimizer=True,
            grad_clip_value=0.1, space_carving_weight=0.007, is_joint=True,
            scaleshift_lr=1e-3, warm_start_nerf=2, freeze_ss=9,
            start_decay_lrate=10, end_decay_lrate=20), True
    occ_cfg = (og.OccGridConfig(resolution=16, candidates=32, warmup=0)
               if flavour == "occ" else None)
    rcfg = RenderConfig(**dict(RKW, perturb=True, raw_noise_std=1.0,
                               occ=occ_cfg))
    return tstep.TrainSetup(mcfg=MCFG, rcfg=rcfg, lrate=5e-3,
                            lrate_decay=1), False


def _window_batches(depth):
    """Every step's global batch, stacked: step ``s`` is row ``s``."""
    bs = [_batch(s) for s in range(WINDOW_STEPS)]
    out = {k: torch.stack([b[k] for b in bs]) for k in ("rays", "target")}
    if depth:
        rng = np.random.default_rng(300)
        out["target_h"] = torch.from_numpy(rng.uniform(
            3.0, 5.0, (WINDOW_STEPS, 3, N_RAND, 1)).astype(np.float32))
        out["sc_mask"] = torch.from_numpy(
            (rng.random((WINDOW_STEPS, N_RAND)) > 0.2).astype(np.float32))
    return out


def _step_batch(batches, s, img):
    """Step ``s``'s batch (an int, or a staged 0-d tensor the host never
    reads) with its image ``img`` for the depth step."""
    idx = s.reshape(1) if isinstance(s, torch.Tensor) else torch.tensor([s])
    b = {k: v.index_select(0, idx)[0] for k, v in batches.items()}
    if "target_h" in b:
        b["img_idx"] = img
    return b


def window(mesh, flavour):
    """WINDOW_SIZES windows of ``flavour`` through ``MultiTrainStep.window``
    and ``graph.Graphs``, each staged as the drivers stage a window they
    capture or replay; then the same steps one at a time through the
    public step functions under the same mesh."""
    from plnerf_torch.train import graph

    setup, depth = _window_setup(flavour)
    batches = _window_batches(depth)
    imgs = [s % 2 for s in range(WINDOW_STEPS)]
    occ_cfg = setup.rcfg.occ

    def fresh():
        state = tstep.init_state(torch.Generator().manual_seed(0), setup,
                                 "cpu", n_images=2 if depth else 0)
        return state, (None if occ_cfg is None else
                       og.init_grid([-1.5] * 3, [1.5] * 3, occ_cfg, "cpu"))

    state, grid = fresh()
    g = torch.Generator().manual_seed(3)
    multi = tstep.make_multi_train_step(setup, WINDOW_N, mesh, depth)
    feed = graph.Feed(WINDOW_N, "cpu", len(state.optimizers()))
    graphs = graph.Graphs(torch.device("cpu"), WINDOW_N,
                          tstep.window_counters(state), [g])
    losses, s0 = [], 0
    for n in WINDOW_SIZES:
        idx, im = list(range(s0, s0 + n)), imgs[s0:s0 + n]
        staged = graphs.schedule(flavour, n) in graph.STAGED
        if staged:
            tstep.stage_window(feed, state, n, offset=idx, img=im)
            idx, im = feed.row("offset"), feed.row("img")

        def body(m, idx=idx, im=im, staged=staged):
            return multi.window(state, m, lambda k: _step_batch(
                batches, idx[k], im[k]), g, feed if staged else None, grid)

        losses.append(graphs.run(flavour, body, n)["loss"])
        s0 += n

    single, sgrid = fresh()
    sg = torch.Generator().manual_seed(3)
    step = (tstep.make_depth_train_step(setup, mesh) if depth else
            tstep.make_occ_train_step(setup, mesh) if occ_cfg is not None
            else tstep.make_train_step(setup, mesh))
    single_losses = []
    for s in range(WINDOW_STEPS):
        b = _step_batch(batches, s, imgs[s])
        if occ_cfg is not None:
            single, sgrid, m = step(single, sgrid, b, sg)
        else:
            single, m = step(single, b, sg)
        single_losses.append(m["loss"])
    ends = np.cumsum(WINDOW_SIZES) - 1
    out = {"loss": torch.stack(losses), "params": _flat(state),
           "single_loss": torch.stack([single_losses[e] for e in ends]),
           "single_params": _flat(single), "plan": graphs.windows(),
           "steps": (state.step, single.step)}
    if grid is not None:
        out.update(density=grid["density"], occ=grid["occ"],
                   single_density=sgrid["density"], single_occ=sgrid["occ"])
    return out


SCENARIOS = {"nvs": lambda m: nvs(m, False),
             "nvs_perturb_noise": lambda m: nvs(m, True),
             "depth": lambda m: depth(m, False),
             "depth_joint": lambda m: depth(m, True),
             "occ": occ, "render": render, "grid": grid,
             "window_nvs": lambda m: window(m, "nvs"),
             "window_occ": lambda m: window(m, "occ"),
             "window_depth": lambda m: window(m, "depth")}
WINDOW_FLAVOURS = ["window_nvs", "window_occ", "window_depth"]

# test_torch_graph_window.test_pool_window_matches_jax's pool window: two
# windows of POOL_N at these offsets of its pool, draws off
POOL_N, POOL_R = 4, 32
POOL_OFFSETS = (5, 5 + POOL_N * POOL_R)


def pool_window(mesh, init: str):
    """The driver's pool window from the saved init (``_pool_init``):
    each window's last loss and the final networks."""
    from plnerf_torch.train import batching, graph

    d = torch.load(init, weights_only=False)
    setup = d["setup"]
    state = tstep.init_state(torch.Generator().manual_seed(0), setup, "cpu")
    state.params_coarse.load_state_dict(d["params_coarse"])
    state.params_fine.load_state_dict(d["params_fine"])
    pool = torch.as_tensor(d["pool"])
    multi = tstep.make_multi_train_step(setup, POOL_N, mesh)
    feed = graph.Feed(POOL_N, "cpu", len(state.optimizers()))
    graphs = graph.Graphs(torch.device("cpu"), POOL_N,
                          tstep.window_counters(state))
    losses = []
    for i_batch in POOL_OFFSETS:
        offs = [i_batch + k * POOL_R for k in range(POOL_N)]
        staged = graphs.schedule("pool", POOL_N) in graph.STAGED
        if staged:
            tstep.stage_window(feed, state, POOL_N, offset=offs)
            offs = feed.row("offset")

        def body(n, offs=offs, staged=staged):
            def batch_of(k):
                rays, target = batching.pool_batch(pool, offs[k], POOL_R,
                                                   2.0, 6.0, True)
                return {"rays": rays, "target": target}

            return multi.window(state, n, batch_of, None,
                                feed if staged else None)

        losses.append(graphs.run("pool", body, POOL_N)["loss"])
    return {"loss": torch.stack(losses),
            "params": torch.cat([p.detach().reshape(-1) for p in
                                 state.params_coarse.parameters()]
                                + [p.detach().reshape(-1) for p in
                                   state.params_fine.parameters()]),
            "networks": {"coarse": state.params_coarse.state_dict(),
                         "fine": state.params_fine.state_dict()},
            "steps": state.step}


def _run_all(mesh):
    return {name: fn(mesh) for name, fn in SCENARIOS.items()}


def _driver(root, data_dir, ft_path=None):
    """The NVS driver on the sphere scene: 6 steps (a checkpoint at 3, a
    val render at 6), then ``--task test --eval_det`` and ``extract_mesh``
    at 12^3 of the checkpoint ``ft_path`` (default the run's own); returns
    the rank's results."""
    from plnerf_torch.cli import extract_mesh, run_plnerf

    where = ["--ckpt_dir", os.path.join(root, "ck"), "--expname", "e",
             "--data_dir", data_dir, "--scene_id", "sphere", "--device",
             "cpu"]
    train = where + [
        "--dataset", "blender", "--no_batching", "--use_viewdirs",
        "--white_bkgd", "--N_rand", "64", "--N_samples", "8",
        "--N_importance", "8", "--netdepth", "2", "--netwidth", "16",
        "--multires", "4", "--multires_views", "2", "--chunk", "300",
        "--perturb", "0", "--i_print", "1", "--i_img", "6",
        "--i_weights", "3", "--i_testset", "1000", "--i_video", "1000",
        "--num_iterations", "6", "--testskip", "1"]
    state = run_plnerf.main(train)
    if ft_path:
        where += ["--ft_path", ft_path]
    mm = run_plnerf.main(where + ["--task", "test", "--white_bkgd",
                                  "--eval_det"])
    ply = extract_mesh.main(where + ["--mesh_res", "12", "--mesh_chunk",
                                     "500", "--mesh_outdir",
                                     os.path.join(root, "mesh"),
                                     "--min_component_faces", "1",
                                     "--mesh_threshold", "0.0"])
    return {"params": _flat(state), "metrics": mm.as_dict(), "ply": ply}


def _worker(rank, world, rdv, out, data_dir, ft_path, pool_init):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=rdv, rank=rank,
                            world_size=world)
    try:
        mesh = pmesh.make_mesh("cpu")
        res = _run_all(mesh)
        os.environ["WORLD_SIZE"] = str(world)   # as torchrun sets it
        res["driver"] = _driver(os.path.join(out, f"w{world}"), data_dir,
                                ft_path)
        res["pool_window"] = pool_window(mesh, pool_init)
        torch.save(res, os.path.join(out, f"w{world}.{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _pool_init(path):
    """The port's side of ``test_torch_graph_window._nvs_pair`` (its
    setup, its networks loaded from the JAX package's numpy init) and the
    sphere pool, saved for the ranks."""
    from test_torch_graph_window import _nvs_pair, _sphere_pool

    _, _, setup, state, _ = _nvs_pair()
    torch.save({"setup": setup,
                "params_coarse": state.params_coarse.state_dict(),
                "params_fine": state.params_fine.state_dict(),
                "pool": _sphere_pool()}, path)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(no mesh, one rank, [rank 0, rank 1] of two)."""
    from plnerf_torch.data.synthetic import write_sphere_scene

    d = str(tmp_path_factory.mktemp("dp"))
    data_dir = os.path.join(d, "data")
    write_sphere_scene(os.path.join(data_dir, "sphere"), 24,
                       {"train": 4, "val": 1, "test": 2})
    pool_init = os.path.join(d, "pool_init.pt")
    _pool_init(pool_init)
    plain = _run_all(None)
    plain["driver"] = _driver(os.path.join(d, "plain"), data_dir)
    plain["pool_window"] = pool_window(None, pool_init)
    # the ranks evaluate the checkpoint of the run without a mesh
    ft = os.path.join(d, "plain", "ck", "e", "000006.ckpt")
    for world in (2, 1):
        mp.spawn(_worker, args=(world, f"file://{d}/rdv{world}", d,
                                data_dir, ft, pool_init), nprocs=world)
    load = lambda n: torch.load(os.path.join(d, n), weights_only=False)
    return plain, load("w1.0.pt"), [load(f"w2.{r}.pt") for r in (0, 1)], d


def _rel_l2(got, ref):
    return float(torch.linalg.norm((got - ref).double())
                 / torch.linalg.norm(ref.double()))


def _leaves(res):
    for name, out in res.items():
        for k, v in out.items():
            if isinstance(v, torch.Tensor):
                yield f"{name}.{k}", v


def test_one_rank_is_the_run_without_a_mesh(runs):
    plain, one, _, _ = runs
    for (name, got), (_, ref) in zip(_leaves(one), _leaves(plain)):
        assert torch.equal(got, ref), name
    assert one["driver"]["metrics"] == plain["driver"]["metrics"]


def test_ranks_hold_the_same_state(runs):
    _, _, (r0, r1), _ = runs
    for (name, a), (_, b) in zip(_leaves(r0), _leaves(r1)):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("name", ["nvs", "nvs_perturb_noise", "depth",
                                  "depth_joint", "occ"])
def test_step_matches_one_device(runs, name):
    plain, _, (two, _), _ = runs
    got, ref = two[name], plain[name]
    torch.testing.assert_close(got["loss"], ref["loss"], rtol=1e-6, atol=0)
    assert _rel_l2(got["params"], ref["params"]) < 1e-5
    assert not torch.equal(ref["params"], _flat_init())
    if name.startswith("depth"):
        torch.testing.assert_close(got["sc"], ref["sc"], rtol=1e-6, atol=0)
    if name == "occ":
        # the first update, from one set of weights, exactly; after three
        # steps the densities carry the parameters' rounding
        for k in ("density_1", "occ_1", "occ"):
            assert torch.equal(got[k], ref[k]), k
        torch.testing.assert_close(got["density"], ref["density"],
                                   rtol=1e-5, atol=1e-7)
        fresh = og.init_grid([-1.5] * 3, [1.5] * 3, og.OccGridConfig(
            resolution=16), "cpu")["density"]
        assert not torch.equal(ref["density_1"], fresh)
        torch.testing.assert_close(got["occ_ray_frac"], ref["occ_ray_frac"],
                                   rtol=1e-6, atol=0)


def _flat_init():
    setup = tstep.TrainSetup(mcfg=MCFG, rcfg=RenderConfig(**RKW))
    return _flat(tstep.init_state(torch.Generator().manual_seed(0), setup,
                                  "cpu"))


@pytest.mark.parametrize("name", WINDOW_FLAVOURS)
def test_window_is_single_steps_under_the_mesh(runs, name):
    """Under every mesh (none, one rank, each of two ranks) the windows
    equal the same steps taken one at a time under that mesh, bit for
    bit: the last loss of each window, the parameters and the grid."""
    plain, one, (r0, r1), _ = runs
    for res in (plain, one, r0, r1):
        got = res[name]
        assert got["steps"] == (WINDOW_STEPS, WINDOW_STEPS)
        for k in [k for k in got if k.startswith("single_")]:
            assert torch.equal(got[k[len("single_"):]], got[k]), k


@pytest.mark.parametrize("name", WINDOW_FLAVOURS)
def test_window_matches_one_device(runs, name):
    """Two ranks' windows against one device's: the windows' losses 1e-6
    relative, the parameters 1e-5 relative L2; the plan (first, capture,
    replay, a short eager window) is one device's on one rank and on
    each of two."""
    plain, one, (r0, r1), _ = runs
    got, ref = r0[name], plain[name]
    torch.testing.assert_close(got["loss"], ref["loss"], rtol=1e-6, atol=0)
    assert _rel_l2(got["params"], ref["params"]) < 1e-5
    assert not torch.equal(ref["params"], _window_init(name))
    assert [k for _, _, k in ref["plan"]] == ["first", "capture", "replay",
                                              "eager"]
    for res in (one, r0, r1):
        assert res[name]["plan"] == ref["plan"]


def _window_init(name):
    setup, depth = _window_setup(name[len("window_"):])
    return _flat(tstep.init_state(torch.Generator().manual_seed(0), setup,
                                  "cpu", n_images=2 if depth else 0))


def test_two_rank_pool_window_matches_jax(runs):
    """The pool window of two gloo ranks against the JAX package's sharded
    fused window, ``run_plnerf._make_pool_step(..., mesh, n_inner=4)`` on
    two of the virtual CPU devices, from one init with draws off (as
    ``test_torch_graph_window.test_pool_window_matches_jax`` holds one
    device): each window's last loss to 1e-3 relative, each tensor's
    update within 5% in L2."""
    import jax
    import jax.numpy as jnp

    from plnerf.cli import run_plnerf as jrun
    from plnerf.parallel import mesh as jpmesh
    from test_torch_graph_window import _held_updates, _nvs_pair, _sphere_pool

    _, _, (two, _), _ = runs
    jsetup, jstate, _, state, p0 = _nvs_pair()
    jmesh = jpmesh.make_mesh(jax.devices()[:2])
    jstate = jpmesh.replicate(jstate, jmesh)
    pool = jpmesh.replicate(jnp.asarray(_sphere_pool()), jmesh)
    jfn = jrun._make_pool_step(jsetup, 2.0, 6.0, POOL_R, jmesh,
                               n_inner=POOL_N)
    got = two["pool_window"]
    for w, i_batch in enumerate(POOL_OFFSETS):
        jstate, jm = jfn(jstate, pool, jnp.int32(i_batch),
                         jax.random.PRNGKey(w))
        assert float(got["loss"][w]) == pytest.approx(float(jm["loss"]),
                                                      rel=1e-3), w
    assert got["steps"] == int(jstate.step) == 2 * POOL_N
    state.params_coarse.load_state_dict(got["networks"]["coarse"])
    state.params_fine.load_state_dict(got["networks"]["fine"])
    _held_updates(state, jstate, p0)


@pytest.mark.parametrize("name", ["render", "grid"])
def test_eval_is_bit_equal(runs, name):
    plain, _, (two, _), _ = runs
    assert set(two[name]) == set(plain[name])
    for k, v in plain[name].items():
        assert torch.equal(two[name][k], v), k


def test_driver_under_two_ranks(runs):
    """Rank 0 wrote what one device writes: metrics.jsonl's losses (1e-6),
    the checkpoints, the val render, the test folder; on the checkpoint of
    the run without a mesh its held-out maps score the same (the renders
    are bit-equal) and its PLY is the same file; rank 1 wrote nothing and
    returned None for the mesh."""
    plain, _, (r0, r1), d = runs
    assert _rel_l2(r0["driver"]["params"], plain["driver"]["params"]) < 1e-5
    assert r0["driver"]["metrics"] == plain["driver"]["metrics"]
    assert r1["driver"]["metrics"] == {} and r1["driver"]["ply"] is None

    def exp(who):
        return os.path.join(d, who, "ck", "e")

    def losses(who):
        with open(os.path.join(exp(who), "metrics.jsonl")) as f:
            return {r["step"]: r["train/loss"] for r in map(json.loads, f)
                    if "train/loss" in r}

    got, ref = losses("w2"), losses("plain")
    assert list(got) == list(ref) == list(range(1, 7))
    for k in ref:
        assert got[k] == pytest.approx(ref[k], rel=1e-6), k
    assert sorted(os.listdir(exp("w2"))) == sorted(os.listdir(exp("plain")))
    with open(r0["driver"]["ply"], "rb") as a, \
            open(plain["driver"]["ply"], "rb") as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("mode", ["baked", "args"])
def test_serving_across_devices(tmp_path, mode):
    """``ServingRenderer.load(dir, devices=["cpu", "cpu"])``: a 3-chunk
    request with perturb kept (each chunk's draws from its own seed)
    gives the one-device maps bit for bit."""
    from plnerf_torch.serving import export
    from plnerf_torch.serving.runtime import ServingRenderer

    setup = tstep.TrainSetup(mcfg=MCFG, rcfg=RenderConfig(**RKW))
    state = tstep.init_state(torch.Generator().manual_seed(0), setup, "cpu")
    rcfg = EI.test_render_config(RenderConfig(**RKW), use_fused_mlp=True,
                                 fused_fold_heads=True)
    export.export_renderer(state.params_coarse, state.params_fine, MCFG,
                           rcfg, str(tmp_path), chunk=48, weights_mode=mode)
    rays = _rays(3 * 48 - 5, seed=9)
    one = ServingRenderer.load(str(tmp_path), device="cpu")
    two = ServingRenderer.load(str(tmp_path), devices=["cpu", "cpu"])
    ref = one.render_rays(rays, seed=4)
    got = two.render_rays(rays, seed=4)
    assert set(got) == set(ref) and ref["rgb_map"].shape == (3 * 48 - 5, 3)
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    assert not np.array_equal(one.render_rays(rays, seed=5)["rgb_map"],
                              ref["rgb_map"])


def test_refusals(monkeypatch):
    """A batch that does not split evenly, ``--no_mesh`` under a launch of
    more than one process, and a CUDA world without CUDA."""
    mesh = pmesh.Mesh(rank=1, size=2, device=torch.device("cpu"))
    assert pmesh.row_range(64, mesh) == slice(32, 64)
    with pytest.raises(ValueError, match="63 rays does not split evenly "
                                         "over 2 ranks"):
        pmesh.shard_batch({"rays": torch.zeros(63, 11)}, mesh)
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(SystemExit, match="--N_rand 1023 does not split"):
        pmesh.refuse_unsplit(1023)
    pmesh.refuse_unsplit(1024)
    with pytest.raises(SystemExit, match="--no_mesh under torchrun"):
        pmesh.get_mesh(True, "cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            pmesh.make_mesh("cuda")
    monkeypatch.delenv("WORLD_SIZE")
    assert pmesh.get_mesh(False, "cpu") is None
