"""``--steps_per_dispatch N`` in the port's drivers, and the train step in
which the host never waits on the device, on the CPU.

* The zero-safe ``cumprod`` of ``core/quadrature.py``: its forward is
  ``torch.cumprod`` bit for bit, its gradient torch's within 1e-6
  relative in float64 and bit for bit in float32, zeros anywhere in a
  row.
* A stand-in for the card's ``torch.cuda.set_sync_debug_mode("error")``:
  ``HostReadGuard`` raises wherever a step reads a tensor's value on the
  host (``item``, ``bool``, ``float``, ``int``, ``index``, ``tolist``,
  ``cpu``, ``numpy``, and an ATen ``_local_scalar_dense`` made inside
  C++, as a 0-dim index or torch's cumprod backward make it).  The steps
  of one window of each flavour run under it.
* The bands of ``embed``, the rows of ``pack_rays`` and the one-image
  batch are bit-equal to what they were before they stopped copying from
  the host.
* The windows against the JAX drivers: the logged ``train/`` steps, the
  checkpoint names and their ``step`` at four settings (phase
  boundaries, the pool's epoch tail, the grid's warm-up, depth with the
  grid).
* N changes no number: N = 4 and N = 1 give bit-equal checkpoints and
  equal logged losses (sampled, pool, occ, depth, and a resume from a
  step that is not a multiple of N).
"""
import json
import os

import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode

import flax.serialization as fser

from plnerf.cli import run_depth as jrun_depth
from plnerf.cli import run_plnerf as jrun
from plnerf_torch.cli import run_depth, run_plnerf
from plnerf_torch.core import encoding, occgrid, quadrature, rays
from plnerf_torch.core.config import ModelConfig, RenderConfig
from plnerf_torch.data.synthetic import make_sphere_dataset
from plnerf_torch.train import batching
from plnerf_torch.train.step import (TrainSetup, apply_occ_update,
                                     init_state, make_depth_train_step,
                                     make_occ_train_step, make_train_step)

from fixtures import make_blender2_scene, make_blender_scene
from test_torch_cli import CPU, TINY

torch.set_num_threads(1)

# tests/test_cli_depth.py's tiny flags
DEPTH_TINY = [
    "--dataset", "blender2_depth", "--N_rand", "64", "--N_samples", "8",
    "--N_importance", "8", "--netdepth", "2", "--netwidth", "16",
    "--multires", "4", "--multires_views", "2", "--chunk", "256",
    "--lrate", "5e-3", "--i_print", "4", "--mode", "linear",
    "--set_near_plane", "2.0", "--space_carving_weight", "0.007",
    "--freeze_ss", "100", "--white_bkgd",
]
DEPTH_NARROW = ["--netdepth_fine", "2", "--netwidth_fine", "16"]
OCC = ["--occ_grid", "--occ_res", "16", "--occ_candidates", "16",
       "--occ_bound", "1.5"]
# the pool of the 3-view 32x32 scene holds 3072 rays: 38 full batches of
# 80 per epoch (tests/test_cli.py::test_pool_epoch_tail_consumed)
POOL = [a for a in TINY if a != "--no_batching"]
POOL[POOL.index("64")] = "80"


# ---------------------------------------------------------------------------
# the zero-safe cumprod
# ---------------------------------------------------------------------------

ZERO_ROWS = {
    "no_zero": [],
    "interior_zero": [4],
    "last_zero": [8],
    "several_zeros": [2, 3, 6],
    "all_zero": list(range(9)),
}


@pytest.mark.parametrize("case", list(ZERO_ROWS))
def test_zero_safe_cumprod_matches_torch(case):
    rng = np.random.default_rng(0)
    x = rng.uniform(0.05, 1.5, (5, 9))
    x[1:, ZERO_ROWS[case]] = 0.0        # row 0 keeps no zero
    g = torch.from_numpy(rng.standard_normal((5, 9)))
    a = torch.from_numpy(x).requires_grad_()
    b = torch.from_numpy(x).requires_grad_()
    ya = quadrature.cumprod(a)
    yb = torch.cumprod(b, dim=-1)
    assert torch.equal(ya, yb)
    ya.backward(g)
    yb.backward(g)
    torch.testing.assert_close(a.grad, b.grad, rtol=1e-6, atol=1e-6 * float(
        b.grad.abs().max()))
    # float32: forward and gradient are torch's (its backward's own
    # formula, on the same operations), bit for bit
    a = torch.from_numpy(x.astype(np.float32)).requires_grad_()
    b = torch.from_numpy(x.astype(np.float32)).requires_grad_()
    ya, yb = quadrature.cumprod(a), torch.cumprod(b, -1)
    assert torch.equal(ya, yb)
    ya.backward(g.float())
    yb.backward(g.float())
    assert torch.equal(a.grad, b.grad)


# ---------------------------------------------------------------------------
# the host-read guard
# ---------------------------------------------------------------------------

_READS = {torch.Tensor.item, torch.Tensor.__bool__, torch.Tensor.__float__,
          torch.Tensor.__int__, torch.Tensor.__index__, torch.Tensor.tolist,
          torch.Tensor.cpu, torch.Tensor.numpy}


def _optimizer_steps(optimizers) -> set:
    """ids of the optimizers' step counts: torch.optim keeps them on the
    host (unless capturable) and reads them there, on the card too."""
    return {id(s["step"]) for o in optimizers if o is not None
            for s in o.state.values() if "step" in s}


class _FunctionReads(TorchFunctionMode):
    def __init__(self, allowed):
        super().__init__()
        self.allowed = allowed

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func in _READS and id(args[0]) not in self.allowed():
            raise AssertionError(f"host read: {func.__name__}")
        return func(*args, **(kwargs or {}))


class _AtenReads(TorchDispatchMode):
    def __init__(self, allowed):
        super().__init__()
        self.allowed = allowed

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if (func is torch.ops.aten._local_scalar_dense.default
                and id(args[0]) not in self.allowed()):
            raise AssertionError("host read: aten._local_scalar_dense")
        if func is torch.ops.aten.lift_fresh.default:
            # a tensor made from host data: on the card a copy that waits
            raise AssertionError("host data: aten.lift_fresh")
        return func(*args, **(kwargs or {}))


class HostReadGuard:
    """While active, a read of a tensor's value on the host, or a tensor
    made from host data, raises, except reads of the optimizers' own step
    counts."""

    def __init__(self, optimizers=(), active: bool = True):
        self.optimizers = list(optimizers)
        self.active = active

    def __enter__(self):
        def allowed():
            return _optimizer_steps(self.optimizers)

        self.modes = ([_FunctionReads(allowed), _AtenReads(allowed)]
                      if self.active else [])
        for m in self.modes:
            m.__enter__()
        return self

    def __exit__(self, *exc):
        for m in reversed(self.modes):
            m.__exit__(*exc)


def test_guard_catches_host_reads():
    t, i = torch.ones(3), torch.tensor(2)
    for read in (lambda: t.sum().item(), lambda: float(t[0]),
                 lambda: bool(t.all()), lambda: t.tolist(),
                 lambda: t.numpy(), lambda: list(range(10))[t.long()[0]],
                 lambda: torch.arange(5)[i], lambda: t.new_tensor(1e-10),
                 lambda: torch.as_tensor(2.0)):
        with pytest.raises(AssertionError, match="host (read|data)"):
            with HostReadGuard():
                read()
    with HostReadGuard():
        (t * 2).sum()                    # device work only


def _no_cumprod_backward(t: torch.Tensor) -> bool:
    seen, todo = set(), [t.grad_fn]
    while todo:
        fn = todo.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        if type(fn).__name__ == "CumprodBackward0":
            return False
        todo += [f for f, _ in fn.next_functions]
    return True


def _scene():
    images, poses, hwf, K = make_sphere_dataset(n_views=4, H=16, W=16)
    return (torch.as_tensor(images), torch.as_tensor(poses[:, :3, :4]),
            torch.as_tensor(K), torch.arange(4))


def _nvs_setup(occ=None, mode="linear", mlp_dtype="float32",
               vanilla=False):
    mcfg = ModelConfig(netdepth=2, netwidth=32, skips=(), multires=4,
                       multires_views=2)
    rcfg = RenderConfig(n_samples=8, n_importance=8, mode=mode,
                        white_bkgd=True, perturb=True, raw_noise_std=1.0,
                        mlp_dtype=mlp_dtype, use_fused_mlp=True,
                        fused_fold_heads=True, occ=occ)
    return TrainSetup(mcfg=mcfg, rcfg=rcfg, lrate=5e-3,
                      joint_optimizer=vanilla)


WINDOW = 3


def _nvs_window(occ: bool, mode: str = "linear", mlp_dtype="float32",
                vanilla=False, pool=False):
    occ_cfg = occgrid.OccGridConfig(resolution=8, candidates=16) \
        if occ else None
    setup = _nvs_setup(occ_cfg, mode, mlp_dtype, vanilla)
    state = init_state(torch.Generator().manual_seed(0), setup, "cpu")
    grid = occgrid.init_grid([-1.5] * 3, [1.5] * 3, occ_cfg, "cpu") \
        if occ else None
    step = (make_occ_train_step if occ else make_train_step)(setup)
    images, poses, K, i_train = _scene()
    rows = torch.as_tensor(batching.build_ray_pool(
        images.numpy(), poses.numpy(), K.numpy(), [0, 1, 2, 3]))
    g = torch.Generator().manual_seed(1)
    # one step first, as on the card: the kernels' first call builds them
    # and the optimizers make their state
    for k in range(WINDOW + 1):
        with HostReadGuard([state.opt_fine, state.opt_coarse],
                           active=k > 0):
            if pool:
                r, tgt = batching.pool_batch(rows, 32 * k, 32, 2.0, 6.0, True)
            else:
                r, tgt, _ = batching.sample_one_image_batch(
                    images, poses, K, i_train, g, 32, 2.0, 6.0, True)
            if occ:
                state, grid, m = step(state, grid, {"rays": r, "target": tgt},
                                      g)
            else:
                state, m = step(state, {"rays": r, "target": tgt}, g)
    return state, m


def _depth_window(occ: bool):
    from plnerf_torch.cli.run_depth import depth_batch

    mcfg = ModelConfig(netdepth=2, netwidth=32, skips=(), multires=4,
                       multires_views=2, pi_bands=True, input_ch_cam=3,
                       density_activation="softplus10", init="xavier")
    occ_cfg = occgrid.OccGridConfig(resolution=8, candidates=16) \
        if occ else None
    rcfg = RenderConfig(n_samples=8, n_importance=8, mode="linear",
                        white_bkgd=True, perturb=True, compute_pred_hyp=True,
                        trim_first_weight=True, use_fused_mlp=True,
                        fused_fold_heads=True, occ=occ_cfg)
    setup = TrainSetup(mcfg=mcfg, rcfg=rcfg, lrate=5e-3,
                       joint_optimizer=True, grad_clip_value=0.1,
                       space_carving_weight=0.007, freeze_ss=2,
                       scaleshift_lr=1e-3, start_decay_lrate=10,
                       end_decay_lrate=20, opt_ch_cam=True)
    images, poses, K, _ = _scene()
    intr = torch.tensor([[float(K[0, 0]), float(K[1, 1]), float(K[0, 2]),
                          float(K[1, 2])]] * 4)
    depths = torch.full((4, 16, 16), 4.0)
    mask = torch.ones(4, 16, 16)
    state = init_state(torch.Generator().manual_seed(0), setup, "cpu",
                       n_images=4)
    grid = occgrid.init_grid([-1.5] * 3, [1.5] * 3, occ_cfg, "cpu") \
        if occ else None
    step = make_depth_train_step(setup)
    g = torch.Generator().manual_seed(1)
    for k, img in enumerate((3, 0, 2, 1)):
        with HostReadGuard([state.opt_fine, state.opt_ss, state.opt_latent],
                           active=k > 0):
            batch = depth_batch(images, poses, intr, depths, mask, img, 32,
                                2.0, 6.0, True, g)
            if occ:
                state, m = step(state, dict(batch, occ_grid=grid), g)
                grid, m = apply_occ_update(setup, grid, batch, m)
            else:
                state, m = step(state, batch, g)
    return state, m


NVS_FLAVOURS = {
    "nvs_linear": dict(occ=False),
    "nvs_constant": dict(occ=False, mode="constant"),
    "nvs_bf16": dict(occ=False, mlp_dtype="bfloat16"),
    "vanilla": dict(occ=False, vanilla=True),
    "pool": dict(occ=False, pool=True),
    "occ": dict(occ=True, mlp_dtype="bfloat16"),
}


@pytest.mark.parametrize("flavour", list(NVS_FLAVOURS) + ["depth",
                                                          "depth_occ"])
def test_window_reads_nothing_on_the_host(flavour):
    """One window of each step flavour under the guard (folded heads: the
    two Adams, the vanilla joint Adam, a pool slice, the grid; the depth
    step with camera embeddings, across its freeze)."""
    if flavour.startswith("depth"):
        state, m = _depth_window(flavour == "depth_occ")
        assert state.step == 4 and state.opt_latent is not None
    else:
        state, m = _nvs_window(**NVS_FLAVOURS[flavour])
        assert state.step == WINDOW + 1
    assert all(np.isfinite(float(v)) for k, v in m.items()
               if not k.startswith("_"))


def test_linear_render_backward_has_no_cumprod_node():
    """The step's graph takes the zero-safe backward, whose torch
    counterpart reads its zero check on the host."""
    from plnerf_torch.core.render import render_rays

    setup = _nvs_setup()
    state = init_state(torch.Generator().manual_seed(0), setup, "cpu")
    images, poses, K, i_train = _scene()
    g = torch.Generator().manual_seed(1)
    r, _, _ = batching.sample_one_image_batch(images, poses, K, i_train, g,
                                              16, 2.0, 6.0, True)
    out = render_rays(state.params_coarse, state.params_fine, r, g,
                      setup.mcfg, setup.rcfg)
    assert _no_cumprod_backward(out["rgb_map"].sum() + out["rgb0"].sum())


@pytest.mark.parametrize("multires", [1, 4, 10, 16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                   torch.bfloat16])
def test_embed_bands_are_the_numpy_bands(multires, dtype):
    ref = torch.as_tensor(encoding.freq_bands(multires), dtype=dtype)
    assert torch.equal(encoding.bands(multires, dtype, "cpu"), ref)
    x = torch.randn(5, 3, generator=torch.Generator().manual_seed(0))
    ref32 = torch.as_tensor(encoding.freq_bands(multires), dtype=x.dtype)
    for pi in (False, True):
        b = ref32 * np.pi if pi else ref32
        xb = x[..., None, :] * b[:, None]
        want = torch.cat([x, torch.stack([torch.sin(xb), torch.cos(xb)],
                                         -2).reshape(5, -1)], -1)
        assert torch.equal(encoding.embed(x, multires, pi), want)


@pytest.mark.parametrize("near,far", [(2.0, 6.0), (0.1, 1e10),
                                      (np.float32(0.3), np.float64(4.7)),
                                      (0, 1)])
def test_pack_rays_rows_are_as_before(near, far):
    g = torch.Generator().manual_seed(0)
    o, d, v = (torch.randn(7, 3, generator=g) for _ in range(3))
    want = torch.cat([o, d, torch.as_tensor(near, dtype=torch.float32)
                      .expand(7, 1), torch.as_tensor(far, dtype=torch.float32)
                      .expand(7, 1), v], -1)
    got = rays.pack_rays(o, d, near, far, v)
    assert got.dtype == torch.float32 and torch.equal(got, want)
    # per-ray bounds stay per ray
    n = torch.rand(7, 1, generator=g)
    assert torch.equal(rays.pack_rays(o, d, n, far)[:, 6:7], n)


@pytest.mark.parametrize("precrop", [False, True])
def test_one_image_batch_is_as_before(precrop):
    """The image index drawn as a 1-element tensor: the same draw, rays,
    targets and index as the 0-dim index it replaced."""
    images, poses, K, _ = _scene()
    i_train = torch.tensor([0, 2, 3])
    got = batching.sample_one_image_batch(
        images, poses, K, i_train, torch.Generator().manual_seed(5), 24,
        2.0, 6.0, True, precrop)
    g = torch.Generator().manual_seed(5)
    ti = torch.randint(0, 3, (), generator=g)
    y, x = batching.select_pixels(g, 16, 16, 24, precrop, 0.5)
    img_i = i_train[ti]
    ro, rd = batching.rays_for_pixels(K, poses[img_i][:3, :4], y, x)
    vd = rd / torch.linalg.norm(rd, dim=-1, keepdim=True)
    assert torch.equal(got[0], torch.cat(
        [ro, rd, torch.full((24, 1), 2.0), torch.full((24, 1), 6.0), vd],
        -1))
    assert torch.equal(got[1], images[img_i, y, x])
    assert got[2].shape == () and int(got[2]) == int(img_i)


# ---------------------------------------------------------------------------
# the drivers' windows
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


def _logged(exp: str) -> dict:
    """{step: {key: value}} of the ``train/`` records of metrics.jsonl."""
    out = {}
    with open(os.path.join(exp, "metrics.jsonl")) as f:
        for r in map(json.loads, f):
            keys = {k: v for k, v in r.items() if k.startswith("train/")}
            if keys:
                out.setdefault(r["step"], {}).update(keys)
    return out


def _ckpts(exp: str) -> list:
    return sorted(f for f in os.listdir(exp) if f.endswith(".ckpt"))


def _port_step(path: str) -> int:
    return int(torch.load(path, weights_only=False)["step"])


def _jax_step(path: str) -> int:
    with open(path, "rb") as f:
        return int(fser.msgpack_restore(f.read())["step"])


WINDOWS_HELD = {
    # phase boundaries at 5 (precrop) and 10 (constant_init) split the
    # windows of 7: 1-4, 5-9, 10-16, 17-23
    "boundaries": (TINY + ["--mode", "linear", "--steps_per_dispatch", "7",
                           "--num_iterations", "23", "--constant_init", "10",
                           "--precrop_iters", "5", "--i_print", "5",
                           "--i_weights", "10"]),
    # the pool's epoch tail: windows of 8 end at the 38th batch
    "pool_tail": (POOL + ["--mode", "constant", "--steps_per_dispatch", "8",
                          "--num_iterations", "50", "--i_weights", "50"]),
    # the grid's warm-up (6) splits the windows of 4
    "occ": (TINY + ["--mode", "linear", "--constant_init", "2",
                    "--steps_per_dispatch", "4", "--num_iterations", "14",
                    "--i_print", "3", "--i_weights", "7", "--occ_warmup",
                    "6"] + OCC),
}


@pytest.mark.parametrize("case", list(WINDOWS_HELD))
def test_windows_match_the_jax_driver(scene_dir, tmp_path, case):
    """The port's and the JAX driver's runs log the same train steps and
    write the same checkpoints, holding the same step."""
    argv = ["--task", "train"] + WINDOWS_HELD[case]
    jrun.main(argv + _where(scene_dir, str(tmp_path / "jax"), "e"))
    run_plnerf.main(argv + CPU + _where(scene_dir, str(tmp_path / "port"),
                                        "e"))
    jexp, exp = str(tmp_path / "jax" / "e"), str(tmp_path / "port" / "e")
    assert sorted(_logged(exp)) == sorted(_logged(jexp))
    assert _ckpts(exp) == _ckpts(jexp)
    for name in _ckpts(exp):
        assert _port_step(os.path.join(exp, name)) == _jax_step(
            os.path.join(jexp, name)) == int(name[:6])


def test_depth_windows_match_the_jax_driver(depth_scene, tmp_path):
    """``run_depth`` at N 4 with the grid: windows split at the warm-up's
    end (6), prints every 4."""
    argv = ["train"] + DEPTH_TINY + DEPTH_NARROW + OCC + [
        "--occ_warmup", "6", "--num_iterations", "12", "--i_weights", "6",
        "--steps_per_dispatch", "4"]
    jrun_depth.main(argv + _where(depth_scene, str(tmp_path / "jax"), "d"))
    run_depth.main(argv + CPU + _where(depth_scene, str(tmp_path / "port"),
                                       "d"))
    jexp, exp = str(tmp_path / "jax" / "d"), str(tmp_path / "port" / "d")
    assert sorted(_logged(exp)) == sorted(_logged(jexp)) == [4, 10, 12]
    assert _ckpts(exp) == _ckpts(jexp) == ["000006.ckpt", "000012.ckpt"]
    for name in _ckpts(exp):
        assert _port_step(os.path.join(exp, name)) == _jax_step(
            os.path.join(jexp, name))


# ---------------------------------------------------------------------------
# N changes no number
# ---------------------------------------------------------------------------

def _same_tree(a, b, where="") -> None:
    if isinstance(a, torch.Tensor):
        assert isinstance(b, torch.Tensor) and a.dtype == b.dtype, where
        assert torch.equal(a, b), where
    elif isinstance(a, dict):
        assert set(a) == set(b), where
        for k in a:
            _same_tree(a[k], b[k], f"{where}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for k, (x, y) in enumerate(zip(a, b)):
            _same_tree(x, y, f"{where}/{k}")
    else:
        assert a == b, where


def _same_runs(exp1: str, exp4: str) -> None:
    """The checkpoints (and sidecars) that the N = 4 and N = 1 runs both
    wrote, the final one among them, bit-equal; the N = 4 run's logged
    metrics equal the N = 1 run's at the same steps."""
    def files(exp):
        return {f for f in os.listdir(exp) if f.endswith((".ckpt", ".occ"))}

    shared = files(exp1) & files(exp4)
    assert max(_ckpts(exp1)) == max(_ckpts(exp4)) in shared
    for name in sorted(shared):
        _same_tree(torch.load(os.path.join(exp1, name), weights_only=False),
                   torch.load(os.path.join(exp4, name), weights_only=False),
                   name)
    log1, log4 = _logged(exp1), _logged(exp4)
    assert log4 and set(log4) <= set(log1)
    for step in log4:
        assert set(log1[step]) == set(log4[step])
        for k, v in log4[step].items():
            if k != "train/steps_per_sec":
                assert v == log1[step][k], (step, k)


# every run prints every step, so each step the N = 4 run logs (its
# windows' ends) is held against the N = 1 run's
NVS_RUNS = {
    "sampled": TINY + ["--mode", "linear", "--num_iterations", "23",
                       "--constant_init", "10", "--precrop_iters", "5",
                       "--i_print", "1", "--i_weights", "10"],
    # a reshuffle after step 38
    "pool": POOL + ["--mode", "linear", "--constant_init", "10",
                    "--num_iterations", "44", "--i_print", "1",
                    "--i_weights", "22"],
    "occ": TINY + ["--mode", "linear", "--constant_init", "2",
                   "--num_iterations", "14", "--i_print", "1",
                   "--i_weights", "7", "--occ_warmup", "6"] + OCC,
}


@pytest.mark.parametrize("case", list(NVS_RUNS))
def test_steps_per_dispatch_changes_no_number(scene_dir, tmp_path, case):
    for n in ("1", "4"):
        run_plnerf.main(["--task", "train"] + NVS_RUNS[case] + CPU + [
            "--steps_per_dispatch", n] + _where(scene_dir, str(tmp_path),
                                                "n" + n))
    _same_runs(str(tmp_path / "n1"), str(tmp_path / "n4"))


def test_depth_steps_per_dispatch_changes_no_number(depth_scene, tmp_path):
    """The depth recipe with camera embeddings and the grid, past the
    scale / shift freeze."""
    flags = ["train"] + DEPTH_TINY + DEPTH_NARROW + OCC + CPU + [
        "--occ_warmup", "5", "--num_iterations", "14", "--i_print", "1",
        "--i_weights", "7", "--freeze_ss", "9", "--input_ch_cam", "3",
        "--opt_ch_cam"]
    for n in ("1", "4"):
        run_depth.main(flags + ["--steps_per_dispatch", n] + _where(
            depth_scene, str(tmp_path), "n" + n))
    _same_runs(str(tmp_path / "n1"), str(tmp_path / "n4"))


def test_resume_off_the_window_grid(scene_dir, tmp_path):
    """A run to step 10 then resumed to 23: at N 4 its windows restart
    at 11, off the multiples of 4, and every number equals N 1's."""
    base = ["--task", "train"] + TINY + CPU + [
        "--mode", "linear", "--constant_init", "6", "--precrop_iters", "3",
        "--i_print", "1", "--i_weights", "10"]
    for n in ("1", "4"):
        where = _where(scene_dir, str(tmp_path), "n" + n)
        for stop in ("10", "23"):
            run_plnerf.main(base + where + ["--steps_per_dispatch", n,
                                            "--num_iterations", stop])
    # windows 11-14, 15-18, 19-22, 23: i_weights 10 fires at 22
    assert _ckpts(str(tmp_path / "n4")) == [
        "000010.ckpt", "000022.ckpt", "000023.ckpt"]
    _same_runs(str(tmp_path / "n1"), str(tmp_path / "n4"))
