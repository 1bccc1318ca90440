"""Checkpoint interop of the port against the JAX package, on the CPU:
the port's msgpack reader (``checkpoint/flax_msgpack.py``) against
``flax.serialization.msgpack_restore`` on checkpoints the JAX drivers
wrote (``run_plnerf`` with its ``.occ`` grid, ``run_depth``); those
checkpoints restored into the port's drivers (``--ft_path``, resume) and
rendering the JAX driver's eval_det test image; the reference ``.tar``
both ways (``checkpoint/convert_torch.py`` against
``plnerf/checkpoint/convert_torch.py``); the ``.tar`` export tools; and
the depth fault injection against the JAX functions."""
import json
import os
import shutil

import numpy as np
import pytest
import torch

import flax.serialization as fser
import jax

from plnerf.checkpoint import convert_torch as jconvert
from plnerf.cli import run_depth as jrun_depth
from plnerf.cli import run_plnerf as jrun
from plnerf.data import fault_injection as jfault
from plnerf_torch.checkpoint import convert_torch, flax_msgpack
from plnerf_torch.checkpoint import io as ckio
from plnerf_torch.cli import run_depth, run_plnerf
from plnerf_torch.core import occgrid as og
from plnerf_torch.data import fault_injection
from plnerf_torch.data import png
from plnerf_torch.tools import export_reference_ckpt as port_tool

from fixtures import make_blender2_scene, make_blender_scene
from test_torch_mlp import np_params
from test_torch_cli import CPU, TINY, _metrics_txt
from tools.export_reference_ckpt import _digitlist, _find_adam
from tools.export_reference_ckpt import main as jax_tool

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OCC_CONFIG = os.path.join(REPO, "configs", "blender_linear_occ.txt")
OCC_TINY = TINY + ["--mode", "linear", "--precrop_iters", "3",
                   "--constant_init", "2", "--mlp_dtype", "float32",
                   "--occ_warmup", "3", "--occ_res", "16",
                   "--occ_candidates", "16"]
DEPTH = ["--dataset", "blender2_depth", "--mode", "linear", "--N_rand",
         "64", "--N_samples", "8", "--N_importance", "8", "--netdepth", "2",
         "--netwidth", "16", "--multires", "4", "--chunk", "512",
         "--lrate", "5e-3", "--i_print", "10", "--set_near_plane", "2.0",
         "--space_carving_weight", "0.007", "--warm_start_nerf", "2",
         "--freeze_ss", "10", "--scaleshift_lr", "1e-3", "--white_bkgd"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Checkpoints of the JAX drivers: 6 occ-recipe steps of run_plnerf
    (``000006.ckpt`` and its grid ``000006.occ``) and 4 steps of
    run_depth (``000004.ckpt``), with real Adam moments."""
    root = tmp_path_factory.mktemp("interop")
    make_blender_scene(str(root / "scene"), n_train=3, n_val=1, n_test=1)
    make_blender2_scene(str(root / "dscene"), n_train=3, n_test=2,
                        with_depth=True)
    nvs = ["--config", OCC_CONFIG] + OCC_TINY + [
        "--data_dir", str(root), "--scene_id", "scene", "--ckpt_dir",
        str(root / "ck")]
    jrun.main(nvs + ["--task", "train", "--expname", "jax",
                     "--num_iterations", "6", "--i_weights", "6"])
    depth = DEPTH + ["--data_dir", str(root), "--scene_id", "dscene",
                     "--ckpt_dir", str(root / "ck")]
    jrun_depth.main(["train"] + depth + ["--expname", "jdepth",
                                         "--num_iterations", "4",
                                         "--i_weights", "4"])
    return {"root": root, "nvs": nvs, "depth": depth,
            "ckpt": str(root / "ck" / "jax" / "000006.ckpt"),
            "occ": str(root / "ck" / "jax" / "000006.occ"),
            "dckpt": str(root / "ck" / "jdepth" / "000004.ckpt")}


def _same_tree(a, b, path="."):
    """flax's tree ``a`` and the port reader's ``b``: the same keys in
    the same order, values of the same type, arrays of the same dtype,
    shape and bits."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b), path
        for k in a:
            _same_tree(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, list):
        assert isinstance(b, list) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _same_tree(x, y, f"{path}/{i}")
    elif isinstance(b, torch.Tensor):
        assert str(a.dtype) == "bfloat16" and b.dtype == torch.bfloat16, path
        np.testing.assert_array_equal(np.asarray(a, np.float32),
                                      b.float().numpy(), err_msg=path)
    elif isinstance(a, (np.ndarray, np.generic)):
        assert type(a) is type(b) and a.dtype == b.dtype, path
        assert a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert type(a) is type(b) and a == b, path


@pytest.mark.parametrize("which", ["ckpt", "occ", "dckpt"])
def test_msgpack_reader_matches_flax(runs, which):
    with open(runs[which], "rb") as f:
        data = f.read()
    _same_tree(fser.msgpack_restore(data), flax_msgpack.msgpack_restore(data))
    assert flax_msgpack.is_flax_file(runs[which])


def test_msgpack_reader_types(monkeypatch):
    """Every type flax writes, bfloat16 as a torch tensor, and a clear
    refusal of flax's chunked arrays."""
    tree = {"f32": np.arange(12, dtype=np.float32).reshape(3, 4),
            "ints": [0, 1, 127, 128, 255, 256, 65536, 2 ** 33, -1, -32, -33,
                     -129, -40000, -2 ** 40],
            "floats": [1.5, -2.25e300], "flags": [True, False, None],
            "strs": ["a", "x" * 40, "y" * 300, "z" * 70000],
            "bin": b"\x00\x01" * 200, "cplx": complex(1.0, -2.0),
            "scalar": np.float32(3.0), "i64": np.int64(-5),
            "bf16": jax.numpy.asarray(np.linspace(-3, 3, 40), "bfloat16"),
            "u8": np.arange(200, dtype=np.uint8), "empty": {},
            "wide": {str(i): np.float64(i) for i in range(20)},
            "none_shape": np.zeros((0, 3), np.float16)}
    data = fser.msgpack_serialize(tree)
    _same_tree(fser.msgpack_restore(data), flax_msgpack.msgpack_restore(data))
    monkeypatch.setattr(fser, "MAX_CHUNK_SIZE", 16)
    data = fser.msgpack_serialize({"a": np.zeros(64, np.float32)})
    with pytest.raises(ValueError, match="chunked"):
        flax_msgpack.msgpack_restore(data)


def _jax_leaf(tree, name):
    """The JAX-layout leaf of a torch parameter name, as torch lays it."""
    parts = name.split(".")
    node = tree[parts[0]]
    if parts[1].isdigit():
        node = node[int(parts[1])]
    a = np.asarray(node["w" if parts[-1] == "weight" else "b"], np.float32)
    return a.T if parts[-1] == "weight" else a


def _check_state(state, raw):
    """The port's restored state against the JAX state flax reads."""
    raw = _digitlist(raw)
    assert state.step == int(raw["step"])
    nets = {"params_coarse": state.params_coarse,
            "params_fine": state.params_fine}
    for key, module in nets.items():
        for name, p in module.named_parameters():
            np.testing.assert_array_equal(p.detach().numpy(),
                                          _jax_leaf(raw[key], name))
    for key in ("depth_scales", "depth_shifts"):
        if raw.get(key) is not None:
            np.testing.assert_array_equal(getattr(state, key).detach().numpy(),
                                          raw[key])
    for key in ("opt_coarse", "opt_fine"):
        adam = _find_adam(raw.get(key))
        if adam is None:
            assert getattr(state, key) is None, key
            continue
        opt = getattr(state, key)
        assert opt.count == int(adam["count"]) > 0, key
        mods = ([("params_coarse", 0), ("params_fine", 1)]
                if isinstance(adam["mu"], list) else
                [("params_coarse" if key == "opt_coarse" else "params_fine",
                  None)])
        ps = [(p, k, j, name) for k, j in mods
              for name, p in nets[k].named_parameters()]
        assert [id(p) for p, *_ in ps] == [
            id(p) for g in opt.param_groups for p in g["params"]]
        for p, k, j, name in ps:
            for moment, slot in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
                tree = adam[moment] if j is None else adam[moment][j]
                np.testing.assert_array_equal(
                    opt.state[p][slot].numpy(), _jax_leaf(tree, name),
                    err_msg=f"{key} {name} {moment}")


def test_port_drivers_restore_jax_checkpoints(runs, tmp_path):
    """run_plnerf resumes the JAX driver's checkpoint through --ft_path,
    with its grid, and run_depth resumes the JAX depth checkpoint from its
    experiment folder: parameters, Adam moments and counts, depth scales
    and shifts as flax reads them."""
    state = run_plnerf.main(runs["nvs"] + CPU + [
        "--task", "train", "--expname", "port", "--ckpt_dir", str(tmp_path),
        "--ft_path", runs["ckpt"], "--num_iterations", "6"])
    with open(runs["ckpt"], "rb") as f:
        _check_state(state, fser.msgpack_restore(f.read()))

    os.makedirs(tmp_path / "dport")
    shutil.copy(runs["dckpt"], tmp_path / "dport" / "000004.ckpt")
    dstate = run_depth.main(["train"] + runs["depth"] + CPU + [
        "--ckpt_dir", str(tmp_path), "--expname", "dport",
        "--num_iterations", "4"])
    with open(runs["dckpt"], "rb") as f:
        _check_state(dstate, fser.msgpack_restore(f.read()))

    grid = og.init_grid([-1.5] * 3, [1.5] * 3, og.OccGridConfig(
        resolution=16, candidates=16), "cpu")
    got = ckio.restore_aux(runs["occ"], grid, "cpu")
    with open(runs["occ"], "rb") as f:
        ref = fser.msgpack_restore(f.read())
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k].numpy(), ref[k])


def test_ft_path_jax_checkpoint_renders_like_jax(runs, tmp_path):
    """The port's ``--task test --eval_det --ft_path`` on the JAX
    checkpoint (and its grid sidecar) scores and writes what the JAX
    driver's own ``--task test --eval_det`` does, at 1e-4."""
    test = runs["nvs"] + ["--task", "test", "--eval_det", "--ckpt_dir",
                          str(tmp_path)]
    with open(os.path.join(os.path.dirname(runs["ckpt"]), "args.json")) as f:
        train_args = json.load(f)
    for who in ("jax", "port"):            # the run's args.json, renamed
        os.makedirs(tmp_path / who)
        with open(tmp_path / who / "args.json", "w") as f:
            json.dump({**train_args, "expname": who}, f)
    for ext in ("ckpt", "occ"):
        shutil.copy(runs[ext], tmp_path / "jax" / f"000006.{ext}")
    jrun.main(test + ["--expname", "jax"])
    run_plnerf.main(test + CPU + ["--expname", "port", "--ft_path",
                                  runs["ckpt"]])
    sub = "test_images_linear_8_8scene"
    got = _metrics_txt(os.path.join(tmp_path, "port", sub, "metrics.txt"))
    ref = _metrics_txt(os.path.join(tmp_path, "jax", sub, "metrics.txt"))
    assert set(got) == set(ref) and "psnr" in ref
    for k in ref:
        assert got[k] == pytest.approx(ref[k], rel=1e-4), k
    a = png.read_png(os.path.join(tmp_path, "port", sub, "0_rgb.png"))
    b = png.read_png(os.path.join(tmp_path, "jax", sub, "0_rgb.png"))
    assert np.abs(a.astype(int) - b.astype(int)).max() <= 1


def _tar(path):
    return torch.load(path, map_location="cpu", weights_only=False)


def _same_ckpt(a, b, path="."):
    """Two loaded ``.tar`` dicts: the same keys and equal values."""
    if isinstance(a, dict):
        assert set(a) == set(b), (path, sorted(a), sorted(b))
        for k in a:
            _same_ckpt(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _same_ckpt(x, y, f"{path}/{i}")
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert torch.equal(a, b), path
    else:
        assert a == b, path


def _moments(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: rng.normal(size=np.shape(a)).astype(np.float32), params)


KW = dict(netdepth=2, netwidth=32, multires=4, multires_views=2)
CASES = {"fine": (KW, False), "joint": (KW, True),
         "plain": (dict(KW, use_viewdirs=False, output_ch=4), False)}


@pytest.mark.parametrize("case", list(CASES))
def test_reference_tar_both_ways(tmp_path, case):
    """One state through both packages' ``save_reference_checkpoint``:
    equal files (keys, params, Adam state in the reference's order, the
    non-viewdirs placeholder), each read back by the other package's
    ``load_reference_checkpoint`` to the same params and step."""
    kw, joint = CASES[case]
    pc, pf = np_params(kw, seed=0), np_params(kw, seed=1)
    tree = (pc, pf) if joint else pf
    adam = (_moments(tree, 2), _moments(tree, 3), 17)
    jkind = jconvert.save_reference_checkpoint(
        str(tmp_path / "jax.tar"), 40, pc, pf, fine_adam=adam, joint=joint)
    sd = jconvert.params_to_state_dict

    def tsd(p):
        return {k: torch.from_numpy(np.ascontiguousarray(v))
                for k, v in sd(p).items()}
    mu, nu = ((tuple(tsd(t) for t in m) if joint else tsd(m))
              for m in adam[:2])
    pkind = convert_torch.save_reference_checkpoint(
        str(tmp_path / "port.tar"), 40, tsd(pc), tsd(pf),
        fine_adam=(mu, nu, 17), joint=joint)
    assert pkind == jkind
    _same_ckpt(_tar(tmp_path / "jax.tar"), _tar(tmp_path / "port.tar"))
    if case != "plain":
        assert len(_tar(tmp_path / "port.tar")["optimizer_state_dict"][
            "state"]) == 12 * (2 if joint else 1)

    got = convert_torch.load_reference_checkpoint(str(tmp_path / "jax.tar"),
                                                  "cpu")
    assert got["step"] == 40
    for key, p in (("params_coarse", pc), ("params_fine", pf)):
        assert set(got[key]) == set(sd(p))
        for k, v in sd(p).items():
            np.testing.assert_array_equal(got[key][k].numpy(), v)
    ref = jconvert.load_reference_checkpoint(str(tmp_path / "port.tar"))
    assert ref["step"] == 40
    for key, p in (("params_coarse", pc), ("params_fine", pf)):
        jax.tree.map(np.testing.assert_array_equal, ref[key], p)


def test_fresh_and_refused_reference_tars(tmp_path):
    pc = np_params(KW, seed=0)
    assert convert_torch.save_reference_checkpoint(
        str(tmp_path / "a.tar"), 0, {
            k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in jconvert.params_to_state_dict(pc).items()}) == \
        "fresh Adam state"
    torch.save({"network_fn_state_dict": {}, "bad": np.float64(1.0)},
               tmp_path / "b.tar")
    with pytest.raises(ValueError, match="weights_only"):
        convert_torch.load_reference_checkpoint(str(tmp_path / "b.tar"),
                                                "cpu")


@pytest.mark.parametrize("which", ["ckpt", "dckpt"])
def test_export_reference_ckpt_tool_matches_jax_tool(runs, tmp_path, which):
    """The port's tool on the JAX checkpoint, and on the port checkpoint
    restored from it, writes the JAX tool's ``.tar`` (real moments, the
    joint scope of the depth run, its scale / shift extras); the port
    restores that ``.tar`` to the same networks and fine Adam."""
    jax_tool(["--ckpt", runs[which], "--out", str(tmp_path / "jax.tar")])
    port_tool.main(["--ckpt", runs[which], "--out",
                    str(tmp_path / "port.tar")])
    ref = _tar(tmp_path / "jax.tar")
    _same_ckpt(ref, _tar(tmp_path / "port.tar"))
    assert ref["optimizer_state_dict"]["state"]
    assert ("depth_scales" in ref) is (which == "dckpt")

    step = ref["global_step"]
    if which == "ckpt":
        argv, main = runs["nvs"] + ["--task", "train"], run_plnerf.main
    else:
        argv, main = ["train"] + runs["depth"], run_depth.main
    os.makedirs(tmp_path / "p")
    shutil.copy(runs[which], tmp_path / "p" / f"{step:06d}.ckpt")
    state = main(argv + CPU + ["--ckpt_dir", str(tmp_path), "--expname",
                               "p", "--num_iterations", str(step)])
    assert state.step == step
    path = ckio.save_checkpoint(str(tmp_path / "q"), step,
                                state.state_dict())
    port_tool.main(["--ckpt", path, "--out", str(tmp_path / "again.tar")])
    _same_ckpt(ref, _tar(tmp_path / "again.tar"))

    tar_state = main(argv + CPU + ["--ckpt_dir", str(tmp_path), "--expname",
                                   "t", "--num_iterations", "0",
                                   "--no_reload"])
    ckio.restore_checkpoint(str(tmp_path / "port.tar"), tar_state, "cpu")
    for a, b in ((tar_state.params_coarse, state.params_coarse),
                 (tar_state.params_fine, state.params_fine)):
        for (n, p), (_, q) in zip(a.named_parameters(), b.named_parameters()):
            assert torch.equal(p, q), n
    loaded = convert_torch.load_reference_checkpoint(
        str(tmp_path / "jax.tar"), "cpu")
    for k in ("depth_scales", "depth_shifts"):
        assert (k in loaded) is (which == "dckpt")
        if k in loaded:
            assert torch.equal(loaded[k], ref[k])
            assert torch.equal(getattr(tar_state, k), getattr(state, k))
    ps = [p for g in state.opt_fine.param_groups for p in g["params"]]
    qs = [p for g in tar_state.opt_fine.param_groups for p in g["params"]]
    assert tar_state.opt_fine.count == state.opt_fine.count
    for p, q in zip(ps, qs):
        for slot in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(state.opt_fine.state[p][slot],
                               tar_state.opt_fine.state[q][slot])


@pytest.mark.parametrize("seed", [0, 5])
def test_fault_injection_matches_jax(seed):
    rng = np.random.default_rng(seed)
    depth = rng.uniform(0.5, 6.0, (12, 16)).astype(np.float32)
    valid = rng.uniform(size=(12, 16)) > 0.2
    for p in (0.1, 0.5):
        got = fault_injection.add_missing_depth(depth, valid, p, seed=seed)
        ref = jfault.add_missing_depth(depth, valid, p, seed=seed)
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(
        fault_injection.add_quadratic_depth_noise(depth, valid, seed=seed),
        jfault.add_quadratic_depth_noise(depth, valid, seed=seed))
    got = fault_injection.create_random_subsets(range(23), 5, seed=seed)
    ref = jfault.create_random_subsets(range(23), 5, seed=seed)
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)
