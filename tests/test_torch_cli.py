"""The port's drivers (plnerf_torch/cli/) against the JAX package's on the
CPU: every shipped config parses to the same values, ``build_configs``
gives the same configs, args.json round-trips, train -> checkpoint ->
resume -> test and the vanilla pool mode run end to end, and the slice as
a whole: weights the JAX driver trained, carried into a port checkpoint,
score the same held-out metrics and write the same pixels as JAX's own
``--task test --eval_det``."""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

from plnerf.checkpoint import io as jckio
from plnerf.cli import config as jconfig
from plnerf.cli import run_plnerf as jrun
from plnerf.train import step as jstep
from plnerf_torch.checkpoint import convert_jax
from plnerf_torch.checkpoint import io as ckio
from plnerf_torch.cli import config, run_plnerf, run_vanilla
from plnerf_torch.data import png
from plnerf_torch.eval import images as EI

from fixtures import make_blender_scene
from test_torch_lpips import write_npz

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(os.listdir(os.path.join(REPO, "configs")))
# the tiny flags of tests/test_cli.py
TINY = [
    "--dataset", "blender", "--no_batching", "--use_viewdirs",
    "--white_bkgd", "--N_rand", "64", "--N_samples", "8",
    "--N_importance", "8", "--netdepth", "2", "--netwidth", "16",
    "--multires", "4", "--multires_views", "2", "--chunk", "256",
    "--lrate", "5e-3", "--i_print", "5", "--i_img", "1000000",
    "--i_testset", "1000000", "--i_video", "1000000", "--testskip", "1",
]
CPU = ["--device", "cpu"]
KERNEL_FLAGS = ("use_pallas", "use_kernel", "device")


@pytest.fixture(scope="module")
def scene_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("data") / "tinyscene"
    make_blender_scene(str(d), n_train=3, n_val=1, n_test=1)
    return str(d.parent), "tinyscene"


def _vars(ns):
    return {k: v for k, v in vars(ns).items() if k not in KERNEL_FLAGS}


@pytest.mark.parametrize("name", CONFIGS)
def test_config_parses_like_jax(name):
    argv = ["--config", os.path.join(REPO, "configs", name)]
    got = config.config_parser().parse_args(argv)
    ref = jconfig.config_parser().parse_args(argv)
    assert _vars(got) == _vars(ref)
    assert got.use_kernel is None and got.device is None


def test_test_overrides_follow_jax():
    ref = [k for k in jconfig._TEST_OVERRIDES if k != "use_pallas"]
    assert [k for k in config._TEST_OVERRIDES
            if k not in ("use_kernel", "device")] == ref
    assert {"use_kernel", "device"} <= set(config._TEST_OVERRIDES)


@pytest.mark.parametrize("flags", [
    [], ["--mode", "constant", "--netdepth_fine", "3",
         "--netwidth_fine", "24"], ["--mlp_dtype", "bfloat16", "--remat",
                                    "--grad_accum", "2"]])
@pytest.mark.parametrize("kernel", [None, True, False])
@pytest.mark.parametrize("vanilla", [False, True])
def test_build_configs_matches_jax(flags, kernel, vanilla):
    argv = ["--config", os.path.join(REPO, "configs", "blender_linear.txt")]
    argv += flags
    on = {True: "--{}", False: "--no-{}", None: None}[kernel]
    jargv = argv + ([on.format("use_pallas")] if on else [])
    targv = argv + CPU + ([on.format("use_kernel")] if on else [])
    jm, jr, js = jrun.build_configs(jconfig.config_parser().parse_args(jargv),
                                    vanilla=vanilla)
    tm, tr, ts = run_plnerf.build_configs(
        config.config_parser().parse_args(targv), vanilla=vanilla)
    assert dataclasses.asdict(tm) == dataclasses.asdict(jm)
    jd, td = dataclasses.asdict(jr), dataclasses.asdict(tr)
    jd["use_fused_mlp"] = jd.pop("use_pallas_mlp")
    jd["fused_fold_heads"] = jd.pop("pallas_fold_heads")
    assert td == jd
    # AUTO is off on the CPU, like the JAX package's off the TPU
    assert tr.use_fused_mlp is bool(kernel)
    for f in dataclasses.fields(ts):
        got, ref = getattr(ts, f.name), getattr(js, f.name)
        if dataclasses.is_dataclass(got):
            got, ref = dataclasses.asdict(got), dataclasses.asdict(ref)
            if "use_pallas_mlp" in ref:
                ref["use_fused_mlp"] = ref.pop("use_pallas_mlp")
                ref["fused_fold_heads"] = ref.pop("pallas_fold_heads")
        assert got == ref, f.name


def test_args_json_round_trip(tmp_path):
    ckpt = str(tmp_path)
    train = config.config_parser().parse_args(
        TINY + CPU + ["--ckpt_dir", ckpt, "--expname", "e", "--seed", "3",
                      "--use_kernel"])
    config.resolve_args(train)
    with open(os.path.join(ckpt, "e", "args.json")) as f:
        assert json.load(f) == vars(train)
    test = config.config_parser().parse_args(
        ["--task", "test", "--ckpt_dir", ckpt, "--expname", "e",
         "--data_dir", "elsewhere", "--chunk", "64", "--eval_det",
         "--device", "cpu"])
    merged = config.resolve_args(test)
    for k, v in vars(merged).items():
        want = getattr(test if k in config._TEST_OVERRIDES else train, k)
        assert v == want, k
    assert merged.chunk == 256 and merged.seed == 3     # trained values
    assert merged.use_kernel is None and merged.eval_det  # CLI values


def test_entry_point_needs_cuda_unless_cpu_is_asked(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_plnerf.main(TINY + ["--ckpt_dir", str(tmp_path), "--expname",
                                "e", "--num_iterations", "1"])
    assert not os.path.exists(tmp_path / "e")


@pytest.mark.parametrize("flags, world, item", [
    (["--task", "export_serving", "--serve_platforms", "tpu"], None,
     "serve_platforms tpu"),
    (["--N_rand", "63"], "2", "--N_rand 63 does not split over the 2 ranks"),
    (["--no_mesh"], "2", "--no_mesh under torchrun with WORLD_SIZE 2")],
    ids=["flags0-serve_platforms tpu", "flags1-N_rand 63 WORLD_SIZE 2",
         "flags2-no_mesh WORLD_SIZE 2"])
def test_unported_paths_are_refused(scene_dir, tmp_path, monkeypatch, flags,
                                    world, item):
    """What cannot run is refused before anything is written: an export
    for another device, a train batch that does not split over the ranks
    of a ``torchrun`` launch (``WORLD_SIZE``), ``--no_mesh`` under one
    (refused before the process group is joined).  ``--profile``,
    ``--lpips_weights`` and ``--steps_per_dispatch`` above 1, refused
    before the profiler, LPIPS, data parallelism and the dispatch windows
    were ported, run: see ``test_profile_flag_writes_a_trace``,
    ``test_train_resume_test`` and ``tests/test_torch_dispatch.py``."""
    data_dir, scene_id = scene_dir
    if world:
        monkeypatch.setenv("WORLD_SIZE", world)
    args = TINY + CPU + ["--data_dir", data_dir, "--scene_id", scene_id,
                         "--ckpt_dir", str(tmp_path), "--expname", "e"]
    with pytest.raises(SystemExit, match=item):
        run_plnerf.main(args + flags)
    assert not os.path.exists(tmp_path / "e")


def test_profile_flag_writes_a_trace(scene_dir, tmp_path, capsys):
    """``--profile 2``: a torch.profiler trace of steps 4-5 of a 7-step
    run, written under ``<expname>/profile/``, and the top-ops table
    printed (host ops on the CPU, where no device time exists)."""
    data_dir, scene_id = scene_dir
    run_plnerf.main(TINY + CPU + [
        "--data_dir", data_dir, "--scene_id", scene_id, "--ckpt_dir",
        str(tmp_path), "--expname", "e", "--num_iterations", "7",
        "--i_weights", "7", "--profile", "2"])
    trace = tmp_path / "e" / "profile" / "trace_000004.json"
    assert json.loads(trace.read_text())["traceEvents"]
    out = capsys.readouterr().out
    assert f"Wrote profiler trace of steps 4-5 to {trace}" in out
    table = out.split("[profile] top_host_ops (ms per step):\n")[1]
    assert float(table.split()[0]) > 0
    assert "[profile] device idle" in out


@pytest.mark.parametrize("flags, name", [
    (["--task", "video"], "--task video"),
    (["--render_only"], "--render_only"),
    (["--i_video", "5", "--num_iterations", "12"], "--i_video 5")])
def test_remaining_a8_paths_name_themselves(scene_dir, tmp_path, flags,
                                            name):
    """The video paths (A8, ported) run on the CPU: each writes its frames
    into the ``renderonly_path_{step:06d}`` folder the JAX driver names,
    40 frames of the camera path and the ``video/`` copies; ``--i_video
    5`` fires at steps 5 and 10 of a 12-step run.  Nothing is refused."""
    data_dir, scene_id = scene_dir
    args = TINY + CPU + ["--data_dir", data_dir, "--scene_id", scene_id,
                         "--ckpt_dir", str(tmp_path), "--expname", "e",
                         "--render_factor", "8"]
    if name == "--task video":                 # it reads args.json
        run_plnerf.main(args + ["--num_iterations", "0"])
    run_plnerf.main(args + flags)
    exp = tmp_path / "e"
    folders = sorted(d for d in os.listdir(exp) if d.startswith("renderonly"))
    steps = [5, 10] if name == "--i_video 5" else [0]
    assert folders == [f"renderonly_path_{s:06d}" for s in steps], name
    for d in folders:
        frames = sorted(os.listdir(exp / d))
        assert frames == [f"{i:03d}.png" for i in range(40)] + ["video"]
        assert png.read_png(str(exp / d / "039.png")).shape == (4, 4, 3)
        assert len(os.listdir(exp / d / "video")) == 40


def test_llff_config_trains_resumes_and_tests(tmp_path):
    """``--config configs/llff_linear.txt`` (NDC, pool batching) on the
    forward-facing fixture at tiny widths: train, resume, test."""
    from plnerf_torch.data.synthetic import make_llff_fixture

    make_llff_fixture(str(tmp_path / "data" / "ff"), n=5, H=12, W=16)
    common = ["--config", os.path.join(REPO, "configs", "llff_linear.txt"),
              "--data_dir", str(tmp_path / "data"), "--scene_id", "ff",
              "--ckpt_dir", str(tmp_path / "ck"), "--expname", "l",
              "--factor", "1", "--llffhold", "4"] + CPU
    tiny = ["--N_rand", "64", "--N_samples", "8", "--N_importance", "8",
            "--netdepth", "2", "--netwidth", "16", "--multires", "4",
            "--multires_views", "2", "--chunk", "512", "--i_print", "3",
            "--i_img", "6", "--i_testset", "1000000",
            "--i_video", "1000000", "--constant_init", "3"]
    state = run_plnerf.main(common + tiny + ["--num_iterations", "6",
                                             "--i_weights", "6"])
    assert state.step == 6
    state = run_plnerf.main(common + tiny + ["--num_iterations", "9",
                                             "--i_weights", "9"])
    exp = tmp_path / "ck" / "l"
    assert state.step == 9 and os.path.exists(exp / "000009.ckpt")
    assert os.path.exists(exp / "val" / "rgb_000006.png")
    mm = run_plnerf.main(common + ["--task", "test"])
    sub = exp / "test_images_linear_8_8ff"
    assert np.isfinite(mm.get("psnr"))
    assert png.read_png(str(sub / "1_rgb.png")).shape == (12, 16, 3)


@pytest.mark.parametrize("dataset", ["DTU", "DTU2"])
def test_dtu_cli_train_and_test(tmp_path, dataset):
    """``--dataset DTU`` / ``DTU2`` end to end: the 49-view fixture, the
    split.json dump, a short train and the test task."""
    from fixtures import make_dtu2_scene, make_dtu_scene

    data_dir = str(tmp_path / "dtu")
    (make_dtu_scene if dataset == "DTU" else make_dtu2_scene)(data_dir, 5)
    common = list(TINY)
    common[common.index("--dataset") + 1] = dataset
    common += CPU + ["--dtu_scene_id", "5", "--num_train", "42",
                     "--half_res", "--data_dir", data_dir,
                     "--ckpt_dir", str(tmp_path / "ck"), "--expname", "d"]
    run_plnerf.main(common + ["--task", "train", "--mode", "constant",
                              "--num_iterations", "4", "--i_weights", "4"])
    exp = tmp_path / "ck" / "d"
    assert os.path.exists(exp / "000004.ckpt")
    split = json.load(open(exp / "split.json"))
    assert (len(split["train_frames"]), len(split["test_frames"])) == (42, 7)
    run_plnerf.main(["--task", "test", "--ckpt_dir", str(tmp_path / "ck"),
                     "--expname", "d", "--data_dir", data_dir,
                     "--dataset", dataset] + CPU)
    sub, = [d for d in os.listdir(exp) if d.startswith("test_images_")]
    assert "psnr: " in open(exp / sub / "metrics.txt").read()
    assert png.read_png(str(exp / sub / "6_rgb.png")).shape == (16, 16, 3)


def test_train_resume_test(scene_dir, tmp_path):
    data_dir, scene_id = scene_dir
    ckpt_dir = str(tmp_path / "ckpts")
    common = TINY + CPU + ["--data_dir", data_dir, "--scene_id", scene_id,
                           "--ckpt_dir", ckpt_dir, "--expname", "exp"]
    # a val render at 10 and a test set at 10 (the last flags win)
    state = run_plnerf.main(common + [
        "--task", "train", "--mode", "linear", "--constant_init", "3",
        "--precrop_iters", "4", "--num_iterations", "12",
        "--i_weights", "10", "--i_img", "10", "--i_testset", "10"])
    exp = os.path.join(ckpt_dir, "exp")
    assert state.step == 12 and state.opt_fine.count == 12
    assert os.path.exists(os.path.join(exp, "args.json"))
    assert [os.path.basename(p) for p in ckio.list_checkpoints(exp)] == [
        "000010.ckpt", "000012.ckpt"]
    with open(os.path.join(exp, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    assert [r["step"] for r in recs if "train/psnr" in r] == [5, 10]
    assert [r["step"] for r in recs if "val/psnr" in r] == [10]
    assert png.read_png(os.path.join(exp, "val", "rgb_000010.png")).shape \
        == (32, 32, 3)
    assert os.path.exists(os.path.join(
        exp, f"test_images_linear_8_8{scene_id}_000010", "metrics.txt"))

    state = run_plnerf.main(common + [
        "--task", "train", "--mode", "linear", "--constant_init", "3",
        "--num_iterations", "16", "--i_weights", "16"])
    assert state.step == 16 and state.opt_coarse.count == 16
    assert os.path.exists(os.path.join(exp, "000016.ckpt"))

    mm = run_plnerf.main(["--task", "test", "--ckpt_dir", ckpt_dir,
                          "--expname", "exp", "--data_dir", data_dir,
                          "--scene_id", scene_id, "--white_bkgd"] + CPU)
    test_dir = os.path.join(exp, f"test_images_linear_8_8{scene_id}")
    text = open(os.path.join(test_dir, "metrics.txt")).read()
    assert f"psnr: {mm.get('psnr')}" in text and "ssim: " in text
    # no weights file: the JAX package's note
    assert f"lpips: {EI.LPIPS_UNAVAILABLE}\n" in text

    # with one, an lpips row
    weights = str(tmp_path / "lpips.npz")
    write_npz(weights)
    mm = run_plnerf.main(["--task", "test", "--ckpt_dir", ckpt_dir,
                          "--expname", "exp", "--data_dir", data_dir,
                          "--scene_id", scene_id, "--white_bkgd",
                          "--lpips_weights", weights] + CPU)
    text = open(os.path.join(test_dir, "metrics.txt")).read()
    assert f"lpips: {mm.get('lpips')}\n" in text and mm.get("lpips") > 0
    rgb = png.read_png(os.path.join(test_dir, "0_rgb.png"))
    assert rgb.shape == (32, 32, 3)


def test_training_imports_no_image_library(scene_dir, tmp_path):
    """A run whose val render fires loads none of the libraries the port
    must not use (the import check of test_torch_serving.py sees modules
    imported, not what a run pulls in)."""
    data_dir, scene_id = scene_dir
    argv = TINY + CPU + [
        "--data_dir", data_dir, "--scene_id", scene_id, "--ckpt_dir",
        str(tmp_path), "--expname", "e", "--num_iterations", "4",
        "--i_img", "2", "--i_weights", "4"]
    banned = ("jax", "plnerf", "tools", "cv2", "imageio", "PIL",
              "tensorflow")
    code = ("import sys, torch\n"
            "torch.set_num_threads(1)\n"
            "from plnerf_torch.cli import run_plnerf\n"
            f"run_plnerf.main({argv!r})\n"
            "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
            f"{banned!r})\n"
            "print(bad)\nsys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert os.path.exists(tmp_path / "e" / "val" / "rgb_000004.png")


def test_vanilla_pool_mode(scene_dir, tmp_path):
    data_dir, scene_id = scene_dir
    ckpt_dir = str(tmp_path / "ckpts_v")
    args = [a for a in TINY if a != "--no_batching"] + CPU
    state = run_vanilla.main(args + [
        "--task", "train", "--mode", "constant", "--data_dir", data_dir,
        "--scene_id", scene_id, "--ckpt_dir", ckpt_dir, "--expname", "v",
        "--num_iterations", "8", "--i_weights", "8"])
    assert state.step == 8 and state.opt_coarse is None
    assert state.opt_fine.count == 8
    assert os.path.exists(os.path.join(ckpt_dir, "v", "000008.ckpt"))


def _metrics_txt(path):
    out = {}
    for line in open(path):
        k, v = line.split(": ", 1)
        if k != "lpips":
            out[k] = float(v)
    return out


def test_slice_matches_jax(scene_dir, tmp_path):
    """JAX trains 12 tiny steps; its weights, carried into a port
    checkpoint, go through the port's ``--task test --eval_det``."""
    data_dir, scene_id = scene_dir
    ckpt_dir = str(tmp_path)
    common = TINY + ["--data_dir", data_dir, "--scene_id", scene_id,
                     "--ckpt_dir", ckpt_dir, "--mode", "linear",
                     "--constant_init", "3", "--precrop_iters", "4"]
    jrun.main(common + ["--task", "train", "--expname", "jax",
                        "--num_iterations", "12", "--i_weights", "12"])
    jargs = jconfig.config_parser().parse_args(common + ["--expname", "jax"])
    _, _, jsetup = jrun.build_configs(jargs)
    jstate = jckio.restore_checkpoint(
        os.path.join(ckpt_dir, "jax", "000012.ckpt"),
        jstep.init_state(jax.random.PRNGKey(0), jsetup))

    # the port's experiment: args.json from a 0-step run, then the weights
    state = run_plnerf.main(common + CPU + [
        "--task", "train", "--expname", "port", "--num_iterations", "0"])
    for module, params in ((state.params_coarse, jstate.params_coarse),
                           (state.params_fine, jstate.params_fine)):
        convert_jax.load_jax_params(module, jax.tree.map(np.array, params))
    state.step = 12
    ckio.save_checkpoint(os.path.join(ckpt_dir, "port"), 12,
                         state.state_dict())

    test = ["--task", "test", "--ckpt_dir", ckpt_dir, "--data_dir", data_dir,
            "--scene_id", scene_id, "--white_bkgd", "--eval_det"]
    jrun.main(test + ["--expname", "jax"])
    run_plnerf.main(test + CPU + ["--expname", "port"])
    sub = f"test_images_linear_8_8{scene_id}"
    got = _metrics_txt(os.path.join(ckpt_dir, "port", sub, "metrics.txt"))
    ref = _metrics_txt(os.path.join(ckpt_dir, "jax", sub, "metrics.txt"))
    assert set(got) == set(ref) == {"img_loss", "psnr", "ssim", "img_loss0",
                                    "psnr0"}
    for k in ref:
        assert got[k] == pytest.approx(ref[k], rel=1e-4), k
    a = png.read_png(os.path.join(ckpt_dir, "port", sub, "0_rgb.png"))
    b = png.read_png(os.path.join(ckpt_dir, "jax", sub, "0_rgb.png"))
    assert a.shape == b.shape == (32, 32, 3)
    assert np.abs(a.astype(int) - b.astype(int)).max() <= 1
