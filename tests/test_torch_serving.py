"""The port's serving slice against the JAX package's: ``ServingRenderer``
built from the same weights as a ``jax.export`` artifact, image rendering,
the device rule of the port's entry points, and the port's isolation from
JAX and from the ``plnerf`` package."""
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

from plnerf.core.config import ModelConfig as JModelConfig
from plnerf.core.config import RenderConfig as JRenderConfig
from plnerf.eval import images as jimages
from plnerf.serving import export as jexport
from plnerf.serving.runtime import ServingRenderer as JServingRenderer
from plnerf_torch.core.config import ModelConfig, RenderConfig
from plnerf_torch.core.mlp import NeRF
from plnerf_torch.eval import images
from plnerf_torch.serving.runtime import ServingRenderer

from test_torch_mlp import np_params, torch_model

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KW = dict(netdepth=2, netwidth=32, multires=4, multires_views=2)
RKW = dict(n_samples=16, n_importance=8, mode="linear", white_bkgd=True)
TOLS = {"rgb_map": 1e-4, "acc_map": 1e-4, "depth_map": 1e-4,
        "rgb0": 1e-4, "depth0": 1e-4}


def _params():
    pc, pf = np_params(KW, seed=0), np_params(KW, seed=1)
    for p in (pc, pf):              # visible content
        p["alpha_linear"]["b"] = p["alpha_linear"]["b"] + 2.0
    return pc, pf


def _rays(n, seed=0):
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(n, 3)).astype(np.float32)
    o = 4.0 * o / np.linalg.norm(o, axis=-1, keepdims=True)
    d = -o / 4.0 + 0.1 * rng.normal(size=(n, 3)).astype(np.float32)
    vd = d / np.linalg.norm(d, axis=-1, keepdims=True)
    return np.concatenate([o, d, np.full((n, 1), 2.0, np.float32),
                           np.full((n, 1), 6.0, np.float32), vd], -1)


def _servers(tmp_path, chunk=64):
    """The JAX artifact and the port's renderer, same weights, eval_det
    test config; the port's main path (fused MLP) is on."""
    pc, pf = _params()
    jr = jimages.test_render_config(JRenderConfig(**RKW), perturb=False)
    jexport.export_renderer(pc, pf, JModelConfig(**KW), jr, str(tmp_path),
                            chunk=chunk)
    rcfg = images.test_render_config(RenderConfig(**RKW), perturb=False,
                                     use_fused_mlp=True)
    srv = ServingRenderer.from_params(torch_model(KW, pc),
                                      torch_model(KW, pf), ModelConfig(**KW),
                                      rcfg, chunk=chunk, device="cpu")
    return JServingRenderer.load(str(tmp_path)), srv, (pc, pf)


def _check(got, ref, keys):
    assert set(got) == set(keys)
    for k in keys:
        assert got[k].shape == ref[k].shape, k
        if k == "disp_map":
            np.testing.assert_allclose(got[k], ref[k], rtol=1e-4, err_msg=k)
        else:
            np.testing.assert_allclose(got[k], ref[k], atol=TOLS[k],
                                       rtol=TOLS[k], err_msg=k)


def test_serving_matches_jax_artifact(tmp_path):
    jsrv, srv, _ = _servers(tmp_path)
    rays = _rays(150)                  # not a chunk multiple: pads, cuts
    ref = jsrv.render_rays(rays, seed=3)
    got = srv.render_rays(rays, seed=3)
    assert all(v.shape[0] == 150 for v in got.values())
    _check(got, ref, sorted(ref))
    assert float(got["acc_map"].min()) > 0.05

    sel = srv.render_rays(rays, seed=3, keys=["rgb_map", "depth_map"])
    assert set(sel) == {"rgb_map", "depth_map"}
    np.testing.assert_array_equal(sel["rgb_map"], got["rgb_map"])


def test_serving_render_image_matches_jax(tmp_path):
    jsrv, srv, (pc, pf) = _servers(tmp_path)
    H = W = 8
    focal = 10.0
    K = np.array([[focal, 0, W / 2], [0, focal, H / 2], [0, 0, 1]],
                 np.float32)
    c2w = np.eye(4, dtype=np.float32)[:3]
    c2w[2, 3] = 4.0
    ref = jsrv.render_image(c2w, (H, W, focal), K)
    got = srv.render_image(c2w, (H, W, focal), K)
    _check(got, ref, sorted(ref))
    assert got["rgb_map"].shape == (H, W, 3)

    # the eval frontend renders the same image
    jr = jimages.test_render_config(JRenderConfig(**RKW), perturb=False)
    ref_eval = jimages.render_image(pc, pf, c2w, (H, W, focal), K,
                                    JModelConfig(**KW), jr,
                                    jax.random.PRNGKey(0), chunk=48)
    with torch.no_grad():
        got_eval = images.render_image(
            srv.params_c, srv.params_f, c2w, (H, W, focal), K,
            ModelConfig(**KW), srv.rcfg, chunk=48)
    _check(got_eval, ref_eval, sorted(ref_eval))


def test_test_render_config_keeps_the_perturb_quirk():
    r = images.test_render_config(RenderConfig(raw_noise_std=1.0,
                                               perturb=False, retraw=True))
    assert r.perturb is True and r.raw_noise_std == 0.0 and not r.retraw
    assert images.test_render_config(r, perturb=False).perturb is False


def test_entry_points_need_cuda_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    cfg = ModelConfig(**KW)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        NeRF(cfg)
    m = NeRF(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingRenderer.from_params(m, m, cfg, RenderConfig(**RKW))


def _port_modules():
    root = os.path.join(REPO, "plnerf_torch")
    for dirpath, _, files in os.walk(root):
        for f in sorted(files):
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(dirpath, f), REPO)
                yield rel, rel[:-3].replace(os.sep, ".").removesuffix(
                    ".__init__")


def test_port_imports_neither_jax_nor_plnerf():
    """Nor ``tools``, ``cv2``, ``imageio``, ``PIL``, ``flax`` or
    ``msgpack``."""
    mods = [m for _, m in _port_modules()]
    assert {"plnerf_torch.kernels.fused_mlp", "plnerf_torch.kernels.dot_probe",
            "plnerf_torch.tools.dot_decompose",
            "plnerf_torch.utils.profile", "plnerf_torch.cli.run_plnerf",
            "plnerf_torch.cli.run_depth", "plnerf_torch.train.camera_opt",
            "plnerf_torch.train.losses",
            "plnerf_torch.cli.run_vanilla", "plnerf_torch.cli.config",
            "plnerf_torch.cli.datasets", "plnerf_torch.data.blender",
            "plnerf_torch.data.llff", "plnerf_torch.data.dtu",
            "plnerf_torch.data.common", "plnerf_torch.data.png",
            "plnerf_torch.checkpoint.io", "plnerf_torch.eval.metrics",
            "plnerf_torch.utils.logging", "plnerf_torch.mesh.extract",
            "plnerf_torch.mesh.marching_cubes",
            "plnerf_torch.cli.extract_mesh",
            "plnerf_torch.eval.turbo", "plnerf_torch.serving.export",
            "plnerf_torch.serving.runtime",
            "plnerf_torch.checkpoint.flax_msgpack",
            "plnerf_torch.checkpoint.convert_torch",
            "plnerf_torch.tools.export_reference_ckpt",
            "plnerf_torch.tools.serving_bench",
            "plnerf_torch.data.fault_injection"} <= set(mods)
    # JAX, the JAX package and its tools, the image libraries the JAX
    # package reads and writes with, and the checkpoint format's libraries
    # (none is on the card's machine)
    banned = ("jax", "plnerf", "tools", "cv2", "imageio", "PIL", "flax",
              "msgpack")
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            f"bad = sorted(k for k in sys.modules if k.split('.')[0] in "
            f"{banned!r})\n"
            "print(bad)\nsys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr

    pat = re.compile(r"^\s*(import|from)\s+(%s)(\.|\s|$)"
                     % "|".join(banned), re.M)
    for rel, _ in _port_modules():
        with open(os.path.join(REPO, rel)) as f:
            assert not pat.search(f.read()), rel
    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        assert not pat.search(f.read())


def test_loaders_run_without_image_libraries(tmp_path):
    """The LLFF and DTU loaders read, minify and resize with the port's own
    code: a run that writes the forward-facing fixture, loads it with a
    minify, resizes and decomposes as the DTU loaders do, and ends with
    cv2, PIL and imageio never imported (the check above sees only what
    importing the modules pulls in)."""
    code = (
        "import sys, numpy as np\n"
        "from plnerf_torch.data import dtu, llff, synthetic\n"
        f"d = synthetic.make_llff_fixture({str(tmp_path)!r}, n=3, H=8, "
        "W=12)\n"
        "assert llff.load_llff_data(d, factor=2)[0].shape == (3, 4, 6, 3)\n"
        "img = np.zeros((8, 12, 3), np.uint8)\n"
        "assert dtu.bilinear_resize(img, (6, 4)).shape == (4, 6, 3)\n"
        "dtu.decompose_projection(np.eye(3, 4))\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        "('cv2', 'PIL', 'imageio'))\n"
        "print(bad)\nsys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert os.path.isdir(tmp_path / "images_2")
