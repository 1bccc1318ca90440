"""The port's serving artifact (``plnerf_torch/serving/export.py`` and
``ServingRenderer.load``) against the JAX package's ``export_renderer`` +
``ServingRenderer.load`` and against the port's own ``from_params``: the
same weights, eval_det maps at the serving tests' tolerances, baked and
args weights, a baked occupancy grid, the whole-batch module, a request
that is not a chunk multiple; bit-equality with ``from_params`` at equal
seeds with perturb on; the fused forward op inside the exported graph;
the manifest; ``run_plnerf --task export_serving`` against the JAX
driver's export of one JAX checkpoint; and the refusals."""
import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from plnerf.cli import run_plnerf as jrun
from plnerf.core import occgrid as jog
from plnerf.core.config import ModelConfig as JModelConfig
from plnerf.core.config import RenderConfig as JRenderConfig
from plnerf.eval import images as jimages
from plnerf.serving import export as jexport
from plnerf.serving.runtime import ServingRenderer as JServingRenderer
from plnerf_torch.cli import run_plnerf
from plnerf_torch.core import occgrid as og
from plnerf_torch.core.config import ModelConfig, RenderConfig
from plnerf_torch.eval import images
from plnerf_torch.serving import export
from plnerf_torch.serving.runtime import ServingRenderer

from fixtures import make_blender_scene
from test_torch_mlp import torch_model
from test_torch_serving import KW, RKW, _check, _params, _rays

torch.set_num_threads(1)

CHUNK = 64
OCC = dict(resolution=8, candidates=16)


def _grid_np():
    """A grid with an occupied ball, as numpy arrays."""
    g = OCC["resolution"]
    c = (np.arange(g) + 0.5) / g * 3.0 - 1.5
    r = np.sqrt(c[:, None, None] ** 2 + c[None, :, None] ** 2
                + c[None, None, :] ** 2)
    dens = np.where(r < 1.0, 5.0, 0.0).astype(np.float32)
    occ = (r < 1.2).astype(np.float32)
    return {"density": dens, "occ": occ,
            "aabb_min": np.full(3, -1.5, np.float32),
            "aabb_max": np.full(3, 1.5, np.float32)}


def _models(pc, pf):
    return torch_model(KW, pc), torch_model(KW, pf)


def _port_rcfg(perturb=False, fused=True, occ=False, **kw):
    occ_cfg = og.OccGridConfig(**OCC) if occ else None
    return images.test_render_config(
        RenderConfig(**RKW), perturb=perturb, use_fused_mlp=fused,
        fused_fold_heads=fused, occ=occ_cfg, **kw)


@pytest.mark.parametrize("occ", [False, True], ids=["uniform", "occ_grid"])
@pytest.mark.parametrize("mode", ["baked", "args"])
def test_artifact_matches_jax_artifact(tmp_path, mode, occ):
    """eval_det maps of both artifacts, same weights, at 1e-4: 150 rays
    through each whole-batch module (padded to 192, cut back) and 40
    through the chunk module."""
    pc, pf = _params()
    grid = _grid_np() if occ else None
    jr = jimages.test_render_config(
        JRenderConfig(**RKW), perturb=False,
        occ=jog.OccGridConfig(**OCC) if occ else None)
    jexport.export_renderer(
        pc, pf, JModelConfig(**KW), jr, str(tmp_path / "jax"), chunk=CHUNK,
        occ_grid=None if grid is None else {k: jnp.asarray(v)
                                            for k, v in grid.items()},
        fused_n_rays=150, weights_mode=mode)
    mc, mf = _models(pc, pf)
    man = export.export_renderer(
        mc, mf, ModelConfig(**KW), _port_rcfg(occ=occ),
        str(tmp_path / "port"), chunk=CHUNK,
        occ_grid=None if grid is None else {k: torch.from_numpy(v)
                                            for k, v in grid.items()},
        fused_n_rays=150, weights_mode=mode)
    assert man["occ_grid_embedded"] is occ and man["fused_n_rays"] == 192
    assert man["draw_inputs"] == []               # eval_det: no draws
    jsrv = JServingRenderer.load(str(tmp_path / "jax"))
    srv = ServingRenderer.load(str(tmp_path / "port"), device="cpu")
    rays = _rays(150)
    for n in (150, 40):
        ref = jsrv.render_rays(rays[:n], seed=3)
        got = srv.render_rays(rays[:n], seed=3)
        assert all(v.shape[0] == n for v in got.values())
        _check(got, ref, sorted(ref))
    assert float(got["acc_map"].min()) > 0.05
    sel = srv.render_rays(rays, seed=3, keys=["rgb_map"])
    assert set(sel) == {"rgb_map"}


@pytest.mark.parametrize("dtype,occ", [("float32", False),
                                       ("bfloat16", False), ("float32", True)],
                         ids=["f32", "bf16", "f32_occ_grid"])
@pytest.mark.parametrize("mode", ["baked", "args"])
def test_artifact_equals_from_params_with_perturb(tmp_path, mode, dtype, occ):
    """perturb on (the test task's default) and density noise: the
    artifact's chunk path and whole-batch module return ``from_params``'s
    maps bit for bit at seeds 3 and 7, with a grid guiding the coarse
    samples too."""
    pc, pf = _params()
    mc, mf = _models(pc, pf)
    rcfg = _port_rcfg(perturb=True, occ=occ, mlp_dtype=dtype,
                      raw_noise_std=0.5)
    grid = ({k: torch.from_numpy(v) for k, v in _grid_np().items()}
            if occ else None)
    man = export.export_renderer(mc, mf, ModelConfig(**KW), rcfg,
                                 str(tmp_path), chunk=CHUNK, fused_n_rays=130,
                                 weights_mode=mode, occ_grid=grid)
    assert [d["name"] for d in man["draw_inputs"]] == [
        "t_rand", "noise0", "u", "noise"]
    srv = ServingRenderer.load(str(tmp_path), device="cpu")
    ref_srv = ServingRenderer.from_params(mc, mf, ModelConfig(**KW), rcfg,
                                          chunk=CHUNK, device="cpu",
                                          occ_grid=grid)
    rays = _rays(192, seed=1)
    for seed in (3, 7):
        ref = ref_srv.render_rays(rays, seed=seed)
        for n in (192, 100):                  # whole batch, then chunks
            got = srv.render_rays(rays[:n], seed=seed)
            assert set(got) == set(ref)
            for k in ref:
                np.testing.assert_array_equal(got[k], ref[k][:n], err_msg=k)
    other = srv.render_rays(rays, seed=4)
    assert not np.array_equal(other["rgb_map"], ref["rgb_map"])


@pytest.mark.parametrize("fused", [True, False], ids=["kernel", "plain"])
def test_the_fused_op_is_in_the_graph(tmp_path, fused):
    """With ``use_fused_mlp`` the program calls the registered op once
    per pass (coarse, fine) and holds the packed weights, not the
    packing; without it, no op."""
    pc, pf = _params()
    mc, mf = _models(pc, pf)
    export.export_renderer(mc, mf, ModelConfig(**KW), _port_rcfg(fused=fused),
                           str(tmp_path), chunk=CHUNK)
    ep = torch.export.load(str(tmp_path / export.MODULE_FILE))
    calls = [n for n in ep.graph.nodes if n.op == "call_function"
             and str(n.target).startswith("plnerf_torch.fused_mlp_fwd")]
    assert len(calls) == (2 if fused else 0)
    if fused:
        assert {k.rsplit(".", 1)[-1] for k in ep.state_dict} == {"wbuf",
                                                                 "bbuf"}


def test_manifest_keys_follow_jax(tmp_path):
    pc, pf = _params()
    jr = jimages.test_render_config(JRenderConfig(**RKW))
    jm = jexport.export_renderer(pc, pf, JModelConfig(**KW), jr,
                                 str(tmp_path / "jax"), chunk=CHUNK)
    mc, mf = _models(pc, pf)
    pm = export.export_renderer(mc, mf, ModelConfig(**KW), _port_rcfg(True),
                                str(tmp_path / "port"), chunk=CHUNK)
    assert set(pm) == (set(jm) - {"jax_version"}) | {
        "torch_version", "device", "draw_inputs"}
    for k in set(jm) - {"jax_version", "platforms"}:
        assert pm[k] == jm[k], k
    assert pm["platforms"] == ["cpu"] and pm["device"] == "cpu"
    assert pm["torch_version"] == torch.__version__
    with open(tmp_path / "port" / export.MANIFEST_FILE) as f:
        assert json.load(f) == pm


def test_refusals(tmp_path):
    pc, pf = _params()
    mc, mf = _models(pc, pf)
    rcfg = _port_rcfg()
    with pytest.raises(ValueError, match="exported on"):
        export.export_renderer(mc, mf, ModelConfig(**KW), rcfg,
                               str(tmp_path), chunk=CHUNK, platforms=["tpu"])
    export.export_renderer(mc, mf, ModelConfig(**KW), rcfg, str(tmp_path),
                           chunk=CHUNK)
    # several devices, refused before data parallelism was ported, serve
    # (test_torch_parallel.py holds them against one device)
    rays = _rays(3 * CHUNK, seed=5)
    one = ServingRenderer.load(str(tmp_path), device="cpu")
    two = ServingRenderer.load(str(tmp_path), devices=["cpu", "cpu"])
    for k, v in one.render_rays(rays, seed=3).items():
        np.testing.assert_array_equal(two.render_rays(rays, seed=3)[k], v)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ServingRenderer.load(str(tmp_path))
    path = tmp_path / export.MANIFEST_FILE
    man = json.loads(path.read_text())
    path.write_text(json.dumps({**man, "device": "cuda"}))
    with pytest.raises(ValueError, match="exported for cuda"):
        ServingRenderer.load(str(tmp_path), device="cpu")


TINY = [
    "--dataset", "blender", "--no_batching", "--use_viewdirs",
    "--white_bkgd", "--N_rand", "64", "--N_samples", "8",
    "--N_importance", "8", "--netdepth", "2", "--netwidth", "16",
    "--multires", "4", "--multires_views", "2", "--chunk", "256",
    "--lrate", "5e-3", "--i_print", "5", "--i_img", "1000000",
    "--i_testset", "1000000", "--i_video", "1000000", "--testskip", "1",
]


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """A JAX driver run of 6 tiny steps on the fixture scene."""
    root = tmp_path_factory.mktemp("export_run")
    make_blender_scene(str(root / "tinyscene"), n_train=3, n_val=1, n_test=1)
    common = TINY + ["--data_dir", str(root), "--scene_id", "tinyscene",
                     "--ckpt_dir", str(root / "ck"), "--mode", "linear"]
    jrun.main(common + ["--task", "train", "--expname", "jax",
                        "--num_iterations", "6", "--i_weights", "6"])
    return root, common


def test_export_task_matches_jax_driver(jax_run):
    """``--task export_serving --eval_det`` of both drivers on one JAX
    checkpoint (the port reads it through ``--ft_path``, with no dataset):
    the same provenance and, served, the same maps at 1e-4."""
    root, common = jax_run
    ck = str(root / "ck" / "jax" / "000006.ckpt")
    flags = ["--task", "export_serving", "--eval_det", "--ckpt_dir",
             str(root / "ck"), "--expname", "jax", "--serve_image", "4x30"]
    jrun.main(flags + ["--serve_out", str(root / "jax_art")])
    with open(root / "jax_art" / jexport.MANIFEST_FILE) as f:
        jm = json.load(f)
    pm = run_plnerf.main(flags + ["--device", "cpu", "--ft_path", ck,
                                  "--data_dir", "missing", "--serve_out",
                                  str(root / "port_art")])
    assert pm["provenance"] == jm["provenance"]
    assert pm["provenance"]["step"] == 6 and pm["fused_n_rays"] == 256
    assert pm["draw_inputs"] == [] and not pm["perturb"]
    jsrv = JServingRenderer.load(str(root / "jax_art"))
    srv = ServingRenderer.load(str(root / "port_art"), device="cpu")
    rays = _rays(120, seed=2)
    ref, got = jsrv.render_rays(rays), srv.render_rays(rays)
    _check(got, ref, sorted(ref))
    with pytest.raises(SystemExit, match="serve_platforms tpu"):
        run_plnerf.main(flags + ["--device", "cpu", "--ft_path", ck,
                                 "--serve_platforms", "tpu"])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("fold", [False, True], ids=["split", "folded"])
def test_the_op_on_the_cpu_is_the_plain_version(dtype, fold):
    """``fused_mlp_fwd`` on CPU tensors: ``forward_plain`` bit for bit on
    the blocks it unflattens from ``PackedMLP.flat`` (bf16: out of the
    ``wgmma_stream`` order); a ``PackedNet`` applies the same op; on meta
    tensors the registered fake gives raw's shape and dtype."""
    from plnerf_torch.core.encoding import embed
    from plnerf_torch.kernels import fused_mlp

    cfg = ModelConfig(**KW)
    mc, _ = _models(*_params())
    g = torch.Generator().manual_seed(0)
    pe = embed(torch.randn(5, 7, 3, generator=g), cfg.multires, cfg.pi_bands)
    ve = embed(torch.nn.functional.normalize(torch.randn(5, 3, generator=g),
                                             dim=-1),
               cfg.multires_views, cfg.pi_bands)[:, None, :]
    with torch.no_grad():
        p, x, v, v_div = fused_mlp.prepare(mc, pe, ve, cfg, dtype, fold)
        wbuf, bbuf = p.flat()
        got = fused_mlp.forward_flat(p, wbuf, bbuf, x, v, v_div)
        assert torch.equal(got, fused_mlp.forward_plain(p, x, v, v_div))
        net = fused_mlp.PackedNet(mc, cfg, dtype, fold)
        assert torch.equal(fused_mlp.apply(net, pe, ve, cfg, dtype),
                           fused_mlp.apply(mc, pe, ve, cfg, dtype, fold))
        meta = fused_mlp.forward_flat(p, wbuf.to("meta"), bbuf.to("meta"),
                                      x.to("meta"), v.to("meta"), v_div)
    assert meta.shape == got.shape and meta.dtype == torch.float32


def test_serving_bench_on_the_cpu(tmp_path):
    """The bench tool at a tiny size: every path, one JSON line; a card's
    size on the CPU is refused."""
    from plnerf_torch.tools import serving_bench

    out = tmp_path / "bench.json"
    row = serving_bench.main(["--device", "cpu", "--size", "6", "--chunk",
                              "48", "--rounds", "1", "--out", str(out)])
    assert json.loads(out.read_text()) == json.loads(json.dumps(row))
    assert set(row["paths"]) == {"serving-fused", "serving-fused-args",
                                 "serving-fused-rgbonly", "serving-chunked",
                                 "inprocess"}
    assert set(row["export_s"]) == set(row["load_s"]) == {"baked", "args"}
    with pytest.raises(SystemExit, match="at most 64"):
        serving_bench.main(["--device", "cpu", "--out", str(out)])
