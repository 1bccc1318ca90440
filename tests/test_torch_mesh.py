"""The port's mesh extraction (``plnerf_torch.mesh``,
``plnerf_torch.cli.extract_mesh``) against the JAX package's on the CPU:
native marching cubes against the port's numpy version and the JAX
package's native one on the sphere grids of ``tests/test_mesh.py`` (faces
equal, verts within 1e-6), the sphere's watertightness, floater removal,
PLY bytes and reads, the density grid (1e-5 x max(1, max sigma)) with and
without the fused forward's plain version, a query chunk above the fused
forward's ``FWD_CHUNK``, ``extract_geometry`` on the JAX grid, the CLI
end to end on weights the JAX driver trained, and a failed build."""
import os

import numpy as np
import pytest
import torch

import jax

from plnerf.checkpoint import io as jckio
from plnerf.cli import extract_mesh as jcli
from plnerf.cli import run_plnerf as jrun
from plnerf.core.config import ModelConfig as JModelConfig
from plnerf.core.config import RenderConfig as JRenderConfig
from plnerf.mesh import extract as JMX
from plnerf.mesh import marching_cubes as JMC
from plnerf.train import step as jstep
from plnerf_torch.checkpoint import convert_jax
from plnerf_torch.checkpoint import io as ckio
from plnerf_torch.cli import extract_mesh, run_plnerf
from plnerf_torch.core.config import ModelConfig
from plnerf_torch.core.mlp import NeRF
from plnerf_torch.kernels import fused_mlp
from plnerf_torch.mesh import extract as MX
from plnerf_torch.mesh import marching_cubes as MC

from fixtures import make_blender_scene
from test_mesh import sphere_grid

torch.set_num_threads(1)

KW = dict(netdepth=2, netwidth=16, multires=4, multires_views=2)
BOX = (np.full(3, -1.0, np.float32), np.full(3, 1.0, np.float32))
GRIDS = {
    "sphere24": lambda: sphere_grid(24),
    "sphere_offset": lambda: sphere_grid(20, r=0.7, center=(0.2, -0.1, 0.3)),
    "sphere_floater": lambda: np.maximum(
        sphere_grid(32, r=0.8), sphere_grid(32, r=0.15,
                                            center=(0.9, 0.9, 0.9))),
}


@pytest.mark.parametrize("name", sorted(GRIDS))
def test_native_matches_numpy_and_jax(name):
    grid = GRIDS[name]()
    v, f = MC.marching_cubes_native(grid, 0.0)
    vn, fn = MC.marching_cubes_numpy(grid, 0.0)
    vj, fj = JMC.marching_cubes_native(grid, 0.0)
    assert f.shape[0] > 0
    np.testing.assert_array_equal(f, fn)
    np.testing.assert_allclose(v, vn, atol=1e-6)
    np.testing.assert_array_equal(f, fj)
    np.testing.assert_allclose(v, vj, atol=1e-6)
    assert MC.marching_cubes is MC.marching_cubes_native


def test_sphere_is_watertight():
    n, r, extent = 48, 1.0, 1.2
    v, f = MC.marching_cubes(sphere_grid(n, r, extent), 0.0)
    vw = v * (2 * extent / (n - 1)) - extent
    assert np.abs(np.linalg.norm(vw, axis=1) - r).max() < 0.01
    e = np.sort(np.concatenate([f[:, [0, 1]], f[:, [1, 2]], f[:, [2, 0]]]),
                axis=1)
    edges, counts = np.unique(e, axis=0, return_counts=True)
    assert (counts == 2).all()                  # every edge on two faces
    assert v.shape[0] - edges.shape[0] + f.shape[0] == 2   # Euler


@pytest.mark.parametrize("min_len", [0, 200, 10 ** 7])
def test_filter_connected_components_matches_jax(min_len):
    g = np.maximum(sphere_grid(48, r=0.8),
                   sphere_grid(48, r=0.08, center=(1.0, 1.0, 1.0)))
    v, f = MC.marching_cubes(g, 0.0)
    got = MX.filter_connected_components(v, f, min_len=min_len)
    ref = JMX.filter_connected_components(v, f, min_len=min_len)
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    if min_len == 200:
        assert 0 < got[1].shape[0] < f.shape[0]


def test_export_ply_writes_the_jax_bytes(tmp_path):
    v, f = MC.marching_cubes(sphere_grid(16), 0.0)
    MX.export_ply(str(tmp_path / "port.ply"), v, f)
    JMX.export_ply(str(tmp_path / "jax.ply"), v, f)
    assert (tmp_path / "port.ply").read_bytes() == \
        (tmp_path / "jax.ply").read_bytes()


def test_load_ply_reads_binary_and_ascii(tmp_path):
    v, f = MC.marching_cubes(sphere_grid(16), 0.0)
    MX.export_ply(str(tmp_path / "b.ply"), v, f)
    vb, fb = MX.load_ply(str(tmp_path / "b.ply"))
    np.testing.assert_array_equal(vb, v)
    np.testing.assert_array_equal(fb, f)
    # ASCII, with a vertex normal and a quad (its first three indices kept)
    quad = [[0, 1, 2, 3]]
    lines = ["ply", "format ascii 1.0", f"element vertex {v.shape[0]}",
             "property float x", "property float y", "property float z",
             "property float nx", f"element face {f.shape[0] + 1}",
             "property list uchar int vertex_indices", "end_header"]
    lines += [f"{x!r} {y!r} {z!r} 0.5" for x, y, z in v.tolist()]
    lines += [f"{len(r)} " + " ".join(map(str, r))
              for r in f.tolist() + quad]
    (tmp_path / "a.ply").write_text("\n".join(lines) + "\n")
    va, fa = MX.load_ply(str(tmp_path / "a.ply"))
    np.testing.assert_array_equal(va, v)
    np.testing.assert_array_equal(fa[:-1], f)
    np.testing.assert_array_equal(fa[-1], [0, 1, 2])
    jv, jf = JMX.load_ply(str(tmp_path / "a.ply"))
    np.testing.assert_array_equal(va, jv)
    np.testing.assert_array_equal(fa, jf)


@pytest.fixture(scope="module")
def nets():
    """(JAX params, port NeRF) of one seeded 2x16 network."""
    setup = jstep.TrainSetup(mcfg=JModelConfig(**KW), rcfg=JRenderConfig(
        n_samples=4, n_importance=4))
    params = jax.tree.map(np.array, jstep.init_state(
        jax.random.PRNGKey(0), setup).params_fine)
    net = convert_jax.load_jax_params(NeRF(ModelConfig(**KW), device="cpu"),
                                      params)
    return params, net


@pytest.mark.parametrize("use_kernel", [False, True])
def test_density_grid_matches_jax(nets, use_kernel):
    params, net = nets
    ref = JMX.extract_density_grid(params, JModelConfig(**KW), *BOX,
                                   resolution=16, chunk=1000)
    got = MX.extract_density_grid(net, net.cfg, *BOX, resolution=16,
                                  chunk=1000, use_kernel=use_kernel)
    assert got.shape == (16, 16, 16) and got.dtype == np.float32
    assert (got >= 0).all() and ref.max() > 0
    tol = 1e-5 * max(1.0, float(ref.max()))
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol)


def test_density_chunk_above_fwd_chunk(nets, monkeypatch):
    """A query chunk above ``FWD_CHUNK`` points (the fp32 kernel's
    multi-chunk, ragged schedule on the card): the grid equals the one
    queried 1000 points at a time, and the kernel schedule's plain version
    (``forward_chunked``) gives the plain forward's raw on the chunk."""
    _, net = nets
    calls = []
    forward = fused_mlp.forward

    def record(p, x, v, v_div=1):
        calls.append(x.shape[0])
        ref = forward(p, x, v, v_div)
        torch.testing.assert_close(fused_mlp.forward_chunked(p, x, v, v_div),
                                   ref, rtol=0, atol=0)
        return ref

    monkeypatch.setattr(fused_mlp, "FWD_CHUNK", 1500)
    monkeypatch.setattr(fused_mlp, "forward", record)
    big = MX.extract_density_grid(net, net.cfg, *BOX, resolution=16,
                                  chunk=3000, use_kernel=True)
    assert calls == [3000, 1096] and len(fused_mlp.fwd_chunks(3000, 1)) == 2
    small = MX.extract_density_grid(net, net.cfg, *BOX, resolution=16,
                                    chunk=1000, use_kernel=True)
    np.testing.assert_array_equal(big, small)


def test_extract_geometry_on_the_jax_grid(nets, monkeypatch):
    params, net = nets
    jcfg = JModelConfig(**KW)
    grid = JMX.extract_density_grid(params, jcfg, *BOX, resolution=16,
                                    chunk=1000)
    iso = float(np.quantile(grid, 0.6))
    ref = JMX.extract_geometry(params, jcfg, *BOX, resolution=16,
                               threshold=iso, chunk=1000)
    monkeypatch.setattr(MX, "extract_density_grid", lambda *a, **k: grid)
    got = MX.extract_geometry(net, net.cfg, *BOX, resolution=16,
                              threshold=iso)
    assert ref[1].shape[0] > 0
    np.testing.assert_array_equal(got[1], ref[1])
    np.testing.assert_allclose(got[0], ref[0], rtol=0, atol=1e-6)
    assert MX.extract_iso_level(grid, 0.05) == JMX.extract_iso_level(grid,
                                                                     0.05)


TINY = ["--dataset", "blender", "--no_batching", "--use_viewdirs",
        "--white_bkgd", "--N_rand", "32", "--N_samples", "4",
        "--N_importance", "4", "--netdepth", "2", "--netwidth", "16",
        "--multires", "4", "--multires_views", "2", "--chunk", "128",
        "--i_print", "4", "--i_img", "9999", "--i_testset", "9999",
        "--i_video", "9999"]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """The JAX driver's 4-step checkpoint and the same weights in a port
    checkpoint: (data_dir, ckpt_dir) with experiments ``jax`` and
    ``port`` of scene ``ms``, and a GT .obj at the default path."""
    root = tmp_path_factory.mktemp("mesh_cli")
    data_dir, ckpt_dir = str(root / "data"), str(root / "ck")
    make_blender_scene(os.path.join(data_dir, "ms"), 2, 1, 1)
    common = TINY + ["--data_dir", data_dir, "--scene_id", "ms",
                     "--ckpt_dir", ckpt_dir, "--task", "train",
                     "--constant_init", "0"]
    jrun.main(common + ["--expname", "jax", "--num_iterations", "4",
                        "--i_weights", "4"])
    _, _, jsetup = jrun.build_configs(jrun.config_parser().parse_args(
        common + ["--expname", "jax"]))
    jstate = jckio.restore_checkpoint(
        os.path.join(ckpt_dir, "jax", "000004.ckpt"),
        jstep.init_state(jax.random.PRNGKey(0), jsetup))
    state = run_plnerf.main(common + ["--device", "cpu", "--expname",
                                      "port", "--num_iterations", "0"])
    for module, p in ((state.params_coarse, jstate.params_coarse),
                      (state.params_fine, jstate.params_fine)):
        convert_jax.load_jax_params(module, jax.tree.map(np.array, p))
    state.step = 4
    ckio.save_checkpoint(os.path.join(ckpt_dir, "port"), 4,
                         state.state_dict())
    obj = os.path.join(data_dir, "nerf_meshes_reoriented", "ms.obj")
    os.makedirs(os.path.dirname(obj))
    with open(obj, "w") as f:
        f.write("# a box\nv -0.75 -0.5 -0.6\nv 0.7 0.75 0.65\n"
                "v 0 0 0\nf 1 2 3\n")
    return data_dir, ckpt_dir


@pytest.mark.parametrize("bbox", [
    [], ["--bbox_min", "-1", "-1", "-1", "--bbox_max", "1", "1", "1"]])
@pytest.mark.parametrize("use_kernel", [False, True])
def test_cli_writes_the_jax_mesh(trained, tmp_path, bbox, use_kernel):
    """Both CLIs on the same weights, the GT .obj's bbox (+-0.25) or
    --bbox_min/max, the threshold of tests/test_mesh.py with
    --adaptive_iso (the 4-step field's density stays below 0.05; the
    adaptive level lies inside its range): the same file name, the same
    faces, verts within 1e-5."""
    data_dir, ckpt_dir = trained
    argv = ["--ckpt_dir", ckpt_dir, "--data_dir", data_dir, "--scene_id",
            "ms", "--mesh_res", "16", "--mesh_threshold", "0.05",
            "--min_component_faces", "0", "--mesh_chunk", "1000",
            "--adaptive_iso"] + bbox
    out_j, out_p = str(tmp_path / "jax"), str(tmp_path / "port")
    jcli.main(argv + ["--expname", "jax", "--mesh_outdir", out_j])
    got = extract_mesh.main(argv + [
        "--expname", "port", "--mesh_outdir", out_p, "--device", "cpu",
        "--use_kernel" if use_kernel else "--no-use_kernel"])
    assert os.listdir(out_p) == os.listdir(out_j) == [
        "ms_constant_res16_thresh0.05_cleaned.ply"]
    assert got == os.path.join(out_p, os.listdir(out_p)[0])
    v, f = MX.load_ply(got)
    vj, fj = MX.load_ply(os.path.join(out_j, os.listdir(out_j)[0]))
    assert f.shape[0] > 0
    np.testing.assert_array_equal(f, fj)
    np.testing.assert_allclose(v, vj, rtol=0, atol=1e-5)
    lo, hi = (BOX if bbox else (np.array([-1.0, -0.75, -0.85]),
                                np.array([0.95, 1.0, 0.9])))
    assert (v >= lo - 1e-6).all() and (v <= hi + 1e-6).all()


def test_entry_point_needs_cuda_unless_cpu_is_asked(trained, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    data_dir, ckpt_dir = trained
    with pytest.raises(RuntimeError, match="device='cpu'"):
        extract_mesh.main(["--ckpt_dir", ckpt_dir, "--expname", "port",
                           "--data_dir", data_dir, "--scene_id", "ms",
                           "--mesh_outdir", str(tmp_path / "m")])
    assert not os.path.exists(tmp_path / "m")


def test_a_failed_build_raises(monkeypatch, tmp_path):
    """A compiler that cannot run: ``marching_cubes`` raises naming it,
    and falls back to nothing."""
    monkeypatch.setattr(MC, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(MC, "_lib", None)
    monkeypatch.setattr(MC, "CXX", str(tmp_path / "no-such-g++"))
    with pytest.raises(RuntimeError, match="no-such-g\\+\\+"):
        MC.marching_cubes(sphere_grid(8), 0.0)
    # a compiler that runs and fails: its output is in the error
    monkeypatch.setattr(MC, "CXX", "g++")
    monkeypatch.setattr(MC, "CXX_FLAGS", MC.CXX_FLAGS + ["-fno-such-option"])
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        MC.marching_cubes(sphere_grid(8), 0.0)
    assert os.listdir(tmp_path) == []
