"""PyTorch port vs the JAX package: positional encoding, the NeRF MLP
(``apply_mlp`` / ``query_network``, fp32 and bf16) and the weight
conversion.  Inputs and weights are made with numpy from a seed; JAX
params reach the port through ``plnerf_torch.checkpoint.convert_jax``.
The JAX side runs under ``jax.jit``, which at these shapes costs less
than eager op-by-op dispatch."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from plnerf.core import encoding as jenc
from plnerf.core import mlp as jmlp
from plnerf.core.config import ModelConfig as JModelConfig
from plnerf_torch.checkpoint import convert_jax
from plnerf_torch.core import encoding, mlp
from plnerf_torch.core.config import ModelConfig

torch.set_num_threads(1)

j_embed = jax.jit(jenc.embed, static_argnums=(1, 2))
j_apply_mlp = jax.jit(jmlp.apply_mlp, static_argnames=("cfg", "dtype"))
j_query = jax.jit(jmlp.query_network, static_argnames=(
    "cfg", "dtype", "use_pallas", "pallas_fold_heads"))

# (kwargs shared by both packages' ModelConfig)
MODEL_CASES = {
    "full_8x256": dict(),
    "small_2x16": dict(netdepth=2, netwidth=16, multires=4, multires_views=2),
    "plain_head": dict(use_viewdirs=False, output_ch=4, netdepth=3,
                       netwidth=32, multires=4),
    "skips_2_4": dict(netdepth=6, netwidth=64, skips=(2, 4), multires=6),
    "softplus_pi": dict(density_activation="softplus10", pi_bands=True,
                        multires=9, multires_views=0, netwidth=64,
                        netdepth=4),
}


def np_params(kw, seed=0):
    """JAX-layout params ([fan_in, fan_out] weights) drawn with numpy."""
    cfg = JModelConfig(**kw)
    rng = np.random.default_rng(seed)

    def lin(fan_in, fan_out):
        b = 1.0 / np.sqrt(fan_in)
        return {"w": rng.uniform(-b, b, (fan_in, fan_out)).astype(np.float32),
                "b": rng.uniform(-b, b, (fan_out,)).astype(np.float32)}

    D, W, in_ch = cfg.netdepth, cfg.netwidth, cfg.input_ch
    pts, fan_in = [], in_ch
    for i in range(D):
        pts.append(lin(fan_in, W))
        fan_in = W + in_ch if i in cfg.skips else W
    p = {"pts_linears": pts}
    if cfg.use_viewdirs:
        p["feature_linear"] = lin(W, W)
        p["alpha_linear"] = lin(W, 1)
        p["views_linears"] = [lin(cfg.input_ch_views + cfg.input_ch_cam + W,
                                  W // 2)]
        p["rgb_linear"] = lin(W // 2, 3)
    else:
        p["output_linear"] = lin(W, cfg.output_ch)
    return p


def torch_model(kw, params):
    m = mlp.NeRF(ModelConfig(**kw), device="cpu")
    return convert_jax.load_jax_params(m, params)


def np_inputs(kw, n, seed=1, lead=None):
    """Embedded points [n, in_ch] and views [n, vch] (numpy, via JAX's
    encoding so both sides see identical inputs)."""
    cfg = JModelConfig(**kw)
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(n, 3)).astype(np.float32)
    pe = np.asarray(j_embed(jnp.asarray(pts), cfg.multires, cfg.pi_bands))
    ve = None
    if cfg.use_viewdirs:
        vd = rng.normal(size=(n, 3)).astype(np.float32)
        vd /= np.linalg.norm(vd, axis=-1, keepdims=True)
        ve = np.asarray(j_embed(jnp.asarray(vd), cfg.multires_views,
                                cfg.pi_bands))
    return pe, ve


def t(x):
    return None if x is None else torch.from_numpy(np.array(x))


@pytest.mark.parametrize("multires,pi_bands", [(10, False), (4, False),
                                               (9, True), (0, False)])
def test_encoding_matches_jax(multires, pi_bands):
    x = np.random.default_rng(0).normal(size=(5, 7, 3)).astype(np.float32) * 3
    ref = np.asarray(jenc.embed(jnp.asarray(x), multires, pi_bands))
    got = encoding.embed(t(x), multires, pi_bands).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)


def test_convert_jax_roundtrip_and_names():
    kw = MODEL_CASES["skips_2_4"]
    params = np_params(kw)
    m = torch_model(kw, params)
    names = set(m.state_dict())
    assert {"pts_linears.0.weight", "pts_linears.3.weight",
            "feature_linear.bias", "alpha_linear.weight",
            "views_linears.0.weight", "rgb_linear.weight"} <= names
    back = convert_jax.state_dict_to_params(m.state_dict())
    for a, b in zip(params["pts_linears"], back["pts_linears"]):
        np.testing.assert_array_equal(a["w"], b["w"])
        np.testing.assert_array_equal(a["b"], b["b"])
    np.testing.assert_array_equal(params["views_linears"][0]["w"],
                                  back["views_linears"][0]["w"])


@pytest.mark.parametrize("name", list(MODEL_CASES))
def test_apply_mlp_fp32_matches_jax(name):
    kw = MODEL_CASES[name]
    params = np_params(kw)
    pe, ve = np_inputs(kw, 64 if name == "full_8x256" else 37)
    ref = np.asarray(j_apply_mlp(params, jnp.asarray(pe),
                                 None if ve is None else jnp.asarray(ve),
                                 cfg=JModelConfig(**kw)))
    with torch.no_grad():
        got = mlp.apply_mlp(torch_model(kw, params), t(pe), t(ve),
                            ModelConfig(**kw)).numpy()
    np.testing.assert_allclose(got, ref, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("name", list(MODEL_CASES))
def test_apply_mlp_bf16_matches_jax(name):
    kw = MODEL_CASES[name]
    params = np_params(kw)
    pe, ve = np_inputs(kw, 64 if name == "full_8x256" else 37)
    ref = np.asarray(j_apply_mlp(params, jnp.asarray(pe),
                                 None if ve is None else jnp.asarray(ve),
                                 cfg=JModelConfig(**kw), dtype=jnp.bfloat16),
                     np.float32)
    with torch.no_grad():
        got = mlp.apply_mlp(torch_model(kw, params), t(pe), t(ve),
                            ModelConfig(**kw), torch.bfloat16).float().numpy()
    np.testing.assert_allclose(got, ref, atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("name", ["full_8x256", "small_2x16", "plain_head",
                                  "softplus_pi"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_query_network_matches_jax(name, dtype):
    """[R, S, 3] points with per-ray view directions broadcast over
    samples; camera-embedding channels on the softplus case."""
    kw = dict(MODEL_CASES[name])
    if name == "softplus_pi":
        kw["input_ch_cam"] = 4
    params = np_params(kw)
    rng = np.random.default_rng(3)
    R, S = (4, 16) if name == "full_8x256" else (5, 7)
    pts = rng.normal(size=(R, S, 3)).astype(np.float32)
    vd = rng.normal(size=(R, 3)).astype(np.float32)
    vd /= np.linalg.norm(vd, axis=-1, keepdims=True)
    cam = rng.normal(size=(4,)).astype(np.float32)
    cam_arg = cam if name == "softplus_pi" else None
    jd, td, tol = ((jnp.float32, torch.float32, 2e-5) if dtype == "float32"
                   else (jnp.bfloat16, torch.bfloat16, 2e-2))
    ref = np.asarray(j_query(
        params, jnp.asarray(pts), jnp.asarray(vd), cfg=JModelConfig(**kw),
        cam_embedding=None if cam_arg is None else jnp.asarray(cam_arg),
        dtype=jd), np.float32)
    with torch.no_grad():
        got = mlp.query_network(torch_model(kw, params), t(pts), t(vd),
                                ModelConfig(**kw), t(cam_arg),
                                dtype=td).float().numpy()
    assert got.shape == (R, S, 4)
    np.testing.assert_allclose(got, ref, atol=tol, rtol=tol)


@pytest.mark.parametrize("init", ["torch_linear", "xavier"])
def test_init_modes_and_sigma_bias(init):
    """Seeded init: bounds per mode, zero xavier biases, the density
    bias lift, and reproducibility from the generator."""
    cfg = ModelConfig(netdepth=3, netwidth=32, multires=4, multires_views=2,
                      init=init, sigma_bias_init=0.1)
    a = mlp.NeRF(cfg, torch.Generator().manual_seed(7), device="cpu")
    b = mlp.NeRF(cfg, torch.Generator().manual_seed(7), device="cpu")
    for (k, va), vb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(va, vb), k
    w0 = a.pts_linears[0].weight.detach()
    fan_out, fan_in = w0.shape
    if init == "xavier":
        bound = np.sqrt(2.0) * np.sqrt(6.0 / (fan_in + fan_out))
        assert torch.count_nonzero(a.pts_linears[0].bias) == 0
        assert torch.allclose(a.alpha_linear.bias, torch.tensor([0.1]))
    else:
        bound = 1.0 / np.sqrt(fan_in)
    assert float(w0.abs().max()) <= bound
    assert float(w0.abs().max()) > 0.5 * bound
