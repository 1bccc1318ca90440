"""The port's LPIPS (``plnerf_torch/eval/lpips.py``) against the JAX
package's on the CPU: one seeded random ``.npz`` through both
``from_npz``, and the same weights as a torch state dict in each of the
three key layouts through both ``from_torch_state_dict``, on 64x64 and
96x128 image pairs, to 1e-5 relative.  Then its properties (identity,
symmetry), the loaders' refusals and ``load_lpips``'s lookup."""
import os

import numpy as np
import pytest
import torch

from plnerf.eval import lpips as jlpips
from plnerf_torch.eval import lpips

torch.set_num_threads(1)

CONV_IDX = [0, 3, 6, 8, 10]   # torchvision AlexNet feature positions


def write_npz(path, seed=0):
    """Seeded random LPIPS weights in the exported layout (HWIO convs,
    [C, 1] heads), non-zero biases; returns the dict."""
    rng = np.random.default_rng(seed)
    w, in_ch = {}, 3
    for i, (out_ch, k, _, _) in enumerate(lpips._ALEX):
        w[f"conv{i}_w"] = (rng.normal(size=(k, k, in_ch, out_ch))
                           / np.sqrt(k * k * in_ch)).astype(np.float32)
        w[f"conv{i}_b"] = (0.05 * rng.normal(size=out_ch)).astype(np.float32)
        in_ch = out_ch
    for i, c in enumerate(lpips._CHANNELS):
        w[f"lin{i}_w"] = (np.abs(rng.normal(size=(c, 1))) / c).astype(
            np.float32)
    np.savez(path, **w)
    return w


def state_dict(w, layout):
    """The ``.npz`` weights as a torch state dict in one of the layouts
    ``from_torch_state_dict`` reads."""
    sd = {}
    for i, ci in enumerate(CONV_IDX):
        conv = {"torchvision": f"features.{ci}",
                "lpips": f"net.slice{i + 1}.{ci}",
                "merged": f"net.features.{ci}"}[layout]
        sd[conv + ".weight"] = torch.from_numpy(
            w[f"conv{i}_w"].transpose(3, 2, 0, 1).copy())
        sd[conv + ".bias"] = torch.from_numpy(w[f"conv{i}_b"])
        head = {"torchvision": f"lin{i}.model.1.weight",
                "lpips": f"lins.{i}.model.1.weight",
                "merged": f"lin{i}.weight"}[layout]
        sd[head] = torch.from_numpy(w[f"lin{i}_w"].T.copy()).reshape(
            1, -1, 1, 1)
    return sd


def pair(shape, seed):
    rng = np.random.default_rng(seed)
    ref = rng.random(shape + (3,)).astype(np.float32)
    img = np.clip(ref + 0.2 * rng.normal(size=ref.shape), 0, 1).astype(
        np.float32)
    return img, ref


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("lpips") / "alex.npz")
    return path, write_npz(path)


@pytest.mark.parametrize("shape", [(64, 64), (96, 128)])
def test_matches_jax(weights, shape):
    path, _ = weights
    img, ref = pair(shape, seed=shape[1])
    got = lpips.LPIPS.from_npz(path)(img, ref)
    want = jlpips.LPIPS.from_npz(path)(img, ref)
    assert got > 0
    assert got == pytest.approx(want, rel=1e-5)


@pytest.mark.parametrize("layout", ["torchvision", "lpips", "merged"])
def test_state_dict_layouts(weights, layout, tmp_path):
    """Each layout loads the ``.npz``'s tensors exactly (by value and
    through ``from_file``'s ``torch.load``, nested under ``state_dict``),
    and scores as the JAX package does from the same state dict."""
    path, w = weights
    sd = state_dict(w, layout)
    want = lpips.LPIPS.from_npz(path)
    got = lpips.LPIPS.from_torch_state_dict(sd)
    for k, v in want.state_dict().items():
        assert torch.equal(got.state_dict()[k], v), k
    pt = str(tmp_path / "w.pt")
    torch.save({"state_dict": sd}, pt)
    loaded = lpips.LPIPS.from_file(pt)
    img, ref = pair((64, 64), seed=7)
    assert loaded(img, ref) == want(img, ref)
    jgot = jlpips.LPIPS.from_torch_state_dict(
        {k: v.numpy() for k, v in sd.items()})(img, ref)
    assert got(img, ref) == pytest.approx(jgot, rel=1e-5)


def test_identity_and_symmetry(weights):
    lp = lpips.LPIPS.from_npz(weights[0])
    img, ref = pair((64, 64), seed=3)
    assert lp(img, img) < 1e-6
    assert lp(img, ref) == pytest.approx(lp(ref, img), rel=1e-6)
    # the module takes tensors as well as arrays
    assert lp(torch.from_numpy(img), torch.from_numpy(ref)) == lp(img, ref)


def test_init_random_is_seeded():
    a = lpips.LPIPS.init_random(torch.Generator().manual_seed(0))
    b = lpips.LPIPS.init_random(torch.Generator().manual_seed(0))
    img, ref = pair((64, 64), seed=1)
    assert a(img, ref) == b(img, ref) > 0


def test_missing_keys_raise(weights, tmp_path):
    path, w = weights
    short = str(tmp_path / "short.npz")
    np.savez(short, **{k: v for k, v in w.items() if k != "lin3_w"})
    with pytest.raises(KeyError, match="missing LPIPS tensor lin3_w"):
        lpips.LPIPS.from_npz(short)
    sd = state_dict(w, "torchvision")
    del sd["features.6.weight"]
    with pytest.raises(KeyError, match="AlexNet conv 2 weights not found"):
        lpips.LPIPS.from_torch_state_dict(sd)
    sd = state_dict(w, "lpips")
    del sd["lins.4.model.1.weight"]
    with pytest.raises(KeyError, match="LPIPS lin head 4 not found"):
        lpips.LPIPS.from_torch_state_dict(sd)


def test_load_lpips_lookup(weights, monkeypatch):
    """``--lpips_weights`` first, then ``$PLNERF_LPIPS_WEIGHTS``, then the
    repository's ``weights/lpips_alex.npz``; None where there is none."""
    path, _ = weights
    repo_file = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "weights", "lpips_alex.npz")
    assert not os.path.exists(repo_file)
    monkeypatch.delenv("PLNERF_LPIPS_WEIGHTS", raising=False)
    assert lpips.default_weights_path() is None
    assert lpips.load_lpips(None, "cpu") is None
    monkeypatch.setenv("PLNERF_LPIPS_WEIGHTS", path + ".missing")
    assert lpips.load_lpips(None, "cpu") is None
    monkeypatch.setenv("PLNERF_LPIPS_WEIGHTS", path)
    lp = lpips.load_lpips(None, "cpu")
    assert isinstance(lp, lpips.LPIPS) and lp.device.type == "cpu"
    img, ref = pair((64, 64), seed=2)
    assert lp(img, ref) == lpips.LPIPS.from_npz(path)(img, ref)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            lpips.load_lpips(path)
