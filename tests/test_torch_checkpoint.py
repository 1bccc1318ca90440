"""The port's checkpoints (plnerf_torch/checkpoint/io.py and
``TrainState.state_dict``) on the CPU: a save / restore round trip is bit
for bit (weights, Adam moments and steps, the schedules' update count), a
restored state's next step equals the uninterrupted state's bit for bit,
files load with ``weights_only=True``, are found in numeric order and are
written atomically."""
import os

import pytest
import torch

from plnerf_torch.checkpoint import io as ckio
from plnerf_torch.core.config import ModelConfig, RenderConfig
from plnerf_torch.data import synthetic
from plnerf_torch.device import make_generator
from plnerf_torch.train import batching
from plnerf_torch.train.step import TrainSetup, init_state, make_train_step

torch.set_num_threads(1)

KW = dict(netdepth=2, netwidth=32, multires=4, multires_views=2)
SCENE = synthetic.make_sphere_dataset(4, 16, 16)


def _setup(joint=False):
    # lrate_decay 1: the rate moves every step, so a lost count shows
    return TrainSetup(mcfg=ModelConfig(**KW),
                      rcfg=RenderConfig(n_samples=8, n_importance=8,
                                        white_bkgd=True),
                      lrate=5e-3, coarse_lrate=5e-3, lrate_decay=1,
                      joint_optimizer=joint)


def _train(state, setup, g, n):
    images, poses, _, K = SCENE
    step = make_train_step(setup)
    for _ in range(n):
        rays, target, _ = batching.sample_one_image_batch(
            torch.as_tensor(images), torch.as_tensor(poses), K,
            torch.arange(4), g, 64, 2.0, 6.0, True)
        state, _ = step(state, {"rays": rays, "target": target}, g)
    return state


def _opts(state):
    return [(n, o) for n, o in (("fine", state.opt_fine),
                                ("coarse", state.opt_coarse))
            if o is not None]


def _assert_same(a, b):
    assert a.step == b.step
    for net in ("params_coarse", "params_fine"):
        for (k, p), (_, q) in zip(getattr(a, net).named_parameters(),
                                  getattr(b, net).named_parameters()):
            assert torch.equal(p, q), (net, k)
    assert [n for n, _ in _opts(a)] == [n for n, _ in _opts(b)]
    for (name, oa), (_, ob) in zip(_opts(a), _opts(b)):
        assert oa.count == ob.count, name
        pa = [p for g in oa.param_groups for p in g["params"]]
        pb = [p for g in ob.param_groups for p in g["params"]]
        for i, (p, q) in enumerate(zip(pa, pb)):
            sa, sb = oa.state[p], ob.state[q]
            assert sa["step"].device.type == "cpu"
            for k in ("step", "exp_avg", "exp_avg_sq"):
                assert torch.equal(sa[k], sb[k]), (name, i, k)


@pytest.mark.parametrize("joint", [False, True])
def test_round_trip_is_bit_for_bit(tmp_path, joint):
    setup = _setup(joint)
    a = _train(init_state(make_generator(0, "cpu"), setup, "cpu"), setup,
               make_generator(5, "cpu"), 3)
    path = ckio.save_checkpoint(str(tmp_path), a.step, a.state_dict())
    assert os.path.basename(path) == "000003.ckpt"
    assert os.listdir(tmp_path) == ["000003.ckpt"]       # no .tmp left
    b = init_state(make_generator(1, "cpu"), setup, "cpu")
    assert ckio.restore_checkpoint(path, b, "cpu") is b
    _assert_same(a, b)
    assert b.opt_fine.count == 3


def test_file_loads_with_weights_only(tmp_path):
    setup = _setup()
    a = _train(init_state(make_generator(0, "cpu"), setup, "cpu"), setup,
               make_generator(5, "cpu"), 1)
    path = ckio.save_checkpoint(str(tmp_path), a.step, a.state_dict())
    sd = torch.load(path, weights_only=True)

    def leaves(x):
        if isinstance(x, dict):
            for v in x.values():
                yield from leaves(v)
        else:
            yield x

    kinds = {type(v) for v in leaves(sd)}
    assert kinds <= {torch.Tensor, int, float, str}, kinds
    assert set(sd) == {"step", "params_coarse", "params_fine", "opt_coarse",
                       "opt_fine"}


def test_restored_state_steps_like_the_uninterrupted_one(tmp_path):
    setup = _setup()
    g = make_generator(5, "cpu")
    a = _train(init_state(make_generator(0, "cpu"), setup, "cpu"), setup, g,
               2)
    path = ckio.save_checkpoint(str(tmp_path), a.step, a.state_dict())
    rng = g.get_state()
    a = _train(a, setup, g, 1)

    b = ckio.restore_checkpoint(
        path, init_state(make_generator(1, "cpu"), setup, "cpu"), "cpu")
    g2 = make_generator(0, "cpu")
    g2.set_state(rng)
    b = _train(b, setup, g2, 1)
    _assert_same(a, b)
    # the rate continued from the restored count: update 3 ran at schedule(2)
    assert b.opt_fine.param_groups[0]["lr"] == setup.fine_schedule()(2)
    assert b.opt_coarse.param_groups[0]["lr"] == setup.coarse_schedule()(2)


def test_list_checkpoints_sorts_numerically(tmp_path):
    d = str(tmp_path)
    for step in (1000000, 900000, 12):
        ckio.save_checkpoint(d, step, {"step": step})
    open(os.path.join(d, "notes.ckpt"), "w").close()
    names = [os.path.basename(p) for p in ckio.list_checkpoints(d)]
    assert names == ["000012.ckpt", "900000.ckpt", "1000000.ckpt"]
    assert ckio.latest_checkpoint(d).endswith("1000000.ckpt")
    assert not [f for f in os.listdir(d) if f.endswith(".tmp")]
    assert ckio.list_checkpoints(str(tmp_path / "missing")) == []
    assert ckio.latest_checkpoint(str(tmp_path / "missing")) is None


def test_fields_a_checkpoint_lacks_keep_their_fresh_init(tmp_path, capsys):
    setup = _setup()
    a = _train(init_state(make_generator(0, "cpu"), setup, "cpu"), setup,
               make_generator(5, "cpu"), 2)
    sd = a.state_dict()
    del sd["opt_coarse"]
    path = ckio.save_checkpoint(str(tmp_path), a.step, sd)
    b = ckio.restore_checkpoint(
        path, init_state(make_generator(1, "cpu"), setup, "cpu"), "cpu")
    assert "predates state field 'opt_coarse'" in capsys.readouterr().out
    assert b.opt_coarse.count == 0 and not b.opt_coarse.state
    assert b.opt_fine.count == 2

    joint = init_state(make_generator(1, "cpu"), _setup(joint=True), "cpu")
    with pytest.raises(ValueError, match="opt_coarse"):
        joint.load_state_dict(a.state_dict())
