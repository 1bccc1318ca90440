"""The work arithmetic of ``lib/work.py`` against the counts of the
flagship recipe's 8 x 256 MLP and a 1024-ray step."""
import json
import os

import pytest

from portbench.lib import work

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def flags(name):
    with open(os.path.join(HERE, "configs", name + ".json")) as f:
        return json.load(f)["flags"]


def test_flops_per_point_of_the_8x256_mlp():
    f = flags("blender_linear")
    # forward: 1.187 M split, 1.056 M folded; the backward kernel's
    # recompute, data and weight products: 3.166 M folded; the backward's
    # data and weight products alone: 2.111 M
    assert work.fwd_flops_per_point(f, "split") == 1_186_816
    assert work.fwd_flops_per_point(f) == 1_055_744
    assert work.bwd_kernel_flops_per_point(f) == 3_165_952
    assert work.bwd_model_flops_per_point(f) == 2 * 1_055_744
    assert work.model_flops_per_point(f, train=True) == 3 * 1_055_744
    assert work.model_flops_per_point(f, train=False) == 1_055_744


@pytest.mark.parametrize("config,coarse,fine", [
    ("blender_linear", 131_072, 196_608),
    ("blender_linear_occ", 32_768, 98_304)])
def test_points_of_a_1024_ray_step(config, coarse, fine):
    f = flags(config)
    c, fn = work.points_per_ray(f)
    assert (c * f["N_rand"], fn * f["N_rand"]) == (coarse, fine)


def test_bound_is_the_larger_of_operations_and_bytes():
    assert work.bound_s(67e12, 0.0, "float32") == pytest.approx(1.0)
    assert work.bound_s(989e12, 0.0, "bfloat16") == pytest.approx(1.0)
    assert work.bound_s(0.0, 3.35e12, "float32") == pytest.approx(1.0)
    f = flags("blender_linear")
    n = 131_072
    # the forward is bound by operations at these widths
    assert n * work.fwd_flops_per_point(f) / 67e12 > \
        work.fwd_bytes(f, n, 1024) / 3.35e12
