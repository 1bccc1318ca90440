"""Depth-data fault injection (port of ``plnerf/data/fault_injection.py``,
an own copy in numpy; reference depth_supervised_exps/data/
error_sources.py:3-21 — defined there for robustness experiments, never
called by the drivers; provided here with the same semantics on numpy
arrays so experiments can opt in)."""
from __future__ import annotations

from typing import Tuple

import numpy as np


def add_missing_depth(
    depth: np.ndarray, valid_depth: np.ndarray, p: float = 0.1,
    invalid_depth_value: float = 0.0, seed: int = 0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Invalidate random pixels until a fraction ``p`` of all pixels is
    invalid (no-op if already above ``p``)."""
    depth = depth.copy()
    valid_depth = valid_depth.astype(bool).copy()
    n_pixels = valid_depth.size
    n_valid = int(valid_depth.sum())
    p_before = float(n_pixels - n_valid) / float(n_pixels)
    p_gap = p - p_before
    if p_gap <= 0.0:
        return depth, valid_depth
    p_to_invalidate = p_gap * float(n_pixels) / float(n_valid)
    rng = np.random.default_rng(seed)
    invalid = rng.random(depth.shape) < p_to_invalidate
    valid_depth[invalid] = False
    depth[invalid] = invalid_depth_value
    return depth, valid_depth


def add_quadratic_depth_noise(
    depth: np.ndarray, valid_depth: np.ndarray, a: float = 1.68e-3,
    b: float = 6.58e-3, c: float = 4.78e-2, seed: int = 0,
) -> np.ndarray:
    """Gaussian noise with std = a*d^2 + b*d + c on valid pixels
    (sensor-like quadratic error model), clamped to >= 0."""
    depth = depth.copy()
    valid_depth = valid_depth.astype(bool)
    d = depth[valid_depth]
    std = a * d ** 2 + b * d + c
    rng = np.random.default_rng(seed)
    noise = rng.standard_normal(std.shape) * std
    depth[valid_depth] = np.clip(d + noise, 0.0, None)
    return depth


def compute_samples_per_subset(sample_count: int,
                               validate_on_at_least_n_samples: int):
    """Reference data/dataset_sampling.py:4-10."""
    validate_on_at_least_n_samples = min(
        validate_on_at_least_n_samples, sample_count)
    number_subsets = sample_count // validate_on_at_least_n_samples
    samples_per_subset = sample_count // number_subsets
    extra_sample_subsets = sample_count % samples_per_subset
    normal_subsets = number_subsets - extra_sample_subsets
    return samples_per_subset, normal_subsets, extra_sample_subsets


def create_random_subsets(indices, validate_on_at_least_n_samples: int,
                          seed: int = 0):
    """Random partition of ``indices`` into subsets of (at least)
    ``validate_on_at_least_n_samples`` (reference dataset_sampling.py:12-16,
    used by the camera-embedding test-time optimization)."""
    indices = np.asarray(list(indices))
    sps, normal, extra = compute_samples_per_subset(
        len(indices), validate_on_at_least_n_samples)
    perm = np.random.default_rng(seed).permutation(indices)
    sizes = [sps] * normal + [sps + 1] * extra
    out, off = [], 0
    for s in sizes:
        out.append(perm[off: off + s])
        off += s
    return out
