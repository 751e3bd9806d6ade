"""The port's counter hash against repro.core.rng: bitwise equal.

The edge-space Rademacher field is regenerated from this hash inside the
CUDA kernel, so every bit must match the JAX package's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import rng as jrng
from repro_torch.core import rng as trng

SEEDS = [0, 1, 12345, 2**31, 2**32 - 7, 2**32 - 1]


def _u32(x):
    return jnp.asarray(np.asarray(x), jnp.uint32)


def _t(x):
    return torch.from_numpy(np.asarray(x, np.int64))


@pytest.mark.parametrize("seed", SEEDS)
def test_splitmix32_bitwise(seed):
    h = (np.arange(4096, dtype=np.int64) * 1_048_583 + seed) % 2**32
    want = np.asarray(jrng.splitmix32(_u32(h))).astype(np.int64)
    np.testing.assert_array_equal(trng.splitmix32(_t(h)).numpy(), want)


@pytest.mark.parametrize("seed", SEEDS)
def test_hash_u32_bitwise(seed):
    rows = np.arange(97)[:, None]
    cols = np.arange(61)[None, :]
    want = np.asarray(jrng.hash_u32(seed, _u32(rows), _u32(cols), 5)).astype(np.int64)
    got = trng.hash_u32(seed, _t(rows), _t(cols), 5).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", SEEDS)
def test_edge_rademacher_bitwise(seed):
    rows = np.arange(300)[:, None, None]
    cols = np.arange(300)[None, :, None]
    ks = np.arange(17)[None, None, :]
    want = np.asarray(jrng.edge_rademacher(seed, _u32(rows), _u32(cols), _u32(ks)))
    got = trng.edge_rademacher(seed, _t(rows), _t(cols), _t(ks)).numpy()
    np.testing.assert_array_equal(got, want)
    # antisymmetric with a zero diagonal, +/-1 elsewhere
    assert np.array_equal(got, -got.transpose(1, 0, 2))
    assert not got[np.arange(300), np.arange(300)].any()


@pytest.mark.parametrize("seed", SEEDS)
def test_uniform01_bitwise(seed):
    idx = np.arange(5000)
    want = np.asarray(jrng.uniform01(seed, _u32(idx), 3))
    got = trng.uniform01(seed, _t(idx), 3).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.min() >= 0.0 and got.max() < 1.0
