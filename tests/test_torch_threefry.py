"""Threefry bits of the torch port against the JAX package: bit-exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cs397raytracingsp22_tpu.utils import threefry as jtf
from cs397raytracingsp22_tpu_torch.utils import threefry as ttf

torch.set_num_threads(1)  # several test workers share the cores


def _uids(seed, n=4096):
    rng = np.random.default_rng(seed)
    u = rng.integers(-(2**31), 2**31, size=n, dtype=np.int64).astype(np.int32)
    u[:4] = [0, 1, -1, 2**31 - 1]
    return u


def test_threefry2x32_bit_exact():
    rng = np.random.default_rng(0)
    keys = rng.integers(0, 2**32, size=(8, 2), dtype=np.uint64).astype(np.uint32)
    counters = rng.integers(0, 2**32, size=(2, 4096), dtype=np.uint64).astype(np.uint32)
    for k0, k1 in keys:
        rj = jtf.threefry2x32(k0, k1, counters[0], counters[1])
        rt = ttf.threefry2x32(
            int(k0), int(k1),
            torch.from_numpy(counters[0].astype(np.int64)),
            torch.from_numpy(counters[1].astype(np.int64)),
        )
        for a, b in zip(rj, rt):
            np.testing.assert_array_equal(np.asarray(a).astype(np.int64), b.numpy())


@pytest.mark.parametrize("seed", [0, 42, 2**32 + 7, 2**63 - 25])
def test_key_words(seed):
    np.testing.assert_array_equal(
        np.asarray(jtf.key_words(seed)).astype(np.int64), ttf.key_words(seed).numpy()
    )


@pytest.mark.parametrize("m", [4, 5, 6, 7, 8, 9])
def test_bounce_uniforms_bit_exact(m):
    uids = _uids(m)
    for seed, site in [(0, 1), (123, 2), (2**40 + 5, 9), (77, 65535)]:
        a = np.asarray(jtf.bounce_uniforms(jtf.key_words(seed), jnp.asarray(uids), site, m))
        b = ttf.bounce_uniforms(ttf.key_words(seed), torch.from_numpy(uids), site, m).numpy()
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32))


@pytest.mark.parametrize("m", [1, 2, 3, 4, 5])
def test_counter_uniforms_bit_exact(m):
    uids = _uids(100 + m)
    for seed, site in [(0, 0), (9, 3), (2**33 + 1, 4096)]:
        a = np.asarray(jtf.counter_uniforms(seed, jnp.asarray(uids), site, m))
        b = ttf.counter_uniforms(seed, torch.from_numpy(uids), site, m).numpy()
        np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32))
