"""The port's random state (``vpic_tpu_torch/core/random.py``) against
``jax.random`` (threefry2x32, ``jax_threefry_partitionable`` on), on the
CPU, where every function runs its plain torch twin; the card's kernel
(``csrc/threefry.cu``) is held to the twin in tests/test_torch_cuda.py.

Bars: the hash, keys, splits, bits and uniforms bitwise; normals within
NORMAL_ULPS float32 ulps (the platforms' log1p differ: 3 ulps at most over
2^24 draws, measured on the CPU here); seeds outside int64 raise as
``jax.random.key`` does.  Keys are the JAX package's, made with
``jax_enable_x64`` on as its import sets it.  Two steps of a deck that
draws draw different numbers (a key that a graph froze would repeat
them).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax._src import prng

import vpic_tpu  # noqa: F401  (turns on jax_enable_x64, as the package runs)

from vpic_tpu_torch import Simulation
from vpic_tpu_torch.boundary.models import MaxwellianReflux, TINY
from vpic_tpu_torch.core import random as rnd

from tests import torch_decks  # noqa: F401  (one torch thread)

NORMAL_ULPS = 4
N = 1 << 16
SEEDS = (0, 1, 2, 131074, 2 ** 31 - 1, 2 ** 31, 2 ** 32, 2 ** 40, -5,
         2 ** 63 - 1, -2 ** 63, 2 ** 63, 2 ** 64, np.uint64(2 ** 64 - 1))


def words(key) -> np.ndarray:
    """A JAX key's data as the port holds it."""
    return np.asarray(jax.random.key_data(key)).astype(np.int64)


def test_threefry_is_jax():
    rng = np.random.default_rng(0)
    for _ in range(3):
        k = rng.integers(0, 2 ** 32, 2, dtype=np.uint64).astype(np.uint32)
        x = rng.integers(0, 2 ** 32, 2 * 999,
                         dtype=np.uint64).astype(np.uint32)
        want = np.asarray(prng.threefry_2x32(jnp.asarray(k), jnp.asarray(x)))
        # threefry_2x32 hashes the first half of the counts with the second
        t = lambda a: torch.as_tensor(a.astype(np.int64))
        x1, x2 = rnd.threefry2x32(int(k[0]), int(k[1]), t(x[:999]),
                                  t(x[999:]))
        np.testing.assert_array_equal(
            np.concatenate([x1.numpy(), x2.numpy()]), want.astype(np.int64))


@pytest.mark.parametrize("seed", SEEDS)
def test_make_key_is_jax_key_data(seed):
    assert jax.config.jax_enable_x64
    try:
        want = words(jax.random.key(seed))
    except OverflowError as e:
        with pytest.raises(OverflowError, match=str(e)):
            rnd.make_key(seed)
        return
    got = rnd.make_key(seed)
    assert got.dtype == torch.int64 and got.shape == (2,)
    np.testing.assert_array_equal(got.numpy(), want)


def test_split_is_jax_split():
    key, tkey = jax.random.key(42), rnd.make_key(42)
    for n in (1, 2, 3, 6):
        np.testing.assert_array_equal(rnd.split(tkey, n).numpy(),
                                      words(jax.random.split(key, n)))
    # the rounds' chain: key, k2 = split(key), once per (round, species)
    for _ in range(6):
        key, k2 = jax.random.split(key)
        tkey, t2 = rnd.split(tkey)
        np.testing.assert_array_equal(t2.numpy(), words(k2))
        np.testing.assert_array_equal(tkey.numpy(), words(key))


@pytest.mark.parametrize("lo,hi", [(0.0, 1.0), (-1.0, 1.0), (TINY, 1.0),
                                   (0.0, 2 * np.pi), (-3.3, 7.1)])
def test_bits_and_uniform_are_jax(lo, hi):
    key = jax.random.key(7)
    tkey = torch.as_tensor(words(key))
    np.testing.assert_array_equal(
        rnd.bits(tkey, N).numpy(),
        np.asarray(jax.random.bits(key, (N,), jnp.uint32)).astype(np.int64))
    got = rnd.uniform(tkey, N, lo, hi)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jax.random.uniform(key, (N,), jnp.float32,
                                                   lo, hi)))


def test_normal_is_jax_within_ulps():
    for seed in (0, 9):
        key = jax.random.key(seed)
        want = np.asarray(jax.random.normal(key, (4 * N,), jnp.float32))
        got = rnd.normal(torch.as_tensor(words(key)), 4 * N).numpy()
        ulps = np.abs(got.view(np.int32).astype(np.int64)
                      - want.view(np.int32).astype(np.int64))
        assert ulps.max() <= NORMAL_ULPS
        assert np.isfinite(got).all()


def test_draw_sizes_are_checked():
    key = rnd.make_key(1)
    with pytest.raises(ValueError, match="2\\^32"):
        rnd.uniform(key, 2 ** 32)
    with pytest.raises(ValueError, match="rng is None"):
        rnd.split(None)
    assert rnd.normal(key, 0).shape == (0,)


def test_a_drawing_deck_draws_anew_each_step():
    """The reflux box of tests/test_torch_boundary.py: every step splits
    the state's key once (the rounds), and the draws of two steps from
    their keys differ."""
    from tests.test_torch_boundary import drifting_box
    sim = drifting_box(Simulation, MaxwellianReflux(ut_para=(0.2,),
                                                    ut_perp=(0.2,)),
                       device="cpu")
    sim.finalize()
    keys = [sim.state.rng.clone()]
    for _ in range(2):
        sim.advance(1)
        keys.append(sim.state.rng.clone())
    assert torch.equal(keys[1], rnd.split(keys[0])[0])
    assert torch.equal(keys[2], rnd.split(keys[1])[0])
    a = rnd.normal(rnd.split(keys[0])[1], 64)
    b = rnd.normal(rnd.split(keys[1])[1], 64)
    assert not torch.equal(a, b)
