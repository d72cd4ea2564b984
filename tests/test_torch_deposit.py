"""The port's plain current deposit (vpic_tpu_torch.particles.deposit,
reached through the CUDA kernel's wrapper with CPU tensors) against the
JAX package's Pallas deposit kernel in interpret mode
(vpic_tpu.particles.deposit_pallas), and the port's unfused push with the
sorted deposit against the JAX package's push.advance_p(sorted_deposit=
True), which reaches the same kernel.

The grids of tests/test_torch_push.py have nv = 336 voxels, fewer than the
Pallas kernel's default 512-voxel window: with it the kernel writes past
its (12, 384) accumulator (an IndexError in interpret mode; ROADMAP queue
3).  The push test therefore runs the JAX deposit with a 384-voxel window,
the whole padded grid, which keeps every lane on the kernel's own path.

Both packages get the same float32 inputs made from one numpy seed.
Tolerances: the deposit sums the same float32 contributions in another
order (the Pallas kernel by one-hot matmuls per block): rtol/atol 1e-5,
the bounds of tests/test_deposit_pallas.py.  The push: voxels, pcode and
the dropped-mover count equal; particle floats and the accumulator to the
bounds of tests/test_torch_push.py.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from vpic_tpu.particles import deposit_pallas as jdep
from vpic_tpu.particles import push as jpush

from vpic_tpu_torch.particles import deposit, deposit_cuda, push_cuda

from .test_torch_push import ACC, FLOATS, MAX_NP, N, PBCS, both_species, \
    case, particles

from tests import torch_decks  # noqa: F401  (one torch thread)

# the cases of tests/test_deposit_pallas.py: (n, nv, sorted)
DEPOSIT_CASES = [(5000, 2000, True), (1024, 130 * 130, True),
                 (4096, 3000, False)]


@pytest.mark.parametrize("n,nv,is_sorted", DEPOSIT_CASES,
                         ids=["sorted-5000", "sorted-1024", "unsorted-4096"])
def test_deposit_dense_sorted_matches_pallas(n, nv, is_sorted):
    rng = np.random.default_rng(1 if is_sorted else 2)
    vox = rng.integers(1, nv - 5, n)
    vox = (np.sort(vox) if is_sorted else vox).astype(np.int32)
    c = rng.normal(size=(n, 12)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jdep.deposit_dense_sorted(jnp.asarray(vox),
                                                   jnp.asarray(c), nv))
    out = deposit_cuda.deposit_dense_sorted(torch.as_tensor(vox),
                                            torch.as_tensor(c), nv)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)


def test_deposit_sorted_into_skips_invalid_lanes():
    """Masked lanes add nothing, whatever their voxel; the second result
    (lanes dropped) is 0."""
    rng = np.random.default_rng(3)
    n, nv = 700, 50
    vox = torch.as_tensor(rng.integers(0, nv, n).astype(np.int32))
    cols = tuple(torch.as_tensor(rng.normal(size=n).astype(np.float32))
                 for _ in range(12))
    valid = torch.as_tensor(rng.random(n) < 0.5)
    acc0 = torch.as_tensor(rng.normal(size=(nv, 12)).astype(np.float32))
    acc, dropped = deposit.deposit_sorted_into(acc0, vox, cols, valid, nv)
    ref = acc0.clone()
    for s in np.flatnonzero(valid.numpy()):
        ref[vox[s]] += torch.stack([c[s] for c in cols])
    np.testing.assert_allclose(acc.numpy(), ref.numpy(), rtol=1e-6,
                               atol=1e-6)
    assert int(dropped) == 0


@pytest.mark.parametrize("hot", [False, True], ids=["cold", "hot"])
@pytest.mark.parametrize("pbc_name", list(PBCS))
def test_unfused_sorted_push_matches_jax(monkeypatch, pbc_name, hot):
    jg, g, rng, interp, nb = case(pbc_name, hot)
    jsp, tsp = both_species(particles(g, rng, hot))
    assert g.nv == 336
    monkeypatch.setattr(jdep, "deposit_sorted_into", functools.partial(
        jdep.deposit_sorted_into, window=384))

    with pltpu.force_tpu_interpret_mode():
        jout, jacc = jax.jit(lambda sp: jpush.advance_p(
            sp, jnp.asarray(interp), jnp.zeros((g.nv, 12), jnp.float32),
            jnp.asarray(nb), jg, n_walk=4, max_nm=MAX_NP,
            sorted_deposit=True))(jsp)
    tout, tacc = push_cuda.advance_p(
        tsp, torch.as_tensor(interp), torch.zeros((g.nv, 12)),
        torch.as_tensor(nb), g, n_walk=4, fused=False)

    live = np.arange(MAX_NP) < N
    assert int(tout.nm) == int(jout.nm)
    for c in ("i", "pc"):
        np.testing.assert_array_equal(getattr(tout, c).numpy()[live],
                                      np.asarray(getattr(jout, c))[live],
                                      err_msg=c)
    for c in ("dx", "dy", "dz", "ux", "uy", "uz", "mdx", "mdy", "mdz"):
        np.testing.assert_allclose(getattr(tout, c).numpy()[live],
                                   np.asarray(getattr(jout, c))[live],
                                   err_msg=c, **FLOATS)
    np.testing.assert_allclose(tacc.numpy(), np.asarray(jacc), **ACC)
