"""The port's plain particle push (vpic_tpu_torch.particles.push, reached
through the CUDA kernel's wrapper with CPU tensors) against the JAX
package's XLA path (vpic_tpu.particles.push), on the grids of
test_push_pallas.py: hot and cold lanes, all-periodic faces and
reflect+absorb faces.

Both packages get the same float32 inputs made from one numpy seed.
Tolerances: voxels, pcode and the dropped-mover count must be equal; the
particle floats may differ by a few float32 ulp (XLA's CPU backend may
contract a multiply-add where PyTorch rounds twice): rtol 4e-6, atol 1e-6.
The accumulator sums the same contributions in another order (XLA scatter
vs index_add): rtol 1e-5, atol 1e-6.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vpic_tpu.core.types import (
    Grid as JGrid,
    NEIGHBOR_ABSORB,
    NEIGHBOR_REFLECT,
    PERIODIC_FIELDS,
    SpeciesState as JSpecies,
)
from vpic_tpu.grid.partition import build_neighbor_table as j_neighbors
from vpic_tpu.particles import push as jpush

from vpic_tpu_torch.core.types import Grid, SpeciesState
from vpic_tpu_torch.grid.partition import build_neighbor_table
from vpic_tpu_torch.particles import push, push_cuda

from tests import torch_decks  # noqa: F401  (one torch thread)

NX, NY, NZ = 6, 5, 4
DT = 0.04
N, MAX_NP = 300, 512
PBCS = {"periodic": (PERIODIC_FIELDS,) * 6,
        "reflect_absorb": (NEIGHBOR_REFLECT, NEIGHBOR_ABSORB)
        + (PERIODIC_FIELDS,) * 4}
FLOATS = dict(rtol=4e-6, atol=1e-6)
ACC = dict(rtol=1e-5, atol=1e-6)


def grids(pbc):
    kw = dict(nx=NX, ny=NY, nz=NZ, dt=DT, cvac=1.0, eps0=1.0, gx1=1.0,
              gy1=1.0, gz1=1.0, fbc=(PERIODIC_FIELDS,) * 6, pbc=pbc)
    return JGrid(**kw), Grid(**kw)


def particles(g, rng, hot):
    """Sorted particles as numpy columns, padded to MAX_NP dead slots."""
    vox = np.asarray(g.voxel(rng.integers(1, g.nx + 1, N),
                             rng.integers(1, g.ny + 1, N),
                             rng.integers(1, g.nz + 1, N)), np.int32)
    order = np.argsort(vox, kind="stable")
    ut = 3.0 if hot else 0.2
    cols = dict(dx=rng.uniform(-1, 1, N), dy=rng.uniform(-1, 1, N),
                dz=rng.uniform(-1, 1, N), ux=rng.normal(0, ut, N),
                uy=rng.normal(0, ut, N), uz=rng.normal(0, ut, N),
                q=rng.uniform(0.5, 1.5, N))
    pad = lambda a, dt: np.concatenate([a[order], np.zeros(MAX_NP - N)]
                                       ).astype(dt)
    out = {k: pad(v, np.float32) for k, v in cols.items()}
    out["i"] = pad(vox, np.int32)
    return out


def both_species(cols):
    jsp = JSpecies.create("e", 0, -1.0, MAX_NP).replace(
        np=jnp.int32(N), **{k: jnp.asarray(v) for k, v in cols.items()})
    tsp = SpeciesState.create("e", 0, -1.0, MAX_NP).replace(
        np=torch.tensor(N, dtype=torch.int32),
        **{k: torch.as_tensor(v) for k, v in cols.items()})
    return jsp, tsp


def case(pbc_name, hot):
    jg, g = grids(PBCS[pbc_name])
    rng = np.random.default_rng(7)
    interp = (0.1 * rng.normal(size=(g.nv, 18))).astype(np.float32)
    nb = build_neighbor_table(g)
    np.testing.assert_array_equal(nb, j_neighbors(jg))
    return jg, g, rng, interp, nb


@pytest.mark.parametrize("hot", [False, True], ids=["cold", "hot"])
@pytest.mark.parametrize("pbc_name", list(PBCS))
def test_advance_p_matches_jax(pbc_name, hot):
    jg, g, rng, interp, nb = case(pbc_name, hot)
    jsp, tsp = both_species(particles(g, rng, hot))

    jout, jacc = jax.jit(lambda sp: jpush.advance_p(
        sp, jnp.asarray(interp), jnp.zeros((g.nv, 12), jnp.float32),
        jnp.asarray(nb), jg, n_walk=4, max_nm=MAX_NP))(jsp)
    tout, tacc = push_cuda.advance_p(
        tsp, torch.as_tensor(interp), torch.zeros((g.nv, 12)),
        torch.as_tensor(nb), g, n_walk=4)

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
    if pbc_name == "reflect_absorb" and hot:
        # the absorbing face stops lanes with their code, left pending
        assert (tout.pc.numpy()[live] == NEIGHBOR_ABSORB).any()


@pytest.mark.parametrize("hot", [False, True], ids=["cold", "hot"])
@pytest.mark.parametrize("pbc_name", list(PBCS))
def test_walk_only_matches_streak_walk(pbc_name, hot):
    """The walk_only entry's plain version against push.streak_walk, from
    mid-walk lanes (half of them active) with given remaining
    displacements."""
    jg, g, rng, interp, nb = case(pbc_name, hot)
    cols = particles(g, rng, hot)
    scale = 1.5 if hot else 0.3
    rem = {k: rng.uniform(-scale, scale, MAX_NP).astype(np.float32)
           for k in ("rx", "ry", "rz")}
    active = (np.arange(MAX_NP) < N) & (rng.random(MAX_NP) < 0.5)
    pcode = np.zeros(MAX_NP, np.int32)
    names = dict(x="dx", y="dy", z="dz", vox="i", ux="ux", uy="uy", uz="uz",
                 q="q")
    jst = jpush.WalkState(**{k: jnp.asarray(cols[v])
                             for k, v in names.items()},
                          **{k: jnp.asarray(v) for k, v in rem.items()},
                          pcode=jnp.asarray(pcode), active=jnp.asarray(active))
    tst = push.WalkState(**{k: torch.as_tensor(cols[v])
                            for k, v in names.items()},
                         **{k: torch.as_tensor(v) for k, v in rem.items()},
                         pcode=torch.as_tensor(pcode),
                         active=torch.as_tensor(active))

    jout, jacc = jax.jit(lambda st: jpush.streak_walk(
        st, jnp.zeros((g.nv, 12), jnp.float32), jnp.asarray(nb), jg, 2))(jst)
    tout, tacc = push_cuda.streak_walk(tst, torch.zeros((g.nv, 12)),
                                       torch.as_tensor(nb), g, 2)

    assert not tout.active.any()
    for c in ("vox", "pcode"):
        np.testing.assert_array_equal(getattr(tout, c).numpy(),
                                      np.asarray(getattr(jout, c)),
                                      err_msg=c)
    for c in ("x", "y", "z", "ux", "uy", "uz", "rx", "ry", "rz"):
        np.testing.assert_allclose(getattr(tout, c).numpy(),
                                   np.asarray(getattr(jout, c)),
                                   err_msg=c, **FLOATS)
    np.testing.assert_allclose(tacc.numpy(), np.asarray(jacc), **ACC)


@pytest.mark.parametrize("fn", ["center_p", "uncenter_p"])
def test_center_uncenter_match_jax(fn):
    jg, g, rng, interp, nb = case("periodic", False)
    jsp, tsp = both_species(particles(g, rng, hot=False))
    jout = getattr(jpush, fn)(jsp, jnp.asarray(interp), jg)
    tout = getattr(push, fn)(tsp, torch.as_tensor(interp), g)
    for c in ("ux", "uy", "uz"):
        np.testing.assert_allclose(getattr(tout, c).numpy()[:N],
                                   np.asarray(getattr(jout, c))[:N],
                                   err_msg=c, **FLOATS)


def test_energy_p_matches_jax():
    """Kinetic energy: float64 sums of the same float32 terms, rtol 1e-6."""
    jg, g, rng, interp, nb = case("periodic", True)
    jsp, tsp = both_species(particles(g, rng, hot=True))
    je = jpush.finish_energy_p(jsp, jg, jpush.energy_p(
        jsp, jnp.asarray(interp), jg))
    te = push.finish_energy_p(tsp, g, push.energy_p(
        tsp, torch.as_tensor(interp), g))
    np.testing.assert_allclose(float(te), float(je), rtol=1e-6)
