"""The port's field side (vpic_tpu_torch.field, .sf) against the JAX
package, on random ghost-padded fields made from one numpy seed: the cases
of test_kernel_parity.py (a 6x5x4 periodic grid) plus a 2D 8x8x1 grid, the
shape class of the bench deck.

Both sides run the same float32 operations in the same order, so the
results agree to float32 roundoff: rtol 2e-6, atol 1e-6 (atol covers the
differences of nearly cancelling terms, whose values are O(1)).  Float64
reductions agree to rtol 1e-12.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vpic_tpu.comm.facecomm import LocalComm as JComm
from vpic_tpu.core.types import (
    FieldState as JField,
    Grid as JGrid,
    PERIODIC_FIELDS,
    SpeciesState as JSpecies,
    vacuum_material_table as j_vacuum,
)
from vpic_tpu.field import ghost as jghost
from vpic_tpu.field import stencil as jstencil
from vpic_tpu.field import sync as jsync
from vpic_tpu.particles import aux as jaux
from vpic_tpu.sf import interp as jinterp

from vpic_tpu_torch.comm.facecomm import LocalComm
from vpic_tpu_torch.core.types import (
    FIELD_COMPONENTS,
    FieldState,
    Grid,
    REMOTE_FIELDS,
    SpeciesState,
    vacuum_material_table,
)
from vpic_tpu_torch.field import ghost, stencil, sync
from vpic_tpu_torch.particles import aux
from vpic_tpu_torch.sf import interp

from tests import torch_decks  # noqa: F401  (one torch thread)

TOL = dict(rtol=2e-6, atol=1e-6)
SHAPES = {"3d": (6, 5, 4), "2d": (8, 8, 1)}


def setup(shape):
    nx, ny, nz = SHAPES[shape]
    kw = dict(nx=nx, ny=ny, nz=nz, dt=0.04, cvac=1.0, eps0=1.0, gx1=1.0,
              gy1=1.0, gz1=1.0, fbc=(PERIODIC_FIELDS,) * 6,
              pbc=(PERIODIC_FIELDS,) * 6)
    jg, g = JGrid(**kw), Grid(**kw)
    rng = np.random.default_rng(42)
    arrays = {k: rng.normal(size=g.shape).astype(np.float32)
              for k in FIELD_COMPONENTS}
    jf = JField(**{k: jnp.asarray(v) for k, v in arrays.items()})
    f = FieldState(**{k: torch.as_tensor(v) for k, v in arrays.items()})
    return jg, g, rng, jf, f


def same_fields(f, jf, comps=FIELD_COMPONENTS, tol=TOL):
    for c in comps:
        np.testing.assert_allclose(getattr(f, c).numpy(),
                                   np.asarray(getattr(jf, c)), err_msg=c,
                                   **tol)


@pytest.mark.parametrize("shape", list(SHAPES))
def test_load_interpolator(shape):
    jg, g, rng, jf, f = setup(shape)
    np.testing.assert_allclose(interp.load_interpolator(f, g).numpy(),
                               np.asarray(jinterp.load_interpolator(jf, jg)),
                               **TOL)


@pytest.mark.parametrize("shape", list(SHAPES))
def test_advance_b(shape):
    jg, g, rng, jf, f = setup(shape)
    same_fields(stencil.advance_b(f, g, 0.5), jstencil.advance_b(jf, jg, 0.5))


@pytest.mark.parametrize("shape", list(SHAPES))
def test_advance_e_vacuum(shape):
    jg, g, rng, jf, f = setup(shape)
    out = stencil.advance_e(f, g, vacuum_material_table(), None,
                            LocalComm(g))
    jout = jstencil.advance_e(jf, jg, j_vacuum(), None, JComm(jg))
    same_fields(out, jout)


@pytest.mark.parametrize("shape", list(SHAPES))
def test_unload_accumulator(shape):
    jg, g, rng, jf, f = setup(shape)
    acc = rng.normal(size=(g.nv, 12))
    owned = np.zeros(g.shape, bool)
    owned[1:g.nz + 1, 1:g.ny + 1, 1:g.nx + 1] = True
    acc[~owned.reshape(-1)] = 0.0      # ghost accumulator entries are zero
    acc = acc.astype(np.float32)
    out = interp.unload_accumulator(interp.clear_jf(f, g),
                                    torch.as_tensor(acc), g)
    jout = jinterp.unload_accumulator(jinterp.clear_jf(jf, jg),
                                      jnp.asarray(acc), jg)
    same_fields(out, jout, ("jfx", "jfy", "jfz"))


@pytest.mark.parametrize("shape", list(SHAPES))
def test_synchronize_jf(shape):
    jg, g, rng, jf, f = setup(shape)
    same_fields(sync.synchronize_jf(f, g, LocalComm(g)),
                jsync.synchronize_jf(jf, jg, JComm(jg)))


@pytest.mark.parametrize("shape", list(SHAPES))
def test_synchronize_rho_and_tang_e_norm_b(shape):
    jg, g, rng, jf, f = setup(shape)
    same_fields(sync.synchronize_rho(f, g, LocalComm(g)),
                jsync.synchronize_rho(jf, jg, JComm(jg)))
    out, err = sync.synchronize_tang_e_norm_b(f, g, LocalComm(g))
    jout, jerr = jsync.synchronize_tang_e_norm_b(jf, jg, JComm(jg))
    same_fields(out, jout)
    np.testing.assert_allclose(float(err), float(jerr), rtol=1e-12)


@pytest.mark.parametrize("shape", list(SHAPES))
def test_ghost_fills(shape):
    jg, g, rng, jf, f = setup(shape)
    for name in ("ghost_tang_b", "ghost_norm_e", "ghost_div_b"):
        same_fields(getattr(ghost, name)(f, g, LocalComm(g)),
                    getattr(jghost, name)(jf, jg, JComm(jg)), tol=dict(
                        rtol=0, atol=0))


@pytest.mark.parametrize("shape", list(SHAPES))
def test_divergence_clean_and_curl(shape):
    jg, g, rng, jf, f = setup(shape)
    comm, jcomm = LocalComm(g), JComm(jg)
    mat, jmat = vacuum_material_table(), j_vacuum()
    pairs = [
        (stencil.compute_div_e_err(f, g, mat, None, comm),
         jstencil.compute_div_e_err(jf, jg, jmat, None, jcomm)),
        (stencil.clean_div_e(f, g, mat, None),
         jstencil.clean_div_e(jf, jg, jmat, None)),
        (stencil.compute_div_b_err(f, g), jstencil.compute_div_b_err(jf, jg)),
        (stencil.clean_div_b(f, g, comm), jstencil.clean_div_b(jf, jg, jcomm)),
        (stencil.compute_curl_b(f, g, mat, None, comm),
         jstencil.compute_curl_b(jf, jg, jmat, None, jcomm)),
        (stencil.compute_rhob(f, g, mat, None, comm),
         jstencil.compute_rhob(jf, jg, jmat, None, jcomm)),
    ]
    for out, jout in pairs:
        same_fields(out, jout)
    for fn in ("local_rms_div_e_err", "local_rms_div_b_err"):
        (e, v), (je, jv) = (getattr(stencil, fn)(f, g),
                            getattr(jstencil, fn)(jf, jg))
        np.testing.assert_allclose([float(e), float(v)],
                                   [float(je), float(jv)], rtol=1e-12)


@pytest.mark.parametrize("shape", list(SHAPES))
def test_energy_f(shape):
    jg, g, rng, jf, f = setup(shape)
    en = stencil.local_energy_f(f, g, vacuum_material_table(), None)
    jen = jstencil.local_energy_f(jf, jg, j_vacuum(), None)
    np.testing.assert_allclose(stencil.finish_energy_f(g, en).numpy(),
                               np.asarray(jstencil.finish_energy_f(jg, jen)),
                               rtol=1e-12)


@pytest.mark.parametrize("shape", list(SHAPES))
def test_accumulate_rho_p(shape):
    """Charge deposit: same weights; the JAX package sums in float32, the
    port in int64 fixed point (exactly rounded), rtol 1e-5."""
    jg, g, rng, jf, f = setup(shape)
    n = 200
    vox = g.voxel(rng.integers(1, g.nx + 1, n), rng.integers(1, g.ny + 1, n),
                  rng.integers(1, g.nz + 1, n)).astype(np.int32)
    cols = dict(dx=rng.uniform(-1, 1, n), dy=rng.uniform(-1, 1, n),
                dz=rng.uniform(-1, 1, n), q=rng.uniform(0.5, 1.5, n))
    cols = {k: v.astype(np.float32) for k, v in cols.items()}
    sp = SpeciesState.create("e", 0, -1.0, n).replace(
        np=torch.tensor(n, dtype=torch.int32), i=torch.as_tensor(vox),
        **{k: torch.as_tensor(v) for k, v in cols.items()})
    jsp = JSpecies.create("e", 0, -1.0, n).replace(
        np=jnp.int32(n), i=jnp.asarray(vox),
        **{k: jnp.asarray(v) for k, v in cols.items()})
    np.testing.assert_allclose(
        aux.accumulate_rho_p(f, sp, g).rhof.numpy(),
        np.asarray(jaux.accumulate_rho_p(jf, jsp, jg).rhof),
        rtol=1e-5, atol=1e-6)


def test_non_periodic_faces_raise():
    """Local faces are ported (tests/test_torch_walls.py); a face joined
    to another shard and a grid of several shards still raise."""
    g = Grid(nx=4, ny=4, nz=1, fbc=(REMOTE_FIELDS,) + (PERIODIC_FIELDS,) * 5)
    f = FieldState.zeros(g)
    with pytest.raises(NotImplementedError):
        ghost.ghost_tang_b(f, g, LocalComm(g))
    with pytest.raises(NotImplementedError):
        sync.synchronize_jf(f, g, LocalComm(g))
    g = Grid(nx=4, ny=4, nz=1, gpx=2)
    with pytest.raises(NotImplementedError):
        ghost.ghost_div_b(FieldState.zeros(g), g, LocalComm(g))
