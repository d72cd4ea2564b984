"""The port's local field faces (vpic_tpu_torch.field.ghost, .sync,
.sf.hydro) against the JAX package, and a small metal-box deck with
interval cleans run in both.

Ghost fills and adjusts: a 6x5x4 grid with random fields from one numpy
seed, x and z faces of one local code (PEC, symmetric, PMC, absorbing), y
periodic.  Copies, negations, zeros and doublings are bitwise equal; the
absorbing face's Higdon ghost is a short float32 expression evaluated in
the same order, within rtol 2e-7.  The shared-face syncs and the hydro
adjust then merge planes by sums and averages of equal inputs: bitwise.

The deck: a 6x5x4 reflecting box (PEC on every face, particles reflected)
with electrons and ions, div-E and div-B cleaning and the shared-face sync
every 2 steps, after 8 steps: energies to 1e-6 relative, particles as sets
(voxels exact, floats to 1e-5 absolute), fields to 1e-5 absolute, the bars
of tests/test_torch_slice.py.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import vpic_tpu
from vpic_tpu.comm.facecomm import LocalComm as JComm
from vpic_tpu.core.types import FieldState as JField, Grid as JGrid
from vpic_tpu.engine.step import StepOptions as JOptions
from vpic_tpu.field import ghost as jghost
from vpic_tpu.field import sync as jsync
from vpic_tpu.sf import hydro as jhydro

import vpic_tpu_torch
from vpic_tpu_torch.comm.facecomm import LocalComm
from vpic_tpu_torch.core.types import (
    ABSORB_FIELDS,
    FIELD_COMPONENTS,
    FieldState,
    Grid,
    PERIODIC_FIELDS,
    PEC_FIELDS,
    PMC_FIELDS,
    SYMMETRIC_FIELDS,
)
from vpic_tpu_torch.field import ghost, sync
from vpic_tpu_torch.interop import state_to_numpy
from vpic_tpu_torch.sf import hydro

from tests import torch_decks  # noqa: F401  (one torch thread)

CODES = {"pec": PEC_FIELDS, "symmetric": SYMMETRIC_FIELDS, "pmc": PMC_FIELDS,
         "absorb": ABSORB_FIELDS}
GHOSTS = ("ghost_tang_b", "ghost_norm_e", "ghost_div_b")
ADJUSTS = ("adjust_tang_e", "adjust_norm_b", "adjust_div_e_err", "adjust_jf",
           "adjust_rhof", "adjust_rhob")
# the codes whose faces an adjust changes (every code for the rest)
ACTS = {"adjust_tang_e": ("pec",), "adjust_norm_b": ("symmetric",),
        "adjust_div_e_err": ("pec", "absorb"), "adjust_rhob": ("pec",)}


def setup(code):
    P = PERIODIC_FIELDS
    kw = dict(nx=6, ny=5, nz=4, dt=0.04, cvac=1.0, eps0=1.0, gx1=1.0,
              gy1=1.0, gz1=1.0, fbc=(code, P, code, code, P, code))
    jg, g = JGrid(**kw), Grid(**kw)
    rng = np.random.default_rng(17)
    arrays = {k: rng.normal(size=g.shape).astype(np.float32)
              for k in FIELD_COMPONENTS}
    jf = JField(**{k: jnp.asarray(v) for k, v in arrays.items()})
    f = FieldState(**{k: torch.as_tensor(v) for k, v in arrays.items()})
    return jg, g, rng, jf, f


def assert_fields(f, jf, rtol=0.0):
    for c in FIELD_COMPONENTS:
        a, b = getattr(f, c).numpy(), np.asarray(getattr(jf, c))
        if rtol:
            np.testing.assert_allclose(a, b, rtol=rtol, atol=0, err_msg=c)
        else:
            np.testing.assert_array_equal(a, b, err_msg=c)


@pytest.mark.parametrize("name", GHOSTS + ADJUSTS)
@pytest.mark.parametrize("code", list(CODES))
def test_ghost_and_adjust_match_jax(code, name):
    jg, g, _, jf, f = setup(CODES[code])
    out = getattr(ghost, name)(f, g, LocalComm(g))
    jout = getattr(jghost, name)(jf, jg, JComm(jg))
    higdon = code == "absorb" and name == "ghost_tang_b"
    assert_fields(out, jout, rtol=2e-7 if higdon else 0.0)
    changed = any(not torch.equal(getattr(out, c), getattr(f, c))
                  for c in FIELD_COMPONENTS)
    assert changed == (code in ACTS.get(name, CODES))


@pytest.mark.parametrize("code", list(CODES))
def test_syncs_and_hydro_adjust_match_jax(code):
    jg, g, rng, jf, f = setup(CODES[code])
    comm, jcomm = LocalComm(g), JComm(jg)
    assert_fields(sync.synchronize_jf(f, g, comm),
                  jsync.synchronize_jf(jf, jg, jcomm))
    assert_fields(sync.synchronize_rho(f, g, comm),
                  jsync.synchronize_rho(jf, jg, jcomm))
    out, err = sync.synchronize_tang_e_norm_b(f, g, comm)
    jout, jerr = jsync.synchronize_tang_e_norm_b(jf, jg, jcomm)
    assert_fields(out, jout)
    np.testing.assert_allclose(float(err), float(jerr), rtol=1e-12)
    h = rng.normal(size=(g.nv, 14)).astype(np.float32)
    np.testing.assert_array_equal(
        hydro.synchronize_hydro(torch.as_tensor(h), g, comm).numpy(),
        np.asarray(jhydro.synchronize_hydro(jnp.asarray(h), jg, jcomm)))


def test_unknown_face_code_raises():
    g = Grid(nx=4, ny=4, nz=2, fbc=(-7,) + (PERIODIC_FIELDS,) * 5)
    with pytest.raises(ValueError, match="bad field boundary"):
        ghost.adjust_jf(FieldState.zeros(g), g, LocalComm(g))


STEPS = 8
CLEAN = dict(clean_div_e_interval=2, clean_div_b_interval=2,
             sync_shared_interval=2)


def metal_box(pkg, **kw):
    """A 6x5x4 reflecting box with 3000 electrons and 3000 ions, the same
    particles in either package (numpy seed 3)."""
    sim = pkg.Simulation(seed=0, **kw)
    sim.define_units(1.0, 1.0)
    nx, ny, nz = 6, 5, 4
    sim.define_timestep(0.9 * sim.courant_length(1.0, 1.0, 1.0, nx, ny, nz))
    sim.define_reflecting_grid(0, 0, 0, 1.0, 1.0, 1.0, nx, ny, nz)
    sim.define_material("vacuum")
    n = 3000
    rng = np.random.default_rng(3)
    x, y, z = (rng.uniform(0, 1.0, n) for _ in range(3))
    for name, q_m, sgn, ut in (("electron", -1.0, -1.0, 0.15),
                               ("ion", 1.0 / 25.0, 1.0, 0.03)):
        sp = sim.define_species(name, q_m, 2 * n)
        sim.inject_particle(sp, x, y, z, *(rng.normal(0, ut, n)
                                           for _ in range(3)), q=sgn / n)
    # a standing wave in every component, so that no field energy is
    # near zero
    for comp, (a, b) in dict(ex=(1, 2), ey=(2, 0), ez=(0, 1), cbx=(1, 2),
                             cby=(2, 0), cbz=(0, 1)).items():
        sim.set_field(comp, lambda *p, a=a, b=b: 0.05 * np.sin(
            np.pi * p[a]) * np.cos(np.pi * p[b]))
    return sim


@pytest.fixture(scope="module")
def box_runs():
    jsim = metal_box(vpic_tpu)
    jsim.opts = JOptions(**CLEAN)
    jsim.finalize()
    tsim = metal_box(vpic_tpu_torch, device="cpu")
    tsim.opts = dataclasses.replace(tsim.opts, **CLEAN)
    tsim.finalize()
    out = dict(j0=state_to_numpy(jsim.state), t0=state_to_numpy(tsim.state))
    jsim.advance(STEPS)
    tsim.advance(STEPS)
    out.update(j1=state_to_numpy(jsim.state), t1=state_to_numpy(tsim.state),
               je=jsim.energies(), te=tsim.energies(),
               jnm=jsim.mover_counts(), tnm=tsim.mover_counts())
    return out


def test_box_loads_identical_particles(box_runs):
    for k in range(2):
        for c in ("dx", "dy", "dz", "i", "q", "np"):
            key = f"species/{k}/{c}"
            np.testing.assert_array_equal(box_runs["t0"][key],
                                          box_runs["j0"][key], err_msg=key)


def test_box_energies_and_movers_match(box_runs):
    for name, e in box_runs["je"].items():
        np.testing.assert_allclose(box_runs["te"][name], e, rtol=1e-6,
                                   atol=1e-12, err_msg=name)
    assert box_runs["tnm"] == box_runs["jnm"]


def sorted_particles(d, k):
    pre = f"species/{k}/"
    n = int(d[pre + "np"])
    cols = {c: d[pre + c][:n] for c in ("i", "dx", "dy", "dz", "ux", "uy",
                                         "uz", "q")}
    order = np.lexsort((cols["dz"], cols["dy"], cols["dx"], cols["i"]))
    return {c: v[order] for c, v in cols.items()}


@pytest.mark.parametrize("k", [0, 1], ids=["electron", "ion"])
def test_box_particles_match_as_sets(box_runs, k):
    t = sorted_particles(box_runs["t1"], k)
    j = sorted_particles(box_runs["j1"], k)
    np.testing.assert_array_equal(t["i"], j["i"])
    for c in ("dx", "dy", "dz", "ux", "uy", "uz", "q"):
        np.testing.assert_allclose(t[c], j[c], rtol=0, atol=1e-5, err_msg=c)


def test_box_fields_match(box_runs):
    for c in FIELD_COMPONENTS:
        np.testing.assert_allclose(box_runs["t1"][f"field/{c}"],
                                   box_runs["j1"][f"field/{c}"], rtol=0,
                                   atol=1e-5, err_msg=c)
    np.testing.assert_allclose(box_runs["t1"]["interpolator"],
                               box_runs["j1"]["interpolator"], rtol=0,
                               atol=1e-5)
    # the walls hold: no tangential E on the z faces' planes
    ex = box_runs["t1"]["field/ex"]
    assert not np.any(ex[1, 1:-1, 1:-1]) and not np.any(ex[-1, 1:-1, 1:-1])
    assert np.any(ex[2, 1:-1, 1:-1])
