"""In-step injection of the port (``deck/inject.py``) against the JAX
package's ``Injector``, and through the port's step (tests/test_inject.py:
Gauss's law kept by the rhob update and broken without it, the aged
partial push).

The injector's placement is float64 arithmetic on the same inputs, so the
injected slots must equal the JAX package's exactly, the aged
displacements to float32 roundoff (rtol 4e-6, atol 1e-6) and rhob within
1e-6 of the summed |weight| per node.
"""

import dataclasses

import numpy as np
import torch

import jax.numpy as jnp

from vpic_tpu.core.types import (ABSORB_FIELDS, FieldState as JField,
                                 Grid as JGrid, PERIODIC_FIELDS,
                                 SimState as JState,
                                 SpeciesState as JSpecies)
from vpic_tpu.deck.inject import Injector as JInjector

from vpic_tpu_torch import Simulation
from vpic_tpu_torch.core.types import FieldState, Grid, SimState, SpeciesState
from vpic_tpu_torch.deck.inject import Injector
from vpic_tpu_torch.field import stencil, sync
from vpic_tpu_torch.particles import aux
from vpic_tpu_torch.sf import interp as sfi

from tests import torch_decks  # noqa: F401  (one torch thread)

FLOATS = dict(rtol=4e-6, atol=1e-6)


def test_injector_matches_jax():
    """Two calls of 64 lanes into an 8x6x4 box with absorbing x faces:
    lanes inside, on the far x wall (owned), on the far y wall (periodic:
    not owned), outside, masked off, aged and not."""
    fbc = (ABSORB_FIELDS, PERIODIC_FIELDS, PERIODIC_FIELDS, ABSORB_FIELDS,
           PERIODIC_FIELDS, PERIODIC_FIELDS)
    kw = dict(nx=8, ny=6, nz=4, dt=0.05, gx1=1.0, gy1=0.75, gz1=0.5, fbc=fbc)
    jg, g = JGrid(**kw), Grid(**kw)
    max_np = 256
    jstate = JState(field=JField.zeros(jg), interpolator=None,
                    species=(JSpecies.create("e", 0, -1.0, max_np),),
                    grid_arrays=None, materials=None, material_grid=None,
                    rng=None, step=jnp.int32(0))
    tstate = SimState(field=FieldState.zeros(g), interpolator=None,
                      species=(SpeciesState.create("e", 0, -1.0, max_np),),
                      grid_arrays=None, materials=None,
                      step=torch.tensor(0, dtype=torch.int32))
    jinj = JInjector(sid=0, g=jg, origins=np.zeros((1, 1, 1, 3)))
    tinj = Injector(sid=0, g=g)
    rng = np.random.default_rng(4)
    K = 64
    for call in range(2):
        x = rng.uniform(0, 1.0, K)
        y = rng.uniform(0, 0.75, K)
        z = rng.uniform(0, 0.5, K)
        x[:4], y[4:6], x[6:8] = 1.0, 0.75, (-0.1, 1.2)
        args = dict(x=x, y=y, z=z, ux=rng.normal(0, 0.5, K),
                    uy=rng.normal(0, 0.5, K), uz=rng.normal(0, 0.5, K),
                    q=rng.uniform(-1, -0.5, K).astype(np.float32),
                    age=np.where(rng.uniform(size=K) < 0.3, 0.0,
                                 rng.uniform(size=K)).astype(np.float32),
                    tag=np.arange(K, dtype=np.int32) + 100 * call,
                    valid=rng.uniform(size=K) < 0.9)
        jstate, _, jf = jinj(jstate, None, jstate.field, **args)
        tstate, _, tf = tinj(tstate, None, tstate.field, **args)
        jstate = dataclasses.replace(jstate, field=jf)
        tstate = dataclasses.replace(tstate, field=tf)
    jsp, tsp = jstate.species[0], tstate.species[0]
    assert int(tsp.np) == int(jsp.np) > K
    for c in ("dx", "dy", "dz", "i", "ux", "uy", "uz", "q", "pc", "tag"):
        np.testing.assert_array_equal(getattr(tsp, c).numpy(),
                                      np.asarray(getattr(jsp, c)), err_msg=c)
    for c in ("mdx", "mdy", "mdz"):
        np.testing.assert_allclose(getattr(tsp, c).numpy(),
                                   np.asarray(getattr(jsp, c)), err_msg=c,
                                   **FLOATS)
    # the far x wall is owned (cell nx, offset 1), the far y wall is not
    i = tsp.i.numpy()
    assert (i[:4] >= 0).all() and (tsp.dx.numpy()[:4] == 1.0).all()
    assert (i[4:8] == -1).all() and (tsp.pc.numpy()[i < 0] == 0).all()
    live = i >= 0
    absw = aux.accumulate_rhob(FieldState.zeros(g), g, tsp.i.clamp(min=0),
                               tsp.q.abs(), tsp.dx, tsp.dy, tsp.dz,
                               torch.as_tensor(live)).rhob.numpy()
    assert (np.abs(tf.rhob.numpy() - np.asarray(jf.rhob))
            <= 1e-6 * absw + 1e-30).all()
    assert tf.rhob.numpy().min() == 0 and tf.rhob.numpy().max() > 0


def test_injection_past_max_np_is_counted():
    """24 lanes, 20 of them wanted, into 16 free slots: the 6 wanted lanes
    that do not fit are dropped, as in the JAX package, and counted as
    dropped movers; the 2 masked lanes past the cut are not."""
    kw = dict(nx=4, ny=4, nz=1, dt=0.05, gx1=1.0, gy1=1.0, gz1=0.25)
    g = Grid(**kw)
    state = SimState(field=FieldState.zeros(g), interpolator=None,
                     species=(SpeciesState.create("e", 0, -1.0, 16),),
                     grid_arrays=None, materials=None,
                     step=torch.tensor(0, dtype=torch.int32))
    K = 24
    rng = np.random.default_rng(6)
    valid = np.arange(K) % 6 != 5
    state, _, _ = Injector(sid=0, g=g)(
        state, None, state.field, x=rng.uniform(0, 1, K),
        y=rng.uniform(0, 1, K), z=0.1, ux=0.0, uy=0.0, uz=0.0, q=-0.01,
        valid=valid)
    sp = state.species[0]
    assert int(sp.np) == 16
    assert int(sp.nm) == int(valid[16:].sum()) == 6
    np.testing.assert_array_equal(sp.i.numpy() >= 0, valid[:16])


def gauss_rms(sim):
    """The rms div E error of the state (tests/test_inject.py:_gauss_rms)."""
    g, st = sim.grid, sim.state
    f = sfi.clear_rhof(st.field, g)
    for sp in st.species:
        f = aux.accumulate_rho_p(f, sp, g)
    f = sync.synchronize_rho(f, g, sim.comm)
    f = stencil.compute_div_e_err(f, g, st.materials, None, sim.comm)
    err, vol = stencil.local_rms_div_e_err(f, g)
    return float(stencil.finish_rms(g, err, vol))


def refluxing_box(K=16, update_rhob=True, age=True, npart=1024, cold=False):
    """tests/test_inject.py:_make_refluxing_deck: an 8^3 periodic box whose
    injection hook adds K lanes every step."""
    sim = Simulation(seed=3, device="cpu")
    sim.define_units(cvac=1.0, eps0=1.0)
    L, nx = 1.0, 8
    sim.define_timestep(0.95 * sim.courant_length(L, L, L, nx, nx, nx))
    sim.define_periodic_grid(0, 0, 0, L, L, L, nx, nx, nx)
    e = sim.define_species("electron", q_m=-1.0, max_np=8 * npart)
    ut = 0.0 if cold else 0.05
    sim.inject_particle(e, sim.uniform(npart, 0, L), sim.uniform(npart, 0, L),
                        sim.uniform(npart, 0, L), sim.maxwellian(npart, ut),
                        sim.maxwellian(npart, ut), sim.maxwellian(npart, ut),
                        q=-1.0 / npart)
    inj = sim.make_injector("electron")
    rng = np.random.default_rng(11)
    pos = rng.uniform(0.1, 0.9, size=(3, K))
    mom = rng.normal(0, 0.05, size=(3, K)).astype(np.float32)
    ages = rng.uniform(0, 1, size=K).astype(np.float32) if age else None

    def refill(state, acc, f):
        return inj(state, acc, f, x=pos[0], y=pos[1], z=pos[2], ux=mom[0],
                   uy=mom[1], uz=mom[2],
                   q=np.full(K, -1.0 / npart, np.float32), age=ages,
                   update_rhob=update_rhob)

    sim.finalize(user_particle_injection=refill)
    return sim


def test_injector_grows_np_and_keeps_gauss():
    """tests/test_inject.py:73: every step's K-block is claimed, and the
    rhob update keeps Gauss's law at float32 roundoff."""
    sim = refluxing_box()
    np0 = int(sim.state.species[0].np)
    sim.advance(6)
    assert int(sim.state.species[0].np) == np0 + 16 * 6
    assert gauss_rms(sim) < 5e-4
    assert all(np.isfinite(v) for v in sim.energies().values())
    assert sim.mover_counts() == {"electron": 0}


def test_injector_without_rhob_breaks_gauss():
    """tests/test_inject.py:89: the control, without the rhob update."""
    sim = refluxing_box(update_rhob=False, age=False, cold=True)
    sim.advance(6)
    assert gauss_rms(sim) > 5e-3


def test_injector_age_partial_push():
    """tests/test_inject.py:118: an aged lane moves age * u/gamma * c dt
    at once (through the step's boundary rounds), an unaged one stays at
    its injection point until the next push; the hook gates itself on the
    state's step, a device scalar."""
    sim = Simulation(seed=5, device="cpu")
    L, nx = 1.0, 8
    sim.define_units(cvac=1.0, eps0=1.0)
    sim.define_timestep(0.5 * sim.courant_length(L, L, L, nx, nx, nx))
    sim.define_periodic_grid(0, 0, 0, L, L, L, nx, nx, nx)
    sim.define_species("electron", q_m=-1.0, max_np=1024)
    inj = sim.make_injector("electron")
    ux = np.float32(0.3)

    def refill(state, acc, f):
        valid = torch.tensor([True, True]) & (state.step == 0)
        return inj(state, acc, f, x=np.array([0.3, 0.3]),
                   y=np.array([0.52, 0.52]), z=np.array([0.52, 0.52]),
                   ux=np.array([ux, ux]), uy=0.0, uz=0.0,
                   q=np.zeros(2, np.float32), age=torch.tensor([0.0, 1.0]),
                   valid=valid, update_rhob=False)

    sim.finalize(user_particle_injection=refill)
    sim.advance(1)
    sp = sim.state.species[0]
    g = sim.grid
    assert int(sp.np) == 2
    cx = sp.i.numpy()[:2] % g.nxg
    xg = sorted((cx - 1 + (sp.dx.numpy()[:2] + 1) / 2) * g.dx)
    np.testing.assert_allclose(xg[0], 0.3, rtol=0, atol=1e-6)
    expect = 0.3 + float(ux / np.sqrt(1 + ux * ux)) * g.cvac * g.dt
    np.testing.assert_allclose(xg[1], expect, rtol=1e-5)
    sim.advance(1)
    assert int(sim.state.species[0].np) == 2
