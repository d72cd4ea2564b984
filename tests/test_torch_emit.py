"""Surface and volume emitters of the port against the JAX package, on the
CPU (tests/test_boundary_emit.py): the component scans, the charge law of
each model and its threshold gate (exact: they do not depend on the random
draws), the emitted lanes' positions, momenta and ages (by statistics:
the port draws from its own random state), the emitters through the
port's step, and a restart.

The emitter box is tests/test_boundary_emit.py:_emitter_sim: 8x8 cells,
absorbing faces, a uniform ex = -0.1 that pulls electrons off the low x
face, 2 particles per emitting face.  Both packages start from the JAX
package's finalized state (``interop``) and call the emitter once.
"""


import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vpic_tpu.core.types import Grid as JGrid
from vpic_tpu.deck.api import Simulation as JSimulation
from vpic_tpu.emit import models as jemit

from vpic_tpu_torch import Simulation
from vpic_tpu_torch.core.types import SPECIES_COLUMNS, Grid, SpeciesState
from vpic_tpu_torch.emit import models as emit
from vpic_tpu_torch.interop import state_from_numpy, state_to_numpy
from vpic_tpu_torch.particles import push

from tests import torch_decks  # noqa: F401  (one torch thread)

MODELS = {"ChildLangmuir": 32.0 / 81.0, "Ccube": 1.0, "Ivory": 1.0 / 6.0}
EX, M = -0.1, 2


def emitter_box(cls, **kw):
    sim = cls(seed=3, **kw)
    sim.define_units(1.0, 1.0)
    L, nx = 1.0, 8
    sim.define_timestep(0.5 * sim.courant_length(L, L, L, nx, nx, 1))
    sim.define_absorbing_grid(0, 0, 0, L, L, L, nx, nx, 1)
    sim.define_species("electron", -1.0, 8192)
    sim.set_field("ex", lambda x, y, z: EX)
    return sim


def ref_qp(law_factor, g, q_m, e_x, m):
    """The charge law for an x face (tests/test_boundary_emit.py:_ref_qp):
    eps0 dy dz dt sqrt(F |q_m ex^3| / dx) / m, negated for q_m < 0."""
    qp = (g.eps0 * g.dy * g.dz * g.dt
          * np.sqrt(law_factor * abs(q_m * e_x ** 3) / g.dx) / m)
    return -qp if q_m < 0 else qp


@pytest.fixture(scope="module")
def boxes():
    jsim = emitter_box(JSimulation)
    jsim.finalize()
    tsim = emitter_box(Simulation, device="cpu")
    tsim.finalize()
    tsim.state = state_from_numpy(state_to_numpy(jsim.state),
                                  rng=tsim.state.rng)
    return jsim, tsim


def emit_once(boxes, name, thresh=0.0, m=M, face=0, jax_too=True):
    """One call of the model on the low x face in each package (the port
    only unless ``jax_too``): (JAX species, port species, port rhob
    gained)."""
    jsim, tsim = boxes
    comps = jemit.domain_face_components(jsim.grid, face)
    comps = (tuple(comps.tolist()), (face,) * len(comps))
    kw = dict(sid=0, q_m=-1.0, components=comps, n_emit_per_face=m,
              ut_para=0.05, ut_perp=0.05, thresh_e_norm=thresh)
    jm = getattr(jemit, name)(**kw).bind(jsim.grid)
    tm = getattr(emit, name)(**kw).bind(tsim.grid)
    js = (jm(jsim.state, jnp.zeros((jsim.grid.nv, 12)), jsim.state.field)[0]
          if jax_too else None)
    # the model writes the species' columns in place, as the step owns
    # them: hand it copies, so the fixture's state stays as it was
    st = tsim.state
    st = dataclasses.replace(st, species=tuple(
        sp.replace(**{c: getattr(sp, c).clone() for c in SPECIES_COLUMNS})
        for sp in st.species))
    ts, _, tf = tm(st, torch.zeros((tsim.grid.nv, 12)), st.field)
    return (js and js.species[0], ts.species[0],
            (tf.rhob - tsim.state.field.rhob).numpy())


def test_component_scans_match_jax():
    kw = dict(nx=8, ny=6, nz=4, gx1=1.0, gy1=0.75, gz1=0.5)
    jg, g = JGrid(**kw), Grid(**kw)
    regions = (lambda x, y, z: x < 0.5,
               lambda x, y, z: x < -0.01,
               lambda x, y, z: (x - 0.5) ** 2 + (y - 0.4) ** 2 < 0.05)
    for region in regions:
        for a, b in ((emit.region_surface_components(g, region),
                      jemit.region_surface_components(jg, region)),
                     (emit.region_volume_components(g, region),
                      jemit.region_volume_components(jg, region))):
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)
    for face in range(6):
        np.testing.assert_array_equal(emit.domain_face_components(g, face),
                                      jemit.domain_face_components(jg, face))


@pytest.mark.parametrize("name", list(MODELS))
def test_charge_law_matches_jax(boxes, name):
    jsp, tsp, drhob = emit_once(boxes, name)
    n = int(tsp.np)
    assert n == int(jsp.np) == 8 * M
    for c in ("i", "q", "pc"):
        np.testing.assert_array_equal(getattr(tsp, c).numpy(),
                                      np.asarray(getattr(jsp, c)),
                                      err_msg=c)
    q = tsp.q.numpy()[:n]
    np.testing.assert_allclose(q, ref_qp(MODELS[name], boxes[1].grid, -1.0,
                                         EX, M), rtol=1e-5)
    assert (tsp.pc.numpy()[:n] == push.PC_EXHAUSTED).all()
    # the emitted charge leaves the surface: rhob takes -q
    assert drhob.min() >= 0 and drhob.sum() > 0


def test_emission_past_max_np_is_counted():
    """16 lanes wanted into 10 free slots: the 6 that do not fit are
    dropped, as in the JAX package, and counted as dropped movers; a
    second call into the full species drops all 16."""
    tsim = emitter_box(Simulation, device="cpu")
    tsim.finalize()
    st = dataclasses.replace(tsim.state, species=(
        SpeciesState.create("electron", 0, -1.0, 10),))
    comps = emit.domain_face_components(tsim.grid, 0)
    model = emit.ChildLangmuir(
        sid=0, q_m=-1.0, components=(tuple(comps.tolist()),
                                     (0,) * len(comps)),
        n_emit_per_face=M, ut_para=0.05, ut_perp=0.05).bind(tsim.grid)
    acc = torch.zeros((tsim.grid.nv, 12))
    for calls, nm in ((1, 6), (2, 22)):
        st, acc, f = model(st, acc, st.field)
        st = dataclasses.replace(st, field=f)
        sp = st.species[0]
        assert (int(sp.np), int(sp.nm)) == (10, nm), calls
    assert (sp.i.numpy() >= 0).all()
    assert (sp.pc.numpy() == push.PC_EXHAUSTED).all()


def test_threshold_gate_matches_jax(boxes):
    """|E| = 0.1: a Ccube threshold of 0.2 stops emission, one of 0.05
    lets it through; ChildLangmuir has no threshold."""
    for name, thresh, emits in (("Ccube", 0.2, False), ("Ccube", 0.05, True),
                                ("Ivory", 0.2, False),
                                ("ChildLangmuir", 0.2, True)):
        jsp, tsp, _ = emit_once(boxes, name, thresh)
        np.testing.assert_array_equal(tsp.i.numpy(), np.asarray(jsp.i))
        assert int(tsp.np) == int(jsp.np) == (8 * M if emits else 0), name


def test_emitted_lanes_statistics(boxes):
    """256 lanes per face: on the face (dx = -1 exactly), uniform across
    it, the normal momentum |N(0, ut_para)| into the domain, the tangential
    ones N(0, ut_perp), the age uniform in [0, 1), within 5 sigma."""
    m = 256
    _, sp, _ = emit_once(boxes, "ChildLangmuir", m=m, jax_too=False)
    g = boxes[1].grid
    n = int(sp.np)
    assert n == 8 * m
    col = lambda c: getattr(sp, c)[:n].double().numpy()
    assert (col("dx") == -1.0).all()
    for c in ("dy", "dz"):
        assert abs(col(c).mean()) < 5 * np.sqrt(1 / 3 / n)
        assert col(c).min() >= -1 and col(c).max() < 1
    ux, uy, uz = col("ux"), col("uy"), col("uz")
    assert (ux >= 0).all()
    assert abs(ux.mean() - 0.05 * np.sqrt(2 / np.pi)) < 5 * 0.05 * np.sqrt(
        (1 - 2 / np.pi) / n)
    for u in (uy, uz):
        assert abs(u.mean()) < 5 * 0.05 / np.sqrt(n)
        assert abs(u.var() / 0.05 ** 2 - 1) < 5 * np.sqrt(2 / n)
    gamma = np.sqrt(1 + ux * ux + uy * uy + uz * uz)
    age = col("mdx") * gamma / (ux * g.cvac * g.dt * g.rdx)
    assert age.min() >= 0 and age.max() < 1 + 1e-5
    assert abs(age.mean() - 0.5) < 5 * np.sqrt(1 / 12 / n)


@pytest.mark.parametrize("name", list(MODELS))
def test_emitter_through_the_step(name):
    """define_surface_emitter and one step: the emitted lanes are walked
    by the step's boundary rounds (none pending, none dropped) and carry
    the law's charge (tests/test_boundary_emit.py:112)."""
    sim = emitter_box(Simulation, device="cpu")
    model = getattr(emit, name)(sid=0, q_m=-1.0, components=((), ()),
                                n_emit_per_face=M, ut_para=0.05,
                                ut_perp=0.05)
    sim.define_surface_emitter(model, face=0)
    sim.finalize()
    assert int(sim.state.species[0].alive.sum()) == 0
    sim.advance(1)
    sp = sim.state.species[0]
    alive = sp.alive
    assert int(alive.sum()) == 8 * M
    assert (sp.pc == 0).all() and sim.mover_counts() == {"electron": 0}
    np.testing.assert_allclose(sp.q[alive].numpy(), ref_qp(
        MODELS[name], sim.grid, -1.0, EX, M), rtol=1e-5)
    # walked off the face into the first cells
    assert (sp.dx[alive] > -1).all()


def test_volume_emitter_components_and_face_skip():
    """tests/test_boundary_emit.py:151: face-less components, which the
    face laws skip."""
    sim = emitter_box(Simulation, device="cpu")
    model = emit.Ccube(sid=0, q_m=-1.0, components=((), ()),
                       n_emit_per_face=2)
    reg = sim.define_volume_emitter(model, lambda x, y, z: x < 0.5)
    vox, faces = reg.components
    assert len(vox) == 4 * 8 and set(faces) == {-1}
    sim.finalize()
    sim.advance(2)
    assert int(sim.state.species[0].alive.sum()) == 0


def test_emitter_restart_is_bitwise(tmp_path):
    """3 steps, a checkpoint, 3 more; restored and run 3 steps, every
    array of the state repeats bit for bit (the random state too)."""
    def build():
        sim = emitter_box(Simulation, device="cpu")
        sim.define_surface_emitter(emit.ChildLangmuir(
            sid=0, q_m=-1.0, components=((), ()), n_emit_per_face=M,
            ut_para=0.05, ut_perp=0.05), face=0)
        sim.finalize()
        return sim

    sim = build()
    sim.advance(3)
    sim.checkpoint(tmp_path / "ck")
    sim.advance(3)
    first = state_to_numpy(sim.state)
    other = build()
    other.restore(tmp_path / "ck")
    other.advance(3)
    second = state_to_numpy(other.state)
    assert int(first["species/0/np"]) > 0
    for k, v in first.items():
        np.testing.assert_array_equal(np.asarray(second[k]), np.asarray(v),
                                      err_msg=k)
