"""The port's materials (per-voxel material ids and conductive, dielectric
and magnetic regions) against the JAX package, on inputs made from numpy
seeds and fed through both packages.

- ``build_material_table``: bitwise the JAX table for vacuum, copper, an
  anisotropic eps/mu/sigma material and a conductor so strong that its
  decay underflows to 0.
- The eight id grids: bitwise for overlapping regions on 2D and 3D grids.
- The material stencils (advance_e, compute_curl_b, compute_div_e_err,
  clean_div_e, compute_rhob, local_energy_f) on random fields and random
  ids over three materials, ghost planes included: fields to rtol 2e-6,
  atol 1e-6 (as tests/test_torch_fields.py), energies to rtol 1e-12.
- tests/test_materials_diag.py:wave_box(conductor=True) in both packages
  (ids equal, fields to that tolerance and energies to 1e-6 after 20
  steps) and its bar, the copper run's E energy below 0.75 of vacuum's.
- A 3D plasma with three materials and an interval div-E clean, 10 steps
  on the port's three push paths against the JAX package: energies to
  1e-6, particles as sets and fields to 1e-5 (tests/test_torch_slice.py).
- A dielectric on the low x seam (the ghost planes keep material 0 in
  both packages); a deck with materials and no region.
- dump_fields bytes and dump_materials text equal to the JAX package's,
  the ids read back; a bitwise checkpoint restart; a vacuum checkpoint
  loads with no material grid; interop round trips, and a JAX state with
  materials carried across computes what the JAX package computes.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import vpic_tpu
from vpic_tpu.comm.facecomm import LocalComm as JComm
from vpic_tpu.core.types import (FieldState as JField, Grid as JGrid,
                                 MaterialGrid as JMaterialGrid)
from vpic_tpu.deck import api as japi
from vpic_tpu.field import stencil as jstencil
from vpic_tpu.io import dump as jdump

import vpic_tpu_torch
from vpic_tpu_torch.comm.facecomm import LocalComm
from vpic_tpu_torch.core import random as rnd
from vpic_tpu_torch.core.types import (FIELD_COMPONENTS, MATERIAL_COLUMNS,
                                       MATERIAL_ID_FIELDS, FieldState, Grid,
                                       MaterialGrid, PERIODIC_FIELDS)
from vpic_tpu_torch.deck import api as tapi
from vpic_tpu_torch.field import stencil
from vpic_tpu_torch.interop import state_from_numpy, state_to_numpy
from vpic_tpu_torch.io import readers

from tests import torch_decks  # noqa: F401  (one torch thread)
from tests.test_materials_diag import wave_box

TOL = dict(rtol=2e-6, atol=1e-6)
SHAPES = {"3d": (6, 5, 4), "2d": (8, 8, 1)}
# (name, eps, mu, sigma): vacuum, copper, an anisotropic material, and a
# conductor whose a = sigma dt / eps is so large that exp(-a) is 0
MATERIALS = (("vacuum", 1.0, 1.0, 0.0), ("copper", 1.0, 1.0, 5.0),
             ("aniso", (2.0, 3.0, 4.0), (1.5, 1.0, 2.0), (0.0, 2.0, 0.5)),
             ("wall", 1.0, 1.0, 1e5))


def grids(shape, dt=0.04):
    nx, ny, nz = SHAPES[shape]
    kw = dict(nx=nx, ny=ny, nz=nz, dt=dt, cvac=1.0, eps0=1.0, gx1=1.0,
              gy1=1.0, gz1=1.0, fbc=(PERIODIC_FIELDS,) * 6,
              pbc=(PERIODIC_FIELDS,) * 6)
    return JGrid(**kw), Grid(**kw)


def tables(specs, jg, g):
    """The material tables of ``specs`` in both packages."""
    def mats(mod):
        return [mod._Material(name, i, *mod._as3(eps), *mod._as3(mu),
                              *mod._as3(sigma), 0.0, 0.0, 0.0)
                for i, (name, eps, mu, sigma) in enumerate(specs)]
    return (japi.build_material_table(mats(japi), jg),
            tapi.build_material_table(mats(tapi), g))


@pytest.mark.parametrize("k", range(len(MATERIALS)),
                         ids=[m[0] for m in MATERIALS])
def test_material_table_is_bitwise_jax(k):
    jg, g = grids("3d")
    jt, tt = tables(MATERIALS[:k + 1], jg, g)
    for c in MATERIAL_COLUMNS:
        a, b = getattr(tt, c).numpy(), np.asarray(getattr(jt, c))
        assert a.dtype == b.dtype == np.float32, c
        np.testing.assert_array_equal(a, b, err_msg=c)
    if MATERIALS[k][0] == "wall":
        assert tt.decayx[k] == 0 and tt.drivex[k] == 0
        assert tt.nonconductive[k] == 0
    if MATERIALS[k][0] == "vacuum":
        assert all(getattr(tt, c)[0] == 1 for c in MATERIAL_COLUMNS)


def regions(pkg, shape, **kw):
    """A field-free deck of ``SHAPES[shape]`` with three overlapping
    regions over four materials (a later region wins)."""
    nx, ny, nz = SHAPES[shape]
    sim = pkg.Simulation(seed=0, **kw)
    sim.define_units(1.0, 1.0)
    sim.define_timestep(0.5 * sim.courant_length(1, 1, 1, nx, ny, nz))
    sim.define_periodic_grid(0, 0, 0, 1.0, 1.0, 1.0, nx, ny, nz)
    mats = [sim.define_material(name, eps=eps, mu=mu, sigma=sigma)
            for name, eps, mu, sigma in MATERIALS]
    sim.set_region_material(lambda x, y, z: x > 0.5, mats[1])
    sim.set_region_material(lambda x, y, z: (y > 0.3) & (y < 0.7), mats[2])
    sim.set_region_material(lambda x, y, z: (x - 0.5) ** 2 + (z - 0.5) ** 2
                            < 0.1, mats[3])
    sim.set_field("ey", lambda x, y, z: 0.1 * np.sin(2 * np.pi * x))
    sim.finalize()
    return sim


@pytest.mark.parametrize("shape", list(SHAPES))
def test_id_grids_are_bitwise_jax(shape):
    j = state_to_numpy(regions(vpic_tpu, shape).state)
    t = state_to_numpy(regions(vpic_tpu_torch, shape, device="cpu").state)
    for k in MATERIAL_ID_FIELDS:
        a, b = t[f"material_grid/{k}"], j[f"material_grid/{k}"]
        assert a.dtype == b.dtype == np.int32, k
        np.testing.assert_array_equal(a, b, err_msg=k)
    # every material owns some points, and the ghost planes keep 0
    ids = t["material_grid/cmat"]
    assert set(np.unique(ids[1:-1, 1:-1, 1:-1])) == {0, 1, 2, 3}
    assert not ids[0].any() and not ids[:, :, 0].any()
    for c in FIELD_COMPONENTS:
        np.testing.assert_allclose(t[f"field/{c}"], j[f"field/{c}"],
                                   err_msg=c, **TOL)


def random_case(shape):
    """Random fields and random ids over three materials (vacuum, copper,
    the anisotropic one) on every point, ghost planes included."""
    jg, g = grids(shape)
    jt, tt = tables(MATERIALS[:3], jg, g)
    rng = np.random.default_rng(7)
    arrays = {k: rng.normal(size=g.shape).astype(np.float32)
              for k in FIELD_COMPONENTS}
    ids = {k: rng.integers(0, 3, size=g.shape).astype(np.int32)
           for k in MATERIAL_ID_FIELDS}
    jf = JField(**{k: jnp.asarray(v) for k, v in arrays.items()})
    f = FieldState(**{k: torch.as_tensor(v) for k, v in arrays.items()})
    jm = JMaterialGrid(**{k: jnp.asarray(v) for k, v in ids.items()})
    tm = MaterialGrid(**{k: torch.as_tensor(v) for k, v in ids.items()})
    return (jg, jf, jt, jm), (g, f, tt, tm)


STENCILS = {
    "advance_e": lambda s, f, g, t, m, comm: s.advance_e(f, g, t, m, comm),
    "compute_curl_b": lambda s, f, g, t, m, comm: s.compute_curl_b(
        f, g, t, m, comm),
    "compute_div_e_err": lambda s, f, g, t, m, comm: s.compute_div_e_err(
        f, g, t, m, comm),
    "clean_div_e": lambda s, f, g, t, m, comm: s.clean_div_e(f, g, t, m),
    "compute_rhob": lambda s, f, g, t, m, comm: s.compute_rhob(
        f, g, t, m, comm),
}


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("name", list(STENCILS))
def test_material_stencil_matches_jax(name, shape):
    (jg, jf, jt, jm), (g, f, tt, tm) = random_case(shape)
    jout = STENCILS[name](jstencil, jf, jg, jt, jm, JComm(jg))
    out = STENCILS[name](stencil, f, g, tt, tm, LocalComm(g))
    for c in FIELD_COMPONENTS:
        np.testing.assert_allclose(getattr(out, c).numpy(),
                                   np.asarray(getattr(jout, c)), err_msg=c,
                                   **TOL)
    # the materials change the result: the vacuum stencil gives another
    vac = STENCILS[name](stencil, f, g, tt, None, LocalComm(g))
    assert any(not torch.equal(getattr(vac, c), getattr(out, c))
               for c in FIELD_COMPONENTS)


@pytest.mark.parametrize("shape", list(SHAPES))
def test_material_energy_matches_jax(shape):
    (jg, jf, jt, jm), (g, f, tt, tm) = random_case(shape)
    en = stencil.local_energy_f(f, g, tt, tm)
    jen = jstencil.local_energy_f(jf, jg, jt, jm)
    np.testing.assert_allclose(en.numpy(), np.asarray(jen), rtol=1e-12)
    assert not torch.equal(en, stencil.local_energy_f(f, g, tt, None))


def port_wave_box(conductor=False, nx=16, seed=4, region=None, clean=0):
    """tests/test_materials_diag.py:wave_box for the port (on the CPU);
    ``region``: a dielectric (eps 2, 3, 4, mu 1.5) there instead of the
    copper; ``clean``: the div-E clean interval."""
    return _wave_box(vpic_tpu_torch, conductor, nx, seed, region, clean,
                     device="cpu")


def _wave_box(pkg, conductor, nx, seed, region, clean, **kw):
    sim = pkg.Simulation(seed=seed, **kw)
    sim.define_units(1.0, 1.0)
    L = 1.0
    sim.define_timestep(0.6 * sim.courant_length(L, L, L, nx, nx, 1))
    sim.define_periodic_grid(0, 0, 0, L, L, L, nx, nx, 1)
    sim.define_material("vacuum")
    if conductor:
        copper = sim.define_material("copper", eps=1.0, sigma=5.0)
        sim.set_region_material(lambda x, y, z: x > 0.5, copper)
    if region is not None:
        diel = sim.define_material("dielectric", eps=(2.0, 3.0, 4.0),
                                   mu=1.5)
        sim.set_region_material(region, diel)
    sim.set_field("ey", lambda x, y, z: 0.1 * np.sin(2 * np.pi * x))
    sim.set_field("cbz", lambda x, y, z: 0.1 * np.sin(2 * np.pi * x))
    if clean:
        sim.opts = dataclasses.replace(sim.opts, clean_div_e_interval=clean)
    sim.finalize()
    return sim


def same_state(t, j, atol=None):
    """Ids bitwise; fields to TOL (or to ``atol`` absolute)."""
    for k in MATERIAL_ID_FIELDS:
        np.testing.assert_array_equal(t[f"material_grid/{k}"],
                                      j[f"material_grid/{k}"], err_msg=k)
    tol = TOL if atol is None else dict(rtol=0, atol=atol)
    for c in FIELD_COMPONENTS:
        np.testing.assert_allclose(t[f"field/{c}"], j[f"field/{c}"],
                                   err_msg=c, **tol)


def same_energies(te, je):
    for k, v in je.items():
        np.testing.assert_allclose(te[k], v, rtol=1e-6, atol=1e-12,
                                   err_msg=k)


def test_wave_box_conductor_matches_jax_and_damps():
    j, t = wave_box(conductor=True), port_wave_box(conductor=True)
    assert t.state.material_grid is not None
    same_state(state_to_numpy(t.state), state_to_numpy(j.state))
    j.advance(20)
    t.advance(20)
    same_state(state_to_numpy(t.state), state_to_numpy(j.state))
    same_energies(t.energies(), j.energies())
    v = port_wave_box(conductor=False)
    v.advance(20)
    ev = sum(v.energies()[k] for k in ("ex", "ey", "ez"))
    ec = sum(t.energies()[k] for k in ("ex", "ey", "ez"))
    assert np.isfinite(ec) and ec < 0.75 * ev


def test_low_seam_dielectric_matches_jax():
    """A dielectric on x < 0.25 touches the periodic low x seam.  The
    ghost planes keep material 0 in both packages, so the backward
    differences there read vacuum's eps and rmu, and the node ids at
    index 0 are 0: rhob and div_e_err at the seam follow from that, in
    both alike, through an interval clean."""
    kw = dict(conductor=False, nx=16, seed=4, region=lambda x, y, z:
              x < 0.25, clean=5)
    j = _wave_box(vpic_tpu, **kw)
    t = _wave_box(vpic_tpu_torch, device="cpu", **kw)
    d = state_to_numpy(t.state)
    ematy = d["material_grid/ematy"]
    assert (ematy[1, 1:-1, 1] == 1).all() and not ematy[:, :, 0].any()
    same_state(d, state_to_numpy(j.state))
    assert np.abs(d["field/rhob"][1, :, 1]).max() > 0
    j.advance(20)
    t.advance(20)
    same_state(state_to_numpy(t.state), state_to_numpy(j.state))
    same_energies(t.energies(), j.energies())


def test_magnetic_material_across_a_periodic_seam():
    """The ghost planes keep material 0 in both packages.  A magnetic
    material (mu 1.5) over the whole of the 16^2 wave box then meets
    vacuum's rmu at the periodic seams, where the backward differences of
    cB*rmu read the ghost faces: the field energy grows by more than 1e4
    in 24 steps, in both packages alike (energies to 1e-6).  With the
    ghost ids set to their periodic images (id 1 everywhere) it stays
    within 1e-2 of its start."""
    def deck(pkg, **kw):
        sim = pkg.Simulation(seed=4, **kw)
        sim.define_units(1.0, 1.0)
        sim.define_timestep(0.9 * sim.courant_length(1, 1, 1, 16, 16, 1))
        sim.define_periodic_grid(0, 0, 0, 1.0, 1.0, 1.0, 16, 16, 1)
        sim.define_material("vacuum")
        mag = sim.define_material("magnetic", mu=1.5)
        sim.set_region_material(lambda x, y, z: x < 2.0, mag)
        sim.set_field("ey", lambda x, y, z: 0.1 * np.sin(2 * np.pi * x))
        sim.set_field("cbz", lambda x, y, z: 0.1 * np.sin(2 * np.pi * x))
        sim.finalize()
        return sim
    total = lambda sim: sum(sim.energies().values())
    j, t, filled = deck(vpic_tpu), *(deck(vpic_tpu_torch, device="cpu")
                                     for _ in range(2))
    mg = filled.state.material_grid
    assert not mg.fmatx[:, :, 0].any()
    filled.state = dataclasses.replace(filled.state, material_grid=(
        MaterialGrid(**{k: torch.ones_like(getattr(mg, k))
                        for k in MATERIAL_ID_FIELDS})))
    e0 = total(t)
    for sim in (j, t, filled):
        sim.advance(24)
    same_energies(t.energies(), j.energies())
    assert total(t) > 1e4 * e0
    assert abs(total(filled) / e0 - 1) < 1e-2


def test_materials_without_a_region_use_row_0():
    """A deck whose material 0 is copper and which assigns no region: no
    material grid, and every coefficient is table row 0 (copper's), in
    both packages."""
    def deck(pkg, **kw):
        sim = pkg.Simulation(seed=4, **kw)
        sim.define_units(1.0, 1.0)
        sim.define_timestep(0.6 * sim.courant_length(1, 1, 1, 16, 16, 1))
        sim.define_periodic_grid(0, 0, 0, 1.0, 1.0, 1.0, 16, 16, 1)
        sim.define_material("copper", sigma=5.0)
        sim.define_material("vacuum")
        sim.set_field("ey", lambda x, y, z: 0.1 * np.sin(2 * np.pi * x))
        sim.finalize()
        return sim
    j, t = deck(vpic_tpu), deck(vpic_tpu_torch, device="cpu")
    assert t.state.material_grid is None and j.state.material_grid is None
    assert float(t.state.materials.decayy[0]) < 1.0
    e0 = t.energies()["ey"]
    j.advance(10)
    t.advance(10)
    same_energies(t.energies(), j.energies())
    assert t.energies()["ey"] < 0.9 * e0


STEPS = 10
CLEAN = dict(clean_div_e_interval=2)
PATHS = {"fused": {}, "unfused": dict(fused_push=False),
         "merge_sort": dict(merge_sort=True)}


def plasma(pkg, opts, **kw):
    """A 6x5x4 periodic box with 2000 electrons and 2000 ions (numpy seed
    3) and a standing wave, over vacuum, copper on x > 0.6 and the
    anisotropic material on y < 0.4 (which wins where they overlap)."""
    sim = pkg.Simulation(seed=0, **kw)
    sim.define_units(1.0, 1.0)
    nx, ny, nz = SHAPES["3d"]
    sim.define_timestep(0.9 * sim.courant_length(1.0, 1.0, 1.0, nx, ny, nz))
    sim.define_periodic_grid(0, 0, 0, 1.0, 1.0, 1.0, nx, ny, nz)
    sim.define_material("vacuum")
    copper = sim.define_material("copper", sigma=5.0)
    aniso = sim.define_material("aniso", eps=(2.0, 3.0, 4.0),
                                mu=(1.5, 1.0, 2.0), sigma=(0.0, 2.0, 0.5))
    sim.set_region_material(lambda x, y, z: x > 0.6, copper)
    sim.set_region_material(lambda x, y, z: y < 0.4, aniso)
    n = 2000
    rng = np.random.default_rng(3)
    x, y, z = (rng.uniform(0, 1.0, n) for _ in range(3))
    for name, q_m, sgn, ut in (("electron", -1.0, -1.0, 0.15),
                               ("ion", 1.0 / 25.0, 1.0, 0.03)):
        sp = sim.define_species(name, q_m, 2 * n)
        sim.inject_particle(sp, x, y, z, *(rng.normal(0, ut, n)
                                           for _ in range(3)), q=sgn / n)
    for comp, (a, b) in dict(ex=(1, 2), ey=(2, 0), ez=(0, 1), cbx=(1, 2),
                             cby=(2, 0), cbz=(0, 1)).items():
        sim.set_field(comp, lambda *p, a=a, b=b: 0.05 * np.sin(
            2 * np.pi * p[a]) * np.cos(2 * np.pi * p[b]))
    sim.opts = dataclasses.replace(sim.opts, **opts)
    sim.finalize()
    return sim


@pytest.fixture(scope="module")
def jax_plasma():
    sim = plasma(vpic_tpu, CLEAN)
    d0 = state_to_numpy(sim.state)
    sim.advance(STEPS)
    return dict(d0=d0, d1=state_to_numpy(sim.state), e=sim.energies(),
                nm=sim.mover_counts())


def sorted_particles(d, k):
    pre = f"species/{k}/"
    n = int(d[pre + "np"])
    cols = {c: d[pre + c][:n] for c in ("i", "dx", "dy", "dz", "ux", "uy",
                                         "uz", "q")}
    order = np.lexsort((cols["dz"], cols["dy"], cols["dx"], cols["i"]))
    return {c: v[order] for c, v in cols.items()}


@pytest.mark.parametrize("path", list(PATHS))
def test_plasma_with_materials_matches_jax(jax_plasma, path):
    sim = plasma(vpic_tpu_torch, dict(CLEAN, **PATHS[path]), device="cpu")
    same_state(state_to_numpy(sim.state), jax_plasma["d0"], atol=1e-5)
    sim.advance(STEPS)
    d = state_to_numpy(sim.state)
    same_energies(sim.energies(), jax_plasma["e"])
    assert sim.mover_counts() == jax_plasma["nm"]
    same_state(d, jax_plasma["d1"], atol=1e-5)
    for k in range(2):
        t, j = sorted_particles(d, k), sorted_particles(jax_plasma["d1"], k)
        np.testing.assert_array_equal(t["i"], j["i"])
        for c in ("dx", "dy", "dz", "ux", "uy", "uz", "q"):
            np.testing.assert_allclose(t[c], j[c], rtol=0, atol=1e-5,
                                       err_msg=c)
    # inside copper, away from the periodic seams that sync node planes
    # with the other side, div_e_err and rhob are 0
    inside = np.zeros(d["field/rhob"].shape, bool)
    inside[2:-2, 2:-2, 2:-2] = d["material_grid/nmat"][2:-2, 2:-2, 2:-2] == 1
    assert inside.any() and not d["field/div_e_err"][inside].any()
    assert not d["field/rhob"][inside].any()


def test_dump_fields_bytes_and_ids_match_jax(tmp_path):
    j = regions(vpic_tpu, "3d")
    t = regions(vpic_tpu_torch, "3d", device="cpu")
    # one state in both packages
    t.state = state_from_numpy(state_to_numpy(j.state), rng=rnd.make_key(0))
    jp = jdump.dump_fields(j.state, j.grid, str(tmp_path / "j"), 0)
    tp, = t.dump_fields(str(tmp_path / "t"))
    assert tp.read_bytes() == jp.read_bytes()
    _, out = readers.read_fields(tp)
    ids = out["materials"]
    assert ids.dtype == np.uint16
    for k, name in enumerate(MATERIAL_ID_FIELDS):
        np.testing.assert_array_equal(
            ids[..., k], getattr(t.state.material_grid, name).numpy(),
            err_msg=name)
    assert ids.any()


def test_dump_materials_text_matches_jax(tmp_path):
    j = regions(vpic_tpu, "2d")
    t = regions(vpic_tpu_torch, "2d", device="cpu")
    j.dump_materials(str(tmp_path / "j"))
    t.dump_materials(str(tmp_path / "t"))
    text = (tmp_path / "t").read_text()
    assert text == (tmp_path / "j").read_text()
    assert text.count("\n") == 5 * len(MATERIALS)


def test_checkpoint_restart_with_materials_is_bitwise(tmp_path):
    a = plasma(vpic_tpu_torch, CLEAN, device="cpu")
    a.advance(3)
    a.checkpoint(tmp_path / "ck")
    a.advance(4)
    first = state_to_numpy(a.state)
    with np.load(str(tmp_path / "ck") + ".npz") as data:
        assert data["material_grid/fmatx"].dtype == np.int32
    b = plasma(vpic_tpu_torch, CLEAN, device="cpu")
    b.restore(tmp_path / "ck")
    assert b.step_count == 3
    b.advance(4)
    second = state_to_numpy(b.state)
    assert set(first) == set(second)
    for k, v in first.items():
        v, w = np.asarray(v), np.asarray(second[k])
        assert v.dtype == w.dtype and v.tobytes() == w.tobytes(), k


def test_vacuum_checkpoint_loads_without_a_material_grid(tmp_path):
    """A deck with one vacuum material writes the checkpoint it wrote
    before materials were ported (no material_grid arrays); it loads with
    no material grid, and a deck with regions refuses it."""
    a = port_wave_box()
    a.checkpoint(tmp_path / "ck")
    with np.load(str(tmp_path / "ck") + ".npz") as data:
        assert not any(k.startswith("material_grid/") for k in data.files)
    b = port_wave_box()
    b.restore(tmp_path / "ck")
    assert b.state.material_grid is None
    with pytest.raises(ValueError, match="arrays"):
        port_wave_box(conductor=True).restore(tmp_path / "ck")


def test_interop_round_trip_keeps_the_material_grid():
    t = plasma(vpic_tpu_torch, CLEAN, device="cpu")
    d = state_to_numpy(t.state)
    back = state_to_numpy(state_from_numpy(d))
    assert set(back) == set(d)
    for k in MATERIAL_ID_FIELDS:
        v = back[f"material_grid/{k}"]
        assert v.dtype == np.int32
        np.testing.assert_array_equal(v, d[f"material_grid/{k}"])


def test_jax_material_state_carried_across():
    """The JAX package's plasma with materials, loaded into the port after
    finalize, runs STEPS steps to the JAX package's energies and fields."""
    j = plasma(vpic_tpu, CLEAN)
    t = plasma(vpic_tpu_torch, CLEAN, device="cpu")
    t.state = state_from_numpy(state_to_numpy(j.state),
                               rng=rnd.make_key(0))
    assert isinstance(t.state.material_grid, MaterialGrid)
    j.advance(STEPS)
    t.advance(STEPS)
    same_energies(t.energies(), j.energies())
    same_state(state_to_numpy(t.state), state_to_numpy(j.state), atol=1e-5)
