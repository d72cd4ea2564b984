"""Open particle boundaries of the port against the JAX package, on the
CPU: the compaction of the boundary rounds, the rhob deposit, one
boundary round on an absorbing face and on each custom handler, the
handlers' states, the link ring's file, the drifting box of
tests/test_boundary_emit.py for 12 steps, and what the port's deck API
keeps across ``modify_runparams`` and a checkpoint.

Both packages start from one state (``interop``) or from the same numpy
arrays.  Bars (ROADMAP "Parity bar", tests/test_torch_push.py): voxels,
codes, counts and rings exact; particle floats rtol 4e-6, atol 1e-6; the
accumulator rtol 1e-5, atol 1e-6; rhob within 1e-6 of the summed |weight|
per node (the port sums in fixed point, the JAX package in float32);
energies 1e-6 relative.  The reflux handler's arithmetic is fed the JAX
package's draws; its own draws are held by statistics and, since the
port draws the JAX package's threefry stream, value for value: one round
and the drifting box with reflux walls for 12 steps from the JAX
package's state and key.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vpic_tpu.boundary import models as jmodels
from vpic_tpu.core.types import (Grid as JGrid, SpeciesState as JSpecies,
                                 FieldState as JField)
from vpic_tpu.deck.api import Simulation as JSimulation
from vpic_tpu.particles import aux as jaux
from vpic_tpu.particles import boundary as jboundary
from vpic_tpu.particles import push as jpush

from vpic_tpu_torch import Simulation
from vpic_tpu_torch.boundary import models
from vpic_tpu_torch.core import random as rnd
from vpic_tpu_torch.core.types import (FieldState, Grid, NEIGHBOR_ABSORB,
                                       PERIODIC_FIELDS, SpeciesState)
from vpic_tpu_torch.grid.partition import build_neighbor_table
from vpic_tpu_torch.interop import state_from_numpy, state_to_numpy
from vpic_tpu_torch.particles import aux, boundary, push

from tests import torch_decks  # noqa: F401  (one torch thread)

FLOATS = dict(rtol=4e-6, atol=1e-6)
ACC = dict(rtol=1e-5, atol=1e-6)
STEPS = 12
COLS = ("dx", "dy", "dz", "i", "ux", "uy", "uz", "q", "mdx", "mdy", "mdz",
        "pc", "tag")


def drifting_box(cls, handler=None, seed=2, nx=8, ut=0.3, drift=0.5,
                 **kw):
    """tests/test_boundary_emit.py:drifting_box in either package: x faces
    absorbing (or ``handler`` on the low face), y and z periodic."""
    sim = cls(seed=seed, **kw)
    sim.define_units(1.0, 1.0)
    L = 1.0
    sim.define_timestep(0.7 * sim.courant_length(L, L, L, nx, nx, 1))
    sim.define_absorbing_grid(0, 0, 0, L, L, L, nx, nx, 1)
    for face in (1, 2, 4, 5):
        sim.set_domain_field_bc(face, PERIODIC_FIELDS)
        sim.set_domain_particle_bc(face, "periodic")
    e = sim.define_species("electron", -1.0, 4096)
    n = 512
    sim.inject_particle(
        e, sim.uniform(n, 0.05, 0.95), sim.uniform(n, 0, L),
        sim.uniform(n, 0, L),
        sim.maxwellian(n, ut) + drift, sim.maxwellian(n, ut),
        sim.maxwellian(n, ut), q=-1.0 / n)
    if handler is not None:
        h = sim.define_boundary(handler)
        sim.set_domain_particle_bc(0, h)
    return sim


def alive(sp):
    return int(np.asarray(sp.alive).sum())


@pytest.fixture(scope="module")
def box_runs():
    """The drifting box with a tally on the low x face and plain
    absorption on the high one, 12 steps in each package from the JAX
    package's finalized state."""
    jsim = drifting_box(JSimulation, jmodels.AbsorbTally(n_species=1))
    jsim.finalize()
    tsim = drifting_box(Simulation, models.AbsorbTally(n_species=1),
                        device="cpu")
    tsim.finalize()
    d0 = state_to_numpy(jsim.state)
    tsim.state = state_from_numpy(d0, rng=tsim.state.rng)
    out = dict(n0=alive(jsim.state.species[0]), d0=d0,
               je0=jsim.energies(), te0=tsim.energies())
    jsim.advance(STEPS)
    tsim.advance(STEPS)
    out.update(jalive=alive(jsim.state.species[0]),
               talive=alive(tsim.state.species[0]),
               jtally=np.asarray(jsim.state.boundary_state[0]),
               ttally=tsim.boundary_tallies(0), je=jsim.energies(),
               te=tsim.energies(), jnm=jsim.mover_counts(),
               tnm=tsim.mover_counts(), j1=state_to_numpy(jsim.state),
               t1=state_to_numpy(tsim.state), tsim=tsim)
    return out


def test_drifting_box_counts_match_jax(box_runs):
    r = box_runs
    assert r["talive"] == r["jalive"] < r["n0"]
    np.testing.assert_array_equal(r["ttally"], r["jtally"])
    # the high face absorbs without a tally
    assert 0 < int(r["ttally"][0]) < r["n0"] - r["talive"]
    assert r["tnm"] == r["jnm"] == {"electron": 0}


def test_drifting_box_energies_match_jax(box_runs):
    r = box_runs
    for key in ("je0", "je"):
        for name, e in r[key].items():
            np.testing.assert_allclose(r["t" + key[1:]][name], e, rtol=1e-6,
                                       atol=1e-12, err_msg=f"{key} {name}")


def test_drifting_box_particles_match_jax(box_runs):
    """The live lanes as sets ordered by (voxel, position), and the
    absorbed electrons' charge that rhob gained, negative, to 1e-5 as the
    positions (the lanes it came from moved as theirs do)."""
    keys = {}
    for side in ("j1", "t1"):
        d = box_runs[side]
        live = (np.arange(4096) < int(d["species/0/np"])) & (
            d["species/0/i"] >= 0)
        cols = {c: d[f"species/0/{c}"][live] for c in ("i", "dx", "dy", "dz",
                                                       "ux", "uy", "uz")}
        order = np.lexsort((cols["dz"], cols["dy"], cols["dx"], cols["i"]))
        keys[side] = {c: v[order] for c, v in cols.items()}
    np.testing.assert_array_equal(keys["t1"]["i"], keys["j1"]["i"])
    for c in ("dx", "dy", "dz", "ux", "uy", "uz"):
        np.testing.assert_allclose(keys["t1"][c], keys["j1"][c], rtol=0,
                                   atol=1e-5, err_msg=c)
    d0 = box_runs["d0"]["field/rhob"]
    jr = box_runs["j1"]["field/rhob"] - d0
    tr = box_runs["t1"]["field/rhob"] - d0
    assert tr.min() < 0
    np.testing.assert_allclose(tr, jr, rtol=1e-5,
                               atol=1e-6 * float(np.abs(jr).max()))


def test_reflux_box_matches_jax_value_for_value():
    """The drifting box with reflux walls on the low x face (the box of
    box_runs, whose tally counts lanes on that face), 12 steps in both
    packages from the JAX package's finalized state and key: the port
    draws the JAX package's reflux momenta, so the counts are exact, the
    energies within 1e-6 and the live lanes equal as sets to 1e-5."""
    kw = dict(ut_para=(0.2,), ut_perp=(0.2,))
    jsim = drifting_box(JSimulation, jmodels.MaxwellianReflux(**kw))
    jsim.finalize()
    tsim = drifting_box(Simulation, models.MaxwellianReflux(**kw),
                        device="cpu")
    tsim.finalize()
    n0 = alive(jsim.state.species[0])
    runs = torch_decks.open_runs(jsim, tsim, STEPS)
    torch_decks.check_energies_and_movers(runs)
    torch_decks.check_live_lanes(runs)
    assert alive(tsim.state.species[0]) == alive(jsim.state.species[0]) \
        < n0
    assert runs["tnm"] == {"electron": 0}


def test_compact_indices_matches_jax():
    rng = np.random.default_rng(3)
    mask = rng.uniform(size=200) < 0.15
    for k in (5, int(mask.sum()), 1000):
        j = jpush.compact_indices(jnp.asarray(mask), k, 4096)
        t = push.compact_indices(torch.as_tensor(mask), k, 4096)
        for a, b in zip(t, j):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_handler_codes_match_jax():
    codes = [models.handler_code(h, f) for h in range(3) for f in range(6)]
    assert codes == [jmodels.handler_code(h, f) for h in range(3)
                     for f in range(6)]
    pc = np.array(codes, np.int32)
    for a, b in zip(models.decode_handler(torch.as_tensor(pc)),
                    jmodels.decode_handler(jnp.asarray(pc))):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _grids(pbc, nx=6, ny=5, nz=4):
    kw = dict(nx=nx, ny=ny, nz=nz, dt=0.05, fbc=(PERIODIC_FIELDS,) * 6,
              pbc=pbc)
    return JGrid(**kw), Grid(**kw)


def _rhob_bar(g, vox, q, dx, dy, dz, mask):
    """Per node 1e-6 of the summed |weight| (the port's deposit of |q|)."""
    f = FieldState.zeros(g)
    absw = aux.accumulate_rhob(f, g, vox, q.abs(), dx, dy, dz, mask).rhob
    return 1e-6 * absw.numpy() + 1e-30


def test_accumulate_rhob_matches_jax():
    """Lanes in every cell, so that nodes of every face double."""
    jg, g = _grids((PERIODIC_FIELDS,) * 6)
    rng = np.random.default_rng(5)
    n = 3000
    vox = np.asarray(g.voxel(rng.integers(1, g.nx + 1, n),
                             rng.integers(1, g.ny + 1, n),
                             rng.integers(1, g.nz + 1, n)), np.int32)
    cols = [rng.uniform(-1, 1, n).astype(np.float32) for _ in range(3)]
    q = rng.uniform(-1.5, 1.5, n).astype(np.float32)
    mask = rng.uniform(size=n) < 0.8
    jr = jaux.accumulate_rhob(JField.zeros(jg), jg, jnp.asarray(vox),
                              jnp.asarray(q), *map(jnp.asarray, cols),
                              jnp.asarray(mask)).rhob
    t = [torch.as_tensor(a) for a in (vox, q, *cols, mask)]
    tr = aux.accumulate_rhob(FieldState.zeros(g), g, *t).rhob
    bar = _rhob_bar(g, *t)
    assert (np.abs(tr.numpy() - np.asarray(jr)) <= bar).all()
    # the edge doubling reaches every face: a lane's weights there sum to
    # more than its charge
    assert float(tr.abs().sum()) > float(np.abs(q[mask]).sum()
                                         * aux._r8V(g) * 1.5)


def _pending_species(g, variant):
    """A drifting species pushed once by the port with its pending lanes
    left to the rounds (lanes stopped at both x faces), and a tenth of the
    settled lanes handed a remaining displacement of up to 3 cells with
    ``PC_EXHAUSTED``, as emitted and injected lanes are: numpy columns."""
    rng = np.random.default_rng(11)
    n, max_np = 1500, 2048
    vox = np.asarray(g.voxel(rng.integers(1, g.nx + 1, n),
                             rng.integers(1, g.ny + 1, n),
                             rng.integers(1, g.nz + 1, n)), np.int32)
    order = np.argsort(vox, kind="stable")
    pad = lambda a, dt: np.concatenate([a[order], np.zeros(max_np - n)]
                                       ).astype(dt)
    cols = dict(dx=rng.uniform(-1, 1, n), dy=rng.uniform(-1, 1, n),
                dz=rng.uniform(-1, 1, n), ux=rng.normal(1.5, 2.0, n),
                uy=rng.normal(0, 2.0, n), uz=rng.normal(0, 2.0, n),
                q=rng.uniform(-1.5, -0.5, n))
    sp = SpeciesState.create("e", 0, -1.0, max_np).replace(
        np=torch.tensor(n, dtype=torch.int32),
        i=torch.as_tensor(pad(vox, np.int32)),
        **{k: torch.as_tensor(pad(v, np.float32)) for k, v in cols.items()})
    interp = torch.as_tensor((0.1 * rng.normal(size=(g.nv, 18)))
                             .astype(np.float32))
    nb = torch.as_tensor(build_neighbor_table(g))
    sp, _ = push.advance_p(sp, interp, torch.zeros((g.nv, 12)), nb, g,
                           n_walk=2, count_pending=False)
    assert int(sp.nm) == 0
    cols = {c: getattr(sp, c).numpy().copy() for c in COLS}
    aged = (cols["pc"] == 0) & (np.arange(max_np) < n) & (
        rng.uniform(size=max_np) < 0.1)
    cols["pc"][aged] = push.PC_EXHAUSTED
    for c in ("mdx", "mdy", "mdz"):
        cols[c][aged] = rng.uniform(-3, 3, int(aged.sum()))
    pc = cols["pc"]
    assert (pc == g.pbc[0]).any() and (pc == NEIGHBOR_ABSORB).any()
    return cols, n, nb


class FedReflux(models.MaxwellianReflux):
    """The port's reflux with given draws."""

    def __init__(self, fed, **kw):
        super().__init__(**kw)
        object.__setattr__(self, "fed", fed)

    def draws(self, key, n):
        return self.fed


ROUND_HANDLERS = ("absorb", "tally", "link", "reflux", "reflux drawn")


@pytest.mark.parametrize("variant", ROUND_HANDLERS)
def test_boundary_round_matches_jax(variant):
    """One round: the low x face absorbing or custom, the high x face
    absorbing.  Both packages get one pending species and the same key;
    the reflux handler is fed the JAX package's draws, or ("reflux
    drawn") draws its own from the key."""
    code = NEIGHBOR_ABSORB if variant == "absorb" else \
        models.handler_code(0, 0)
    jg, g = _grids((code, PERIODIC_FIELDS, PERIODIC_FIELDS, NEIGHBOR_ABSORB,
                    PERIODIC_FIELDS, PERIODIC_FIELDS))
    cols, n, nb = _pending_species(g, variant)
    max_inj = 1024
    n_walk = 2
    key = jax.random.key(9)
    kw = dict(ut_para=(0.2,), ut_perp=(0.3,))
    jh, th = {
        "absorb": ((), ()),
        "tally": ((jmodels.AbsorbTally(n_species=1),),
                  (models.AbsorbTally(n_species=1),)),
        "link": ((jmodels.LinkBoundary(capacity=256),),
                 (models.LinkBoundary(capacity=256),)),
        "reflux": ((jmodels.MaxwellianReflux(**kw),), None),
        "reflux drawn": ((jmodels.MaxwellianReflux(**kw),),
                         (models.MaxwellianReflux(**kw),))}[variant]
    if variant == "reflux":
        k1, k2, k3 = jax.random.split(jax.random.split(key, 1)[0], 3)
        fed = (jax.random.uniform(k1, (max_inj,), jnp.float32,
                                  minval=1e-38, maxval=1.0),
               jax.random.normal(k2, (max_inj,), jnp.float32),
               jax.random.normal(k3, (max_inj,), jnp.float32))
        th = (FedReflux(tuple(torch.as_tensor(np.array(a)) for a in fed),
                        **kw),)

    jsp = JSpecies.create("e", 0, -1.0, 2048).replace(
        np=jnp.int32(n), **{c: jnp.asarray(v) for c, v in cols.items()})
    # the port's species owns copies: the round scatters into it in place
    tsp = SpeciesState.create("e", 0, -1.0, 2048).replace(
        np=torch.tensor(n, dtype=torch.int32),
        **{c: torch.tensor(v) for c, v in cols.items()})
    jb = tuple(h.init_state(1) for h in jh)
    tb = tuple(h.init_state(1) for h in th)
    acc = np.zeros((g.nv, 12), np.float32)
    step = 7
    jout = jax.jit(lambda sp, acc: jboundary.process_boundary(
        sp, JField.zeros(jg), acc, jnp.asarray(nb), jg, None, max_inj,
        n_walk, handlers=jh, bstate=jb, key=key, step=jnp.int32(step)))(
        jsp, jnp.asarray(acc))
    tout = boundary.process_boundary(
        tsp, FieldState.zeros(g), torch.as_tensor(acc), nb, g, None,
        max_inj, n_walk, handlers=th, bstate=tb,
        key=torch.as_tensor(np.asarray(jax.random.key_data(key), np.int64)),
        step=torch.tensor(step, dtype=torch.int32))
    (jsp1, jf, jacc, jbs), (tsp1, tf, tacc, tbs) = jout, tout

    for c in ("i", "pc", "tag"):
        np.testing.assert_array_equal(getattr(tsp1, c).numpy(),
                                      np.asarray(getattr(jsp1, c)),
                                      err_msg=c)
    for c in ("dx", "dy", "dz", "ux", "uy", "uz", "q", "mdx", "mdy", "mdz"):
        np.testing.assert_allclose(getattr(tsp1, c).numpy(),
                                   np.asarray(getattr(jsp1, c)), err_msg=c,
                                   **FLOATS)
    np.testing.assert_allclose(tacc.numpy(), np.asarray(jacc), **ACC)
    # the lanes deposited into rhob: absorbed, or killed by a handler
    dead = (cols["pc"] == NEIGHBOR_ABSORB) | (
        (cols["pc"] == code) & (not variant.startswith("reflux")))
    t = lambda a: torch.as_tensor(a[dead])
    bar = _rhob_bar(g, t(cols["i"]), t(cols["q"]), t(cols["dx"]),
                    t(cols["dy"]), t(cols["dz"]),
                    torch.ones(int(dead.sum()), dtype=torch.bool))
    assert (np.abs(tf.rhob.numpy() - np.asarray(jf.rhob)) <= bar).all()
    assert int((tsp1.i.numpy() < 0).sum()) == dead.sum() > 0
    for a, b in zip(tbs, jbs):
        if isinstance(a, dict):
            for k in a:
                np.testing.assert_array_equal(a[k].numpy(),
                                              np.asarray(b[k]), err_msg=k)
            assert int(a["count"]) == (cols["pc"] == code).sum()
            assert set(a["step"].numpy()[:int(a["count"])]) == {step}
        else:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
            if variant == "tally":
                assert int(a[0]) == (cols["pc"] == code).sum()


def test_reflux_momenta_statistics():
    """The port's own draws: on a low x face the parallel momentum is
    flux-weighted into the domain (mean ut_para sqrt(pi/2)), the two
    perpendicular ones Gaussian of spread ut_perp, within 5 sigma."""
    n = 20000
    g = Grid(nx=4, ny=4, nz=4)
    z = torch.zeros(n)
    b = dict(ux=z - 0.3, uy=z, uz=z, mdx=z - 0.1, mdy=z, mdz=z, q=z + 1.0,
             pc=torch.full((n,), models.handler_code(0, 0)))
    mask = torch.ones(n, dtype=torch.bool)
    h = models.MaxwellianReflux(ut_para=(0.2,), ut_perp=(0.3,))
    out, *_ = h.apply(rnd.split(rnd.make_key(3))[1], b, mask,
                      torch.zeros(n, dtype=torch.int64), None, g, 0, None)
    ux, uy, uz = (out[c].double().numpy() for c in ("ux", "uy", "uz"))
    assert (ux > 0).all() and (out["pc"] == push.PC_EXHAUSTED).all()
    # u_para = ut sqrt(2) sqrt(-ln mu): mean ut sqrt(pi/2), var ut^2 (2 -
    # pi/2)
    m, s = 0.2 * np.sqrt(np.pi / 2), 0.2 * np.sqrt(2 - np.pi / 2)
    assert abs(ux.mean() - m) < 5 * s / np.sqrt(n)
    for u in (uy, uz):
        assert abs(u.mean()) < 5 * 0.3 / np.sqrt(n)
        assert abs(u.var() / 0.09 - 1) < 5 * np.sqrt(2 / n)
    # the remaining displacement keeps the lane's age: |md| scales as
    # |u|/gamma
    old = 0.1 * np.sqrt(1 + 0.09) / 0.3
    new = np.abs(out["mdx"].double().numpy()) / np.abs(ux) * np.sqrt(
        1 + ux * ux + uy * uy + uz * uz)
    np.testing.assert_allclose(new, old, rtol=1e-5)


def test_reflux_momenta_fed_jax_draws():
    """reflux_momenta on the JAX handler's own draws gives its momenta
    and displacements, on every face."""
    n = 600
    rng = np.random.default_rng(8)
    jg, g = _grids((PERIODIC_FIELDS,) * 6)
    face = rng.integers(0, 6, n).astype(np.int32)
    b = {c: rng.normal(0, 0.5, n).astype(np.float32)
         for c in ("ux", "uy", "uz", "mdx", "mdy", "mdz", "q")}
    b["pc"] = np.array([models.handler_code(0, f) for f in face], np.int32)
    mask = rng.uniform(size=n) < 0.9
    h = jmodels.MaxwellianReflux(ut_para=(0.2,), ut_perp=(0.3,))
    key = jax.random.key(4)
    jb, *_ = h.apply(key, {k: jnp.asarray(v) for k, v in b.items()},
                     jnp.asarray(mask), jnp.asarray(face), None, jg, 0, None)
    k1, k2, k3 = jax.random.split(key, 3)
    draws = (jax.random.uniform(k1, (n,), jnp.float32, minval=1e-38,
                                maxval=1.0),
             jax.random.normal(k2, (n,), jnp.float32),
             jax.random.normal(k3, (n,), jnp.float32))
    tb = models.reflux_momenta(
        {k: torch.as_tensor(v) for k, v in b.items()},
        torch.as_tensor(mask), torch.as_tensor(face), g, 0.2, 0.3,
        *(torch.as_tensor(np.array(a)) for a in draws))
    for c in ("ux", "uy", "uz", "mdx", "mdy", "mdz"):
        np.testing.assert_allclose(tb[c].numpy(), np.asarray(jb[c]),
                                   err_msg=c, **FLOATS)
    np.testing.assert_array_equal(tb["pc"].numpy(), np.asarray(jb["pc"]))


def test_link_ring_and_file_match_jax(tmp_path):
    """Two rounds of hits through a 4-slot ring (6 hits: it wraps), the
    ring equal to the JAX package's, and the drained file equal to its
    and to the order of tests/test_regressions_r3.py:62."""
    g = Grid(nx=4, ny=4, nz=1)
    jg = JGrid(nx=4, ny=4, nz=1)
    th, jh = models.LinkBoundary(capacity=4), jmodels.LinkBoundary(capacity=4)
    ts, js = th.init_state(1), jh.init_state(1)
    n = 5
    for step, hits in ((12, [0, 2, 3]), (14, [1, 3, 4])):
        mask = np.isin(np.arange(n), hits)
        b = dict(vox=np.arange(n, dtype=np.int32) * 10 + step,
                 q=np.arange(n, dtype=np.float32) + step, dx=np.zeros(n,
                                                                 np.float32),
                 dy=np.zeros(n, np.float32), dz=np.zeros(n, np.float32),
                 pc=np.full(n, models.handler_code(0, 0), np.int32))
        _, _, ts, tk = th.apply(None, {k: torch.as_tensor(v) for k, v in
                                       b.items()}, torch.as_tensor(mask),
                                None, FieldState.zeros(g), g, 0, ts,
                                step=torch.tensor(step, dtype=torch.int32))
        _, _, js, jk = jh.apply(None, {k: jnp.asarray(v) for k, v in
                                       b.items()}, jnp.asarray(mask), None,
                                JField.zeros(jg), jg, 0, js,
                                step=jnp.int32(step))
        np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
        for k in ts:
            np.testing.assert_array_equal(ts[k].numpy(), np.asarray(js[k]),
                                          err_msg=k)
    assert int(ts["count"]) == 6
    files = [tmp_path / "link.port", tmp_path / "link.jax"]
    assert models.drain_link_file(ts, files[0]) == 6
    assert jmodels.drain_link_file(js, files[1]) == 6
    text = files[0].read_text()
    assert text == files[1].read_text()
    rows = [r.split() for r in text.splitlines()]
    # hits 2..5 of six, oldest first: steps 12 14 14 14
    assert [int(r[0]) for r in rows] == [12, 14, 14, 14]
    assert [int(r[1]) for r in rows] == [42, 24, 44, 54]


def test_modify_runparams_keeps_handlers():
    """tests/test_regressions_r3.py:45: a rebuild keeps the reflux walls,
    so no lane is lost."""
    sim = drifting_box(Simulation, models.MaxwellianReflux(
        ut_para=(0.2,), ut_perp=(0.2,)), device="cpu")
    sim.set_domain_particle_bc(3, sim._boundary_handlers[0])
    sim.finalize()
    n0 = alive(sim.state.species[0])
    sim.advance(3)
    sim.modify_runparams(num_comm_round=2, max_inj=2048)
    sim.advance(3)
    assert alive(sim.state.species[0]) == n0
    assert sim.mover_counts() == {"electron": 0}


def test_checkpoint_restores_rng_and_boundary_state(tmp_path):
    """Reflux on the low face (random draws) and a link ring on the high
    one: 3 steps, a checkpoint, 3 more; restored and run 3 steps, the
    state repeats bit for bit, the random state and the ring included."""
    def build():
        sim = drifting_box(Simulation, models.MaxwellianReflux(
            ut_para=(0.2,), ut_perp=(0.2,)), device="cpu")
        sim.set_domain_particle_bc(3, sim.define_boundary(
            models.LinkBoundary(capacity=64)))
        sim.finalize()
        return sim

    sim = build()
    sim.advance(3)
    sim.checkpoint(tmp_path / "ck")
    sim.advance(3)
    first = state_to_numpy(sim.state)
    assert int(first["boundary_state/1/count"]) > 0
    other = build()
    other.restore(tmp_path / "ck")
    assert other.step_count == 3
    other.advance(3)
    second = state_to_numpy(other.state)
    assert set(first) == set(second)
    for k, v in first.items():
        np.testing.assert_array_equal(np.asarray(second[k]), np.asarray(v),
                                      err_msg=k)
    # one split of the key per step, by the boundary rounds
    key = rnd.make_key(2 * 65537)
    for _ in range(6):
        key = rnd.split(key)[0]
    np.testing.assert_array_equal(first["rng"], key.numpy())


def test_state_from_jax_takes_rng(box_runs):
    """A state of the JAX package loads with its own key where the caller
    adds its data (``jax.random.key_data``; the dict of
    ``state_to_numpy`` cannot hold the typed key), takes the ``rng``
    given as an override, and without either the step raises, naming the
    cause, at its first draw."""
    d0 = box_runs["d0"]
    assert "rng" not in d0
    jkey = jax.random.key(2 * 65537)
    loaded = state_from_numpy(dict(d0, rng=jax.random.key_data(jkey)))
    assert loaded.rng.dtype == torch.int64
    np.testing.assert_array_equal(loaded.rng.numpy(),
                                  np.asarray(jax.random.key_data(jkey)))
    key = rnd.make_key(5)
    assert torch.equal(state_from_numpy(d0, rng=key).rng, key)
    assert torch.equal(state_from_numpy(dict(d0, rng=[0, 9]), rng=key).rng,
                       key)
    sim = drifting_box(Simulation, models.AbsorbTally(n_species=1),
                       device="cpu")
    sim.finalize()
    sim.state = state_from_numpy(d0)
    with pytest.raises(ValueError, match="rng is None"):
        sim.advance(1)
