"""Several shards in one process (vpic_tpu_torch/engine/distributed.py) on
the CPU, held to the JAX package's multi-shard engine topology for
topology: every case of tests/multi_device/test_shard.py at its size
(8x4x4 cells, 1024 lanes), built in both packages from the same deck on
the 8-device CPU mesh of tests/conftest.py, each JAX topology built once
in a module-scoped fixture.

Bars against the JAX package: voxels exact, particles compared as sets
ordered by (global voxel, position), every float array (each field
component of every shard, each particle column) within ULPS = 16 float32
ulps of its own scale (the largest magnitude in the JAX run of the
particle column, or of the field vector that the component belongs to:
E, cB, tca, J, or rho for the charges and div_e_err), energies to 1e-6
relative,
alive counts exact.  Measured on the CPU: at most 10.5 ulps (particle dx
of the two-shard run at step 20, where the orbits have amplified the
deposits' summation order for 20 steps), at most 8.0 ulps in every other
case (the absorb tally's particles; fields at most 7.1), energies within
1.6e-7 relative (this module's ``__main__`` prints each case's).  Against the
port's own one-shard run: the JAX test's bars (fields rtol 2e-4 / atol
2e-5, 3e-4 / 3e-5 where it uses them; energies rtol 1e-4).  Also: the
neighbor table of every shard, the voxel remap, two seeded multi-shard
runs with equal checksums, a bitwise multi-shard restart, the stacked
interop form, a broken or late shard failing the call in bounded time,
migration past ``mig_cap`` retried in the next round, and a two-shard run
of each of the port's decks against its one-shard run.
"""

import dataclasses
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from vpic_tpu.boundary.models import AbsorbTally as JTally
from vpic_tpu.core.types import ABSORB_FIELDS
from vpic_tpu.deck.api import Simulation as JSim
from vpic_tpu.engine import distributed as jdist
from vpic_tpu.grid import partition as jpart
from vpic_tpu.particles import boundary as jboundary

from vpic_tpu_torch.boundary.models import AbsorbTally as TTally
from vpic_tpu_torch.cli import run as cli
from vpic_tpu_torch.comm.facecomm import ShardError
from vpic_tpu_torch.core import random as rnd
from vpic_tpu_torch.core.types import FIELD_COMPONENTS, Grid
from vpic_tpu_torch.deck.api import Simulation as TSim
from vpic_tpu_torch.engine import distributed as tdist
from vpic_tpu_torch.grid import partition as tpart
from vpic_tpu_torch.interop import (stack_numpy, state_to_numpy,
                                    states_from_numpy, states_to_numpy,
                                    unstack_numpy)
from vpic_tpu_torch.io import tracers as iotracers
from vpic_tpu_torch.particles import boundary as tboundary

from tests import torch_decks

ULPS = 16
EPS32 = float(np.finfo(np.float32).eps)
E_BAR = 1e-6
L = 1.0


def port(seed):
    return TSim(seed=seed, device="cpu")


def deck(make, px=1, py=1, pz=1, seed=3, **opts):
    """tests/multi_device/test_shard.py:build in either package, with
    ``opts`` for its StepOptions."""
    nx, ny, nz = 8, 4, 4
    sim = make(seed)
    sim.define_units(1.0, 1.0)
    sim.define_timestep(0.9 * sim.courant_length(L, L, L, nx, ny, nz))
    sim.define_periodic_grid(0, 0, 0, L, L, L, nx, ny, nz, px, py, pz)
    sim.opts = dataclasses.replace(sim.opts, **opts)
    sim.define_material("vacuum")
    e = sim.define_species("electron", -1.0, 4096)
    rng = np.random.default_rng(12345)
    n = 1024
    x, y, z = (rng.uniform(0, L, n) for _ in range(3))
    ux, uy, uz = (rng.normal(0, 0.3, n) for _ in range(3))
    sim.inject_particle(e, x, y, z, ux, uy, uz, q=-1.0 / n)
    sim.set_field("ex", lambda x, y, z: 0.01 * np.sin(2 * np.pi * x))
    sim.set_field("cbz", lambda x, y, z: 0.02 * np.cos(2 * np.pi * y))
    sim.finalize()
    return sim


def bounded(make, px=1, pz=1, seed=9):
    """test_shard.py:build_bounded: reflecting x faces, absorbing y."""
    nx, ny, nz = 8, 6, 4
    sim = make(seed)
    sim.define_units(1.0, 1.0)
    sim.define_timestep(0.9 * sim.courant_length(L, L, L, nx, ny, nz))
    sim.define_reflecting_grid(0, 0, 0, L, L, L, nx, ny, nz, px, 1, pz)
    sim.set_domain_particle_bc(1, "absorb")
    sim.set_domain_particle_bc(4, "absorb")
    sim.opts = dataclasses.replace(sim.opts, clean_div_e_interval=1)
    sim.define_material("vacuum")
    e = sim.define_species("electron", -1.0, 4096)
    rng = np.random.default_rng(777)
    n = 1024
    x, y, z = (rng.uniform(0.05, 0.95, n) for _ in range(3))
    ux, uy, uz = (rng.normal(0, 0.4, n) for _ in range(3))
    sim.inject_particle(e, x, y, z, ux, uy, uz, q=-1.0 / n)
    sim.set_field("ex", lambda x, y, z: 0.01 * np.sin(np.pi * x))
    sim.finalize()
    return sim


def cycled(make, px=1, seed=3, resort=2, ion_mult=2):
    """test_shard.py:_build_cycled: two species, the resort cadence."""
    nx, ny, nz = 8, 4, 4
    sim = make(seed)
    sim.define_units(1.0, 1.0)
    sim.define_timestep(0.9 * sim.courant_length(L, L, L, nx, ny, nz))
    sim.define_periodic_grid(0, 0, 0, L, L, L, nx, ny, nz, px, 1, 1)
    sim.define_material("vacuum")
    sim.opts = dataclasses.replace(sim.opts, resort_interval=resort)
    e = sim.define_species("electron", -1.0, 4096)
    i = sim.define_species("ion", 1.0 / 25.0, 4096,
                           sort_interval=ion_mult * resort)
    rng = np.random.default_rng(777)
    n = 1024
    for sp, sgn, ut in ((e, -1.0, 0.3), (i, 1.0, 0.06)):
        x, y, z = (rng.uniform(0, L, n) for _ in range(3))
        sim.inject_particle(sp, x, y, z, rng.normal(0, ut, n),
                            rng.normal(0, ut, n), rng.normal(0, ut, n),
                            q=sgn / n)
    sim.set_field("ex", lambda x, y, z: 0.01 * np.sin(2 * np.pi * x))
    sim.finalize()
    return sim


def skewed(make, px=1):
    """test_shard.py:build_skewed: every particle in shard 0's half."""
    nx, ny, nz = 8, 4, 4
    sim = make(7)
    sim.define_units(1.0, 1.0)
    sim.define_timestep(0.9 * sim.courant_length(L, L, L, nx, ny, nz))
    sim.define_periodic_grid(0, 0, 0, L, L, L, nx, ny, nz, px, 1, 1)
    sim.define_material("vacuum")
    e = sim.define_species("electron", -1.0, 4096)
    rng = np.random.default_rng(99)
    n = 1024
    sim.inject_particle(e, rng.uniform(0, 0.5 * L, n), rng.uniform(0, L, n),
                        rng.uniform(0, L, n), rng.normal(0, 0.3, n),
                        rng.normal(0, 0.3, n), rng.normal(0, 0.3, n),
                        q=-1.0 / n)
    sim.set_field("ex", lambda x, y, z: 0.01 * np.sin(2 * np.pi * x))
    sim.finalize()
    return sim


def tally_box(make, tally_cls, px=1):
    """test_shard.py:test_two_shard_absorb_tally's deck."""
    nx, ny, nz = 8, 4, 4
    sim = make(13)
    sim.define_units(1.0, 1.0)
    sim.define_timestep(0.9 * sim.courant_length(L, L, L, nx, ny, nz))
    sim.define_absorbing_grid(0, 0, 0, L, L, L, nx, ny, nz, px, 1, 1)
    tally = sim.define_boundary(tally_cls(n_species=1))
    for face in range(6):
        sim.set_domain_particle_bc(face, tally)
    sim.define_material("vacuum")
    e = sim.define_species("electron", -1.0, 4096)
    rng = np.random.default_rng(55)
    n = 1024
    sim.inject_particle(e, rng.uniform(0.05, 0.95, n),
                        rng.uniform(0.05, 0.95, n),
                        rng.uniform(0.05, 0.95, n),
                        rng.normal(0.3, 0.3, n), rng.normal(0, 0.2, n),
                        rng.normal(0, 0.2, n), q=-1.0 / n)
    sim.finalize()
    return sim, tally


_JOIN = np.random.default_rng(9911)
JOIN_N = 512
JOIN_LANES = (_JOIN.uniform(0, L, JOIN_N), _JOIN.uniform(0, L, JOIN_N),
              _JOIN.uniform(0, L, JOIN_N), _JOIN.normal(0.4, 0.3, JOIN_N),
              *_JOIN.normal(0, 0.3, (2, JOIN_N)))


def joined(make, loops: bool):
    """test_shard.py:test_join_domain_pairwise_loops: ``loops``, the
    [0, 2L] box of 4 x-shards wired as two 2-shard loops; else the 2-shard
    periodic box of L."""
    ny, nz = 4, 4
    sim = make(5)
    sim.define_units(1.0, 1.0)
    sim.define_timestep(0.9 * sim.courant_length(L, L, L, 8, ny, nz))
    if loops:
        sim.define_periodic_grid(0, 0, 0, 2 * L, L, L, 16, ny, nz, 4, 1, 1)
        sim.set_domain_field_bc(0, ABSORB_FIELDS)
        sim.set_domain_field_bc(3, ABSORB_FIELDS)
        sim.set_domain_particle_bc(0, "absorb")
        sim.set_domain_particle_bc(3, "absorb")
        sim.join_domain(3, (1, 0, 3, 2))
        sim.join_domain(0, (1, 0, 3, 2))
    else:
        sim.define_periodic_grid(0, 0, 0, L, L, L, 8, ny, nz, 2, 1, 1)
    sim.define_material("vacuum")
    e = sim.define_species("electron", -1.0, 4096)
    sim.inject_particle(e, *JOIN_LANES, q=-1.0 / JOIN_N)
    sim.finalize()
    return sim


# -- snapshots --------------------------------------------------------------


def shard_dicts(sim):
    """Per-shard numpy dicts in rank order, from either package."""
    g = sim.grid
    if isinstance(sim, TSim):
        return [state_to_numpy(st) for st in sim.states]
    d = state_to_numpy(sim.state)
    return unstack_numpy(d, g.gpx * g.gpy * g.gpz) if g.is_multishard \
        else [d]


def owned_field(dicts, g, comp):
    """The owned block of ``comp`` over the global box."""
    own = lambda d: d[f"field/{comp}"][1:g.nz + 1, 1:g.ny + 1, 1:g.nx + 1]
    rank = lambda sx, sy, sz: sx + g.gpx * (sy + g.gpy * sz)
    return np.concatenate([np.concatenate([np.concatenate(
        [own(dicts[rank(sx, sy, sz)]) for sx in range(g.gpx)], axis=2)
        for sy in range(g.gpy)], axis=1) for sz in range(g.gpz)], axis=0)


def particle_set(dicts, g, k=0):
    """The live lanes of species k over every shard, with voxels on the
    global ghosted grid, ordered by (global voxel, dx, dy, dz)."""
    cols = {c: [] for c in ("gi", "dx", "dy", "dz", "ux", "uy", "uz", "q",
                            "tag")}
    for r, d in enumerate(dicts):
        pre = f"species/{k}/"
        i = d[pre + "i"]
        alive = (np.arange(i.shape[0]) < int(d[pre + "np"])) & (i >= 0)
        shard = tdist.shard_coords(g)[r]
        cols["gi"].append(iotracers.globalize_voxels(g, i[alive], shard))
        for c in cols:
            if c != "gi":
                cols[c].append(d[pre + c][alive])
    cols = {c: np.concatenate(v) for c, v in cols.items()}
    order = np.lexsort((cols["dz"], cols["dy"], cols["dx"], cols["gi"]))
    return {c: v[order] for c, v in cols.items()}


def snap(sim):
    return dict(g=sim.grid, d=shard_dicts(sim), e=sim.energies(),
                nm=sim.mover_counts())


def run(sim, steps):
    """The snapshot of ``sim`` advanced ``steps`` steps."""
    sim.advance(steps)
    return snap(sim)


def near(a, b, scale, what):
    """``a`` within ULPS float32 ulps of ``scale`` of ``b``; returns the
    largest difference in those ulps."""
    d = float(np.abs(np.asarray(a, np.float64) - b).max(initial=0.0))
    assert d <= ULPS * EPS32 * scale, (
        f"{what}: max |diff| {d!r}, {d / (EPS32 * scale or 1.0):.1f} ulps "
        f"of {scale!r}")
    return d / (EPS32 * scale) if d else 0.0


SCALE_OF = dict(
    **dict.fromkeys(("ex", "ey", "ez"), ("ex", "ey", "ez")),
    **dict.fromkeys(("cbx", "cby", "cbz", "div_b_err"),
                    ("cbx", "cby", "cbz")),
    **dict.fromkeys(("tcax", "tcay", "tcaz"), ("tcax", "tcay", "tcaz")),
    **dict.fromkeys(("jfx", "jfy", "jfz"), ("jfx", "jfy", "jfz")),
    **dict.fromkeys(("rhob", "rhof", "div_e_err"), ("rhob", "rhof")))


def field_scale(dicts, comp):
    """The largest magnitude over the shards of the vector ``comp``
    belongs to (E, cB, tca, J; rho for the charges and div_e_err, which
    is div E less rho; cB for div_b_err)."""
    return max(float(np.abs(d[f"field/{c}"]).max())
               for d in dicts for c in SCALE_OF[comp])


def same_fields(t_dicts, j_dicts):
    """Every field component of every shard; returns the largest
    difference in ulps."""
    return max(near(a[f"field/{comp}"], b[f"field/{comp}"],
                    field_scale(j_dicts, comp), f"shard {r} {comp}")
               for comp in FIELD_COMPONENTS
               for r, (a, b) in enumerate(zip(t_dicts, j_dicts)))


def check_against_jax(t, j, species=1):
    """The port's snapshot ``t`` against the JAX package's ``j`` of the
    same topology."""
    g = t["g"]
    worst = dict(fields=same_fields(t["d"], j["d"]), particles=0.0)
    for k in range(species):
        a, b = particle_set(t["d"], g, k), particle_set(j["d"], g, k)
        np.testing.assert_array_equal(a["gi"], b["gi"])
        np.testing.assert_array_equal(a["tag"], b["tag"])
        for c in ("dx", "dy", "dz", "ux", "uy", "uz", "q"):
            worst["particles"] = max(worst["particles"], near(
                a[c], b[c], float(np.abs(b[c]).max(initial=0.0)),
                f"species {k} {c}"))
    for name, e in j["e"].items():
        np.testing.assert_allclose(t["e"][name], e, rtol=E_BAR, atol=1e-12,
                                   err_msg=name)
    assert t["nm"] == j["nm"]
    worst["energy_rel"] = max(abs(t["e"][n] - e) / abs(e)
                              for n, e in j["e"].items() if e)
    return worst


def check_against_one(many, one, comps, rtol=2e-4, atol=2e-5, e_rtol=1e-4,
                      species=1):
    """The port's N-shard snapshot against its one-shard run at the JAX
    test's bars; alive counts exact."""
    for comp in comps:
        np.testing.assert_allclose(owned_field(many["d"], many["g"], comp),
                                   owned_field(one["d"], one["g"], comp),
                                   rtol=rtol, atol=atol, err_msg=comp)
    for k, e in one["e"].items():
        np.testing.assert_allclose(many["e"][k], e, rtol=e_rtol, atol=1e-9,
                                   err_msg=k)
    for k in range(species):
        assert alive(many, k) == alive(one, k)


def alive(s, k=0):
    return sum(int(((np.arange(d[f"species/{k}/i"].shape[0])
                     < int(d[f"species/{k}/np"]))
                    & (d[f"species/{k}/i"] >= 0)).sum()) for d in s["d"])


# -- fixtures: each JAX topology built and run once --------------------------


def port_hydro(sim, name="electron"):
    """The port's synchronized hydro, per shard, as (nzg, nyg, nxg, 14)."""
    g = sim.grid
    return [x.numpy().reshape(g.nzg, g.nyg, g.nxg, -1)
            for x in sim._hydro(name)]


@pytest.fixture(scope="module")
def two_shard():
    """One 2-x-shard topology in each package, and the port's one-shard
    run, stepped together for 20 steps: the hydro test (step 3),
    test_two_shard_equivalence (step 5) and test_two_shard_drift_bounded
    (every step to 20; the deck's seed only keys the random state, which
    this deck never draws from, so the JAX test's seeds 3 and 31 build the
    same deck)."""
    import jax
    jsim, tsim, t1 = deck(JSim, px=2), deck(port, px=2), deck(port)
    out = dict(j0=shard_dicts(jsim), t0=shard_dicts(tsim), tsim=tsim,
               drift=[], jkeys=np.asarray(jax.random.key_data(jsim.state.rng)))
    for step in range(1, 21):
        for sim in (jsim, tsim, t1):
            sim.advance(1)
        d = 0.0
        for comp in ("ex", "ey", "cbz"):
            a = tdist.global_field(t1, comp)
            b = tdist.global_field(tsim, comp)
            d = max(d, float(np.abs(a - b).max()
                             / max(np.abs(a).max(), 1e-12)))
        out["drift"].append(d)
        if step == 3:
            g = tsim.grid
            out["jh"] = np.asarray(jdist.make_distributed_hydro(
                jsim.grid, jsim.mesh, 0)(jsim.state)).reshape(
                    2, g.nzg, g.nyg, g.nxg, -1)
            out["th"], out["t1h"] = port_hydro(tsim), port_hydro(t1)[0]
        if step in (5, 20):
            out[step] = dict(j=snap(jsim), t=snap(tsim), t1=snap(t1))
    return out


@pytest.fixture(scope="module")
def eight_shard():
    """test_eight_shard_runs (3 steps) and test_3d_eight_shard_migration
    (4 steps): one (2, 2, 2) topology in each package (their seeds 3 and
    21 build the same deck), and the port's one-shard run."""
    jsim, tsim, t1 = deck(JSim, 2, 2, 2), deck(port, 2, 2, 2), deck(port)
    out = {}
    for step in (3, 4):
        for sim in (jsim, tsim, t1):
            sim.advance(step - 3 if step == 4 else 3)
        out[step] = (snap(jsim), snap(tsim), snap(t1))
    return out


@pytest.fixture(scope="module")
def bounded_runs():
    return (run(bounded(JSim, px=2), 6), run(bounded(port, px=2), 6),
            run(bounded(port), 6))


@pytest.fixture(scope="module")
def cycled_runs():
    jsim = cycled(JSim, px=2)
    for _ in range(8):   # the same 8 steps as one dispatch of 2 cycles
        jsim.advance(1)
    return (snap(jsim), run(cycled(port, px=2), 8), run(cycled(port), 8))


@pytest.fixture(scope="module")
def joined_runs():
    return (run(joined(JSim, True), 6), run(joined(port, True), 6),
            run(joined(port, False), 6))


@pytest.fixture(scope="module")
def tally_runs():
    out = []
    for make, cls, px in ((JSim, JTally, 2), (port, TTally, 2),
                          (port, TTally, 1)):
        sim, tally = tally_box(make, cls, px)
        sim.advance(10)
        out.append(dict(snap(sim), tally=np.asarray(
            sim.boundary_tallies(tally))))
    return out


@pytest.fixture(scope="module")
def skewed_runs():
    return (run(skewed(JSim, px=2), 6), run(skewed(port, px=2), 6),
            run(skewed(port), 6))


# -- the cases of tests/multi_device/test_shard.py -------------------------


def test_two_shard_initial_state_matches_jax(two_shard):
    """Both packages place the same lanes on the same shards and key each
    shard's random state alike (seed * 65537 + rank); the JAX package's
    stacked initial state, with its keys' data, loads into the port's
    per-shard list (interop) with the port's own fields, lanes and keys,
    and an ``rngs`` override replaces the keys."""
    j0, t0 = two_shard["j0"], two_shard["t0"]
    for r, (a, b) in enumerate(zip(t0, j0)):
        for c in ("dx", "dy", "dz", "i", "q", "np"):
            np.testing.assert_array_equal(a[f"species/0/{c}"],
                                          b[f"species/0/{c}"])
        np.testing.assert_array_equal(a["neighbor"], b["neighbor"])
    same_fields(t0, j0)
    g = two_shard["tsim"].grid
    stacked = stack_numpy(j0, (g.gpz, g.gpy, g.gpx))
    jkeys = two_shard["jkeys"]
    assert jkeys.shape == (g.gpz, g.gpy, g.gpx, 2)
    states = states_from_numpy(dict(stacked, rng=jkeys), 2, ["cpu"])
    for r, (st, d) in enumerate(zip(states, j0)):
        np.testing.assert_array_equal(st.species[0].i.numpy(),
                                      d["species/0/i"])
        np.testing.assert_array_equal(st.field.ex.numpy(), d["field/ex"])
        np.testing.assert_array_equal(st.rng.numpy(), jkeys[0, 0, r])
        np.testing.assert_array_equal(t0[r]["rng"], jkeys[0, 0, r])
        np.testing.assert_array_equal(
            st.rng.numpy(), rnd.make_key(3 * 65537 + r).numpy())
    override = states_from_numpy(dict(stacked, rng=jkeys), 2, ["cpu"],
                                 rngs=[rnd.make_key(r) for r in range(2)])
    for r, st in enumerate(override):
        assert torch.equal(st.rng, rnd.make_key(r))


def test_two_shard_equivalence(two_shard):
    run5 = two_shard[5]
    check_against_jax(run5["t"], run5["j"])
    check_against_one(run5["t"], run5["t1"],
                      ("ex", "ey", "ez", "cbx", "cby", "cbz", "jfx"))
    assert alive(run5["t"]) == 1024


def test_eight_shard_runs(eight_shard):
    j, t, _ = eight_shard[3]
    assert all(np.isfinite(v) for v in t["e"].values())
    check_against_jax(t, j)


def test_two_shard_reflect_absorb(bounded_runs):
    j, t, t1 = bounded_runs
    check_against_jax(t, j)
    check_against_one(t, t1, ("ex", "ey", "ez", "cbx", "cby", "cbz",
                              "rhob"), rtol=3e-4, atol=3e-5, e_rtol=2e-4)
    assert alive(t) == alive(j) < 1024


def test_3d_eight_shard_migration(eight_shard):
    j, t, t1 = eight_shard[4]
    check_against_jax(t, j)
    check_against_one(t, t1, ("ex", "cbz", "jfx"), rtol=3e-4, atol=3e-5)
    assert alive(t) == 1024


def test_multishard_cycle_executables(cycled_runs):
    """The resort cadence (every 2 steps, ions every 4) on two shards for
    two whole super-cycles, both species."""
    j, t, t1 = cycled_runs
    check_against_jax(t, j, species=2)
    check_against_one(t, t1, ("ex", "ey", "cbz", "jfx"), rtol=3e-4,
                      atol=3e-5, e_rtol=2e-4, species=2)


def test_two_shard_drift_bounded(two_shard):
    """1 against 2 shards over 20 steps: the drift stays bounded, as in the
    JAX test; the port's 2-shard run is held to the JAX package's at step
    20."""
    drift = two_shard["drift"]
    assert drift[-1] < 5e-3, drift
    assert drift[-1] < 60 * max(max(drift[4:10]), 1e-9), drift
    check_against_jax(two_shard[20]["t"], two_shard[20]["j"])


def test_two_shard_hydro_sync_matches_single(two_shard):
    """The 2-shard hydro with its shared faces merged equals the one-shard
    hydro on every owned node, the shared plane included, and the JAX
    package's distributed hydro."""
    g = two_shard["tsim"].grid
    h1, h2 = two_shard["t1h"], two_shard["th"]
    for sx in range(2):
        np.testing.assert_allclose(
            h2[sx][1:g.nz + 1, 1:g.ny + 1, 1:g.nx + 1],
            h1[1:g.nz + 1, 1:g.ny + 1, sx * g.nx + 1:sx * g.nx + g.nx + 1],
            rtol=2e-4, atol=2e-6, err_msg=f"shard {sx}")
        for m in range(h2[sx].shape[-1]):
            near(h2[sx][..., m], two_shard["jh"][sx][..., m],
                 float(np.abs(two_shard["jh"][..., m]).max()),
                 f"shard {sx} moment {m}")
    assert np.abs(h2[1][1:g.nz + 1, 1:g.ny + 1, 1, 3]).max() > 0


def test_multishard_cli_smoke(tmp_path, capsys):
    """The port's CLI on a 2-shard deck: the status line sums every
    shard's np."""
    path = tmp_path / "deck2.py"
    path.write_text('''
import numpy as np
from vpic_tpu_torch.deck.api import Simulation

def deck(device="cuda"):
    nx, ny, nz = 8, 4, 4
    L = 1.0
    sim = Simulation(seed=3, device=device)
    sim.define_units(1.0, 1.0)
    sim.define_timestep(0.9 * sim.courant_length(L, L, L, nx, ny, nz))
    sim.define_periodic_grid(0, 0, 0, L, L, L, nx, ny, nz, 2, 1, 1)
    sim.define_material("vacuum")
    e = sim.define_species("electron", -1.0, 4096)
    rng = np.random.default_rng(5)
    n = 256
    sim.inject_particle(e, rng.uniform(0, L, n), rng.uniform(0, L, n),
                        rng.uniform(0, L, n), rng.normal(0, 0.3, n),
                        rng.normal(0, 0.3, n), rng.normal(0, 0.3, n),
                        q=-1.0 / n)
    sim.num_step = 2
    return sim
''')
    assert cli.main([str(path), "--device", "cpu", "--status-interval",
                     "1"]) == 0
    out = capsys.readouterr().out
    assert "pushes/s" in out
    assert "done: 2 steps" in out


def test_join_domain_pairwise_loops(joined_runs):
    """A 4-shard x axis wired as two 2-shard loops: the left loop evolves
    as the 2-shard periodic box and the right loop stays empty; the port
    matches the JAX package's wiring."""
    j, t, b = joined_runs
    check_against_jax(t, j)
    g = t["g"]
    for comp in ("ex", "ey", "cbz", "jfx"):
        full = owned_field(t["d"], g, comp)
        np.testing.assert_allclose(full[..., :2 * g.nx],
                                   owned_field(b["d"], b["g"], comp),
                                   rtol=3e-4, atol=3e-5, err_msg=comp)
        assert np.abs(full[..., 2 * g.nx:]).max() == 0.0, comp
    assert alive(t) == alive(b) == JOIN_N


def test_two_shard_absorb_tally(tally_runs):
    j, t, t1 = tally_runs
    check_against_jax(t, j)
    assert int(t1["tally"][0]) == 1024 - alive(t1) > 0
    assert int(t["tally"][0]) == 1024 - alive(t) == int(t1["tally"][0])
    assert int(t["tally"][0]) == int(j["tally"][0])


def test_two_shard_static_load_imbalance(skewed_runs):
    j, t, t1 = skewed_runs
    check_against_jax(t, j)
    check_against_one(t, t1, ("ex", "ey", "ez", "cbx", "cby", "cbz"))
    assert alive(t) == 1024


# -- the port's own contracts ----------------------------------------------


@pytest.mark.parametrize("shards", [(2, 1, 1), (1, 2, 1), (2, 2, 2)])
@pytest.mark.parametrize("pbc", ["periodic", "reflect"])
def test_neighbor_table_of_every_shard(shards, pbc):
    """The per-shard neighbor tables, migrate codes included, equal the
    JAX package's for every shard."""
    from vpic_tpu.core.types import Grid as JGrid
    from vpic_tpu_torch.core.types import NEIGHBOR_REFLECT, PERIODIC_FIELDS

    code = PERIODIC_FIELDS if pbc == "periodic" else NEIGHBOR_REFLECT
    kw = dict(nx=4, ny=3, nz=2, gpx=shards[0], gpy=shards[1],
              gpz=shards[2], pbc=(code,) * 6)
    for shard in tdist.shard_coords(Grid(**kw)):
        np.testing.assert_array_equal(
            tpart.build_neighbor_table(Grid(**kw), shard),
            jpart.build_neighbor_table(JGrid(**kw), shard))


def test_remap_voxel_through_face_matches_jax():
    import jax.numpy as jnp
    from vpic_tpu.core.types import Grid as JGrid

    g, jg = Grid(nx=5, ny=4, nz=3), JGrid(nx=5, ny=4, nz=3)
    vox = torch.arange(g.nv, dtype=torch.int32)
    faces = torch.arange(g.nv, dtype=torch.int32) % 6
    for face in range(6):
        want = np.asarray(jboundary._remap_voxel_through_face(
            jg, jnp.asarray(vox.numpy()), face))
        np.testing.assert_array_equal(
            tboundary.remap_voxel_through_face(g, vox, face).numpy(), want)
        np.testing.assert_array_equal(tboundary.remap_voxel_through_face(
            g, vox, faces).numpy()[face::6], want[face::6])


def injecting(px, K=64):
    """deck()'s box with a user_particle_injection hook that adds K lanes
    a step at global positions on both halves of x, with aged pushes."""
    sim = port(3)
    sim.define_units(1.0, 1.0)
    sim.define_timestep(0.9 * sim.courant_length(L, L, L, 8, 4, 4))
    sim.define_periodic_grid(0, 0, 0, L, L, L, 8, 4, 4, px, 1, 1)
    sim.define_material("vacuum")
    e = sim.define_species("electron", -1.0, 4096)
    rng = np.random.default_rng(4)
    sim.inject_particle(e, *rng.uniform(0, L, (3, 256)),
                        *rng.normal(0, 0.3, (3, 256)), q=-1.0 / 256)
    inj = sim.make_injector("electron")
    pos = rng.uniform(0.05, 0.95, (3, K))
    mom = rng.normal(0, 0.3, (3, K)).astype(np.float32)
    age = rng.uniform(0, 1, K).astype(np.float32)

    def refill(state, acc, f):
        return inj(state, acc, f, x=pos[0], y=pos[1], z=pos[2], ux=mom[0],
                   uy=mom[1], uz=mom[2], q=np.full(K, -1.0 / 256,
                                                   np.float32), age=age)

    sim.finalize(user_particle_injection=refill)
    return sim, inj


def test_injection_on_shards_matches_one_shard():
    """Each shard's injector keeps the lanes of its own box (the step
    gives it its shard's comm): two shards inject, walk and migrate the
    same lanes as one shard over 4 steps: fields and energies at the JAX
    test's bars, the same voxels and the lanes' floats within ULPS ulps.  Outside the step the injector of a
    sharded grid has no shard and raises."""
    (one, _), (two, inj) = injecting(1), injecting(2)
    for sim in (one, two):
        sim.advance(4)
    a, b = snap(two), snap(one)
    check_against_one(a, b, ("ex", "ey", "ez", "cbx", "cby", "cbz", "jfx"))
    assert alive(a) == alive(b) == 256 + 4 * 64
    pa, pb = particle_set(a["d"], a["g"]), particle_set(b["d"], b["g"])
    np.testing.assert_array_equal(pa["gi"], pb["gi"])
    for c in ("dx", "dy", "dz", "ux", "uy", "uz"):
        near(pa[c], pb[c], float(np.abs(pb[c]).max()), c)
    st = two.states[0]
    acc = torch.zeros((two.grid.nv, 12))
    with pytest.raises(RuntimeError, match="sharded grid"):
        inj(st, acc, st.field, x=[0.5], y=[0.5], z=[0.5], ux=0.0, uy=0.0,
            uz=0.0, q=[0.0])


def test_seeded_multishard_runs_repeat():
    """Two 4-shard runs from one seed give equal checksums."""
    sums = []
    for _ in range(2):
        sim = deck(port, 2, 2, 1)
        sim.advance(4)
        sums.append((sim.checksum_fields(), sim.checksum_species("electron")))
    assert sums[0] == sums[1]


def test_multishard_restart_is_bitwise(tmp_path):
    """A checkpoint of every shard at step 3 restarts to the same fields
    and lanes at step 6 as the run that went on."""
    a = deck(port, 2, 1, 2)
    a.advance(3)
    a.checkpoint(tmp_path / "ck")
    a.advance(3)
    b = deck(port, 2, 1, 2)
    b.restore(tmp_path / "ck")
    assert b.step_count == 3
    b.advance(3)
    assert a.checksum_fields() == b.checksum_fields()
    assert a.checksum_species("electron") == b.checksum_species("electron")


def test_stacked_interop_round_trip(two_shard):
    """The port's per-shard list -> the JAX package's stacked form and
    back, losslessly; the stacked arrays carry (gpz, gpy, gpx) axes."""
    sim = two_shard["tsim"]
    g = sim.grid
    d = states_to_numpy(sim.states, (g.gpz, g.gpy, g.gpx))
    assert d["field/ex"].shape == (1, 1, 2) + g.shape
    back = states_from_numpy(d, 2, ["cpu"])
    for st, d1 in zip(back, shard_dicts(sim)):
        for k, v in state_to_numpy(st).items():
            np.testing.assert_array_equal(np.asarray(v), np.asarray(d1[k]),
                                          err_msg=k)


def test_a_failing_shard_fails_the_call():
    """A shard that raises breaks the barrier of the others, and the call
    raises the shard's own exception, not the broken barrier."""
    g = Grid(nx=4, ny=4, nz=4, gpx=2)
    comms = tdist.make_comms(g, tdist.make_mesh(g, ["cpu"]), timeout=30)

    def body(comm):
        if comm.rank == 1:
            raise KeyError("shard one")
        comm.allsum(torch.tensor(1.0))

    t0 = time.perf_counter()
    with pytest.raises(KeyError, match="shard one"):
        tdist.run_shards(comms, body)
    assert time.perf_counter() - t0 < 10
    # the rendezvous is usable again
    assert [float(v) for v in tdist.run_shards(
        comms, lambda c: c.allsum(torch.tensor(float(c.rank))))] == [1.0, 1.0]


def test_a_barrier_timeout_raises_in_bounded_time():
    """A shard that never reaches the exchange that another waits at fails
    the call at once, and a shard that hangs makes the others' wait time
    out: the call raises ShardError after about the timeout."""
    g = Grid(nx=4, ny=4, nz=4, gpz=2)
    comms = tdist.make_comms(g, tdist.make_mesh(g, ["cpu"]), timeout=0.5)

    def skips(comm):
        if comm.rank == 0:
            comm.exchange({2: torch.zeros(3), 5: torch.zeros(3)})

    t0 = time.perf_counter()
    with pytest.raises(ShardError, match="finished without reaching"):
        tdist.run_shards(comms, skips)
    assert time.perf_counter() - t0 < 5

    def hangs(comm):
        if comm.rank == 0:
            time.sleep(1.5)
        comm.allsum(torch.tensor(1.0))

    t0 = time.perf_counter()
    with pytest.raises(ShardError, match="exceeded 0.5 s"):
        tdist.run_shards(comms, hangs)
    assert time.perf_counter() - t0 < 5


def test_shards_run_one_at_a_time():
    """The rendezvous runs the shard threads in turns by rank between
    barriers: no two of 16 shards run at once, with the interpreter
    switching threads every 10 us."""
    import sys

    g = Grid(nx=2, ny=2, nz=2, gpx=16)
    comms = tdist.make_comms(g, tdist.make_mesh(g, ["cpu"]), timeout=30)
    running, log = [0], []

    def body(comm):
        for k in range(3):
            running[0] += 1
            assert running[0] == 1
            log.append((k, comm.rank))
            time.sleep(0.001)
            running[0] -= 1
            comm.allsum(torch.tensor(0.0))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        tdist.run_shards(comms, body)
    finally:
        sys.setswitchinterval(interval)
    assert log == [(k, r) for k in range(3) for r in range(16)]


def test_exchange_pairing_follows_the_jax_ring():
    """A high face receives from shard s+1, a low face from s-1, a joined
    face from join[face][s] (vpic_tpu/comm/facecomm.py:89-115)."""
    g = Grid(nx=2, ny=2, nz=2, gpx=4)
    comms = tdist.make_comms(g, tdist.make_mesh(g, ["cpu"]), timeout=30)
    got = tdist.run_shards(comms, lambda c: c.exchange(
        {0: torch.tensor([c.rank]), 3: torch.tensor([10 + c.rank])}))
    for r, recv in enumerate(got):
        assert int(recv[0]) == 10 + (r - 1) % 4
        assert int(recv[3]) == (r + 1) % 4
    g = Grid(nx=2, ny=2, nz=2, gpx=4, join=((1, 0, 3, 2), None, None,
                                             (1, 0, 3, 2), None, None))
    comms = tdist.make_comms(g, tdist.make_mesh(g, ["cpu"]), timeout=30)
    got = tdist.run_shards(comms, lambda c: c.exchange(
        {0: torch.tensor([c.rank]), 3: torch.tensor([10 + c.rank])}))
    for r, recv in enumerate(got):
        assert int(recv[0]) == 10 + (1, 0, 3, 2)[r]
        assert int(recv[3]) == (1, 0, 3, 2)[r]
    assert [c.is_global_boundary(0) for c in comms] == [False] * 4


def test_migration_past_mig_cap_is_retried():
    """With two lanes per face per round, the lanes that do not fit keep
    their code and cross in a later round; lanes still pending after the
    last round are counted in nm, as the JAX package counts them, and no
    lane is lost.  Which lanes go first follows the slot order, so the
    port runs unsorted, as the JAX package's CPU path does (the unfused
    push without the sorted deposit)."""
    free = deck(port, px=2)
    capped = deck(port, px=2, mig_cap=2, fused_push=False,
                  sorted_deposit=False)
    jcapped = deck(JSim, px=2, mig_cap=2)
    for sim in (free, capped, jcapped):
        sim.advance(2)
    t, j = snap(capped), snap(jcapped)
    assert t["nm"] == j["nm"]
    assert alive(t) == alive(j) == alive(snap(free)) == 1024
    assert t["nm"]["electron"] > 0 and free.mover_counts()["electron"] == 0
    check_against_jax(t, j)


DECK_CASES = {
    "turbulence": (dict(TURB_NX=8, TURB_NY=8, TURB_NZ=8, TURB_PPC=2),
                   "TURB_PZ"),
    "trecon": (dict(TRECON_NX=16, TRECON_NZ=8, TRECON_PPC=4), "TRECON_PX"),
    "sigma": (dict(SIGMA_NX=16, SIGMA_NZ=8, SIGMA_PPC=4), "SIGMA_PZ"),
    "turbulence_fan": (dict(FAN_NX=8, FAN_NY=8, FAN_NZ=8, FAN_PPC=2),
                       "FAN_PY"),
}


@pytest.mark.parametrize("name", sorted(DECK_CASES))
def test_deck_on_two_shards_matches_one(monkeypatch, name):
    """Each of the port's decks, its shard knob at 2, against its own
    one-shard run over 8 steps at the JAX test's bars."""
    env, knob = DECK_CASES[name]
    runs = []
    for shards in (1, 2):
        _, tmod = torch_decks.modules(monkeypatch, name, {**env,
                                                          knob: shards})
        sim = tmod.deck(device="cpu")
        if not sim.states:
            sim.finalize()
        sim.advance(8)
        runs.append(dict(snap(sim), sim=sim))
    one, two = runs
    assert two["g"].n_shards == 2
    check_against_one(two, one, ("ex", "ey", "ez", "cbx", "cby", "cbz"),
                      rtol=3e-4, atol=3e-5, e_rtol=2e-4,
                      species=len(one["sim"].states[0].species))
    assert two["nm"] == one["nm"]


TURB = Path(__file__).resolve().parents[1] / "vpic_tpu_torch" / "decks" \
    / "turbulence.py"
TURB_ENV = dict(TURB_NX=8, TURB_NY=8, TURB_NZ=8, TURB_PPC=2, TURB_PZ=2,
                TURB_ENERGY_INTERVAL=1, TURB_FIELD_INTERVAL=2,
                TURB_PARTICLE_INTERVAL=4, TURB_RESTART_INTERVAL=2,
                TURB_TRACER_INTERVAL=2, TURB_SPECTRUM_INTERVAL=4)


def _turb_cli(monkeypatch, out, *args):
    for k, v in {**TURB_ENV, "TURB_OUT": out}.items():
        monkeypatch.setenv(k, str(v))
    return cli.main([str(TURB), "--device", "cpu", "--num-step", "4",
                     "--status-interval", "2", *args])


def test_sharded_cli_restart_reproduces_every_rank_dump(monkeypatch,
                                                        tmp_path):
    """The turbulence deck on two z shards (PEC z walls) through the CLI
    with its diagnostics: one dump per rank of each kind, a restart from
    step 2 that reproduces every step-4 dump of both ranks byte for byte,
    and hydro dumps whose shared node plane is equal on both ranks."""
    from vpic_tpu_torch.io import readers

    first, second = tmp_path / "first", tmp_path / "second"
    assert _turb_cli(monkeypatch, first) == 0
    assert _turb_cli(monkeypatch, second, "--restart",
                     str(first / "restart1" / "restart")) == 0
    dumps = sorted(p.relative_to(first) for p in first.rglob("*")
                   if p.is_file() and (p.name.endswith((".4.0", ".4.1"))
                                       or p.parent.name == "T.4"))
    ranks = [p.name.rsplit(".", 1)[1] for p in dumps
             if p.parts[0] != "spectra"]
    assert ranks.count("0") == ranks.count("1") == 1 + 6 + 4 + 2
    assert len(dumps) == 2 * (1 + 6 + 4 + 2 + 8)
    for rel in dumps:
        assert (first / rel).read_bytes() == (second / rel).read_bytes(), rel
    for name in ("eT", "eB", "iT", "iB"):
        base = first / "hydro" / f"{name}hydro.4"
        (h0, lo), (_, hi) = (readers.read_hydro(f"{base}.{r}")
                             for r in range(2))
        nz = h0["nz"]
        for k, v in lo.items():
            np.testing.assert_array_equal(v[nz + 1, 1:, 1:], hi[k][1, 1:, 1:],
                                          err_msg=f"{name} {k}")


def test_dryrun_multichip_counterpart():
    """engine/distributed.dryrun_multichip: the 2D (y, x) layout for two
    whole super-cycles and the z-sharded 3D case, each held to its
    one-shard run."""
    out = tdist.dryrun_multichip(2, device="cpu", log=lambda m: None)
    assert set(out) == {"2d", "3d-z"}
    assert all(np.isfinite(v) for e in out.values() for v in e.values())


def test_compare_layouts_counterpart():
    """engine/distributed.compare_layouts, the check of shards spread
    over several devices against the same shards on one, at a small size
    on two CPU "devices": equal checksums and a time per window."""
    out = tdist.compare_layouts(["cpu", "cpu"], steps=2, windows=1,
                                log=lambda m: None, nx=8, ny=8, npart=512,
                                device="cpu")
    assert out["spread"]["sums"] == out["one device"]["sums"]
    assert out["spread"]["mesh"] == ["cpu"] * 4
    assert all(len(v["step_s"]) == 1 for v in out.values())


def test_time_phases_on_shards():
    sim = deck(port, px=2)
    t = sim.time_phases(1)
    assert {"advance_e", "synchronize_jf", "advance_p[electron]"} <= set(t)
    assert all(v >= 0 for v in t.values())


if __name__ == "__main__":
    # each case's largest distance from the JAX package, in the units of
    # the module's bars, on the conftest's 8-device CPU mesh:
    #   JAX_PLATFORMS=cpu python -c "import tests.conftest, runpy;
    #   runpy.run_module('tests.test_torch_shard', run_name='__main__')"
    def fx(f):
        return f._get_wrapped_function()()

    two, eight = fx(two_shard), fx(eight_shard)
    cases = {"two shards, step 5": (two[5]["t"], two[5]["j"], 1),
             "two shards, step 20": (two[20]["t"], two[20]["j"], 1),
             "eight shards, step 3": (eight[3][1], eight[3][0], 1),
             "eight shards 3D, step 4": (eight[4][1], eight[4][0], 1)}
    for name, f, k in (("reflect/absorb", bounded_runs, 1),
                       ("cycled", cycled_runs, 2),
                       ("join_domain loops", joined_runs, 1),
                       ("absorb tally", tally_runs, 1),
                       ("load imbalance", skewed_runs, 1)):
        j, t, _ = fx(f)
        cases[name] = (t, j, k)
    for name, (t, j, k) in cases.items():
        w = check_against_jax(t, j, species=k)
        print(f"{name}: fields {w['fields']:.1f} ulps, particles "
              f"{w['particles']:.1f} ulps, energies {w['energy_rel']:.3e}")
