"""The port's two-shard, eight-shard and bounded topologies held to the
JAX package's and to its own one-shard run (the bars are
tests/test_torch_shard.py's), each JAX topology built once in a
module-scoped fixture."""

import numpy as np
import pytest
import torch

from vpic_tpu.deck.api import Simulation as JSim
from vpic_tpu.engine import distributed as jdist

from vpic_tpu_torch.core import random as rnd
from vpic_tpu_torch.engine import distributed as tdist
from vpic_tpu_torch.interop import (stack_numpy, state_to_numpy,
                                    states_from_numpy, states_to_numpy)

from tests._torch_shard_common import (alive, bounded, check_against_jax,
                                       check_against_one, deck, near, port,
                                       run, same_fields, shard_dicts, snap)


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


# -- the cases of tests/multi_device/test_shard*.py ------------------------


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
