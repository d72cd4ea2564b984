"""The step as CUDA graphs (vpic_tpu_torch/engine/graphs.py) on the CPU.

- The dispatch plan equals the JAX package's own loop:
  ``vpic_tpu.deck.api.Simulation.advance`` runs unbound on a stub whose
  dispatch calls record the units, and ``graphs.plan`` must give the same
  units for every resort interval k, cycle multiple M, start step and n.
- A graph's key is the tuple of its steps' host decisions: the sort flags
  of ``step_sort_flags`` and the interval hits of ``_interval_hit``.
- The static runner on the CPU (the card's copy-in and copy-out, the
  unit's steps run eagerly where the card would replay its graph):
  ``advance(n)`` is bitwise ``advance(1)`` n times and the eager path, on
  the 16^2 bench deck (k = 2, M = 4) and on the 8^3 turbulence deck across
  its clean step; a state the caller holds is not changed by later
  advances; an in-place edit between advances is kept; ``restore`` and
  ``modify_runparams`` invalidate the static buffers.
- The static rule ``_graph_ok()``: the decks it admits and refuses.
- The slice: the bench deck at 16^2 with 4096 particles per species,
  ``advance(16)`` in one call through the static runner, against
  ``__graft_entry__._build(...).advance(16)`` at the bars of
  test_torch_slice.py (energies 1e-6 relative; particles as sets by voxel
  and position and fields to 1e-5 absolute).
"""

import importlib
import types

import numpy as np
import pytest
import torch

import __graft_entry__ as ge
from vpic_tpu.deck import api as japi

from vpic_tpu_torch.boundary.models import AbsorbTally
from vpic_tpu_torch.core.types import FIELD_COMPONENTS
from vpic_tpu_torch.deck.api import Simulation
from vpic_tpu_torch.decks import bench_deck
from vpic_tpu_torch.engine import graphs
from vpic_tpu_torch.engine.step import _interval_hit, step_sort_flags
from vpic_tpu_torch.interop import state_to_numpy

from tests import torch_decks

SMALL = dict(nx=16, ny=16, nz=1, npart=512)
SLICE = dict(nx=16, ny=16, nz=1, npart=4096)
TURB = dict(TURB_NX=8, TURB_NY=8, TURB_NZ=8, TURB_PPC=2)


def jax_units(start, n, k, M, cycles):
    """The units that the JAX package's ``Simulation.advance`` dispatches,
    recorded by stand-ins on a stub, and the stub's step count after."""
    rec = []
    stub = types.SimpleNamespace(
        opts=types.SimpleNamespace(resort_interval=k), _cycle_mult=M,
        step_count=start, state=None,
        _advance_cycle=("cycle", 1) if cycles else None,
        _advance_cycle_b=("cycle_b", 1),
        _supercycles_scan=lambda s: ("supercycle", s),
        _cycles_scan_b=lambda m: ("cycle_b", m),
        _cycles_scan=lambda m: ("cycle", m),
        _dispatch_cycle=rec.append,
        _advance_fn=lambda st: rec.append(("step", 1)),
        _advance_fn_nosort=lambda st: rec.append(("step_nosort", 1)))
    japi.Simulation.advance(stub, n)
    return rec, stub.step_count


@pytest.mark.parametrize("start", [0, 1, 3, 8])
@pytest.mark.parametrize("M", [1, 2, 4])
@pytest.mark.parametrize("k", [1, 2, 4])
def test_plan_is_the_jax_dispatch_loop(k, M, start):
    for n in (1, 2, 3, 5, 8, 16, 33, 48):
        for cycles in (True, False):
            units, end = jax_units(start, n, k, M, cycles)
            got = graphs.plan(start, n, k, M, cycles)
            assert got == units, (n, cycles)
            assert sum(c * graphs.unit_steps(kind, k, M)
                       for kind, c in got) == n == end - start


def test_bench_plan_is_super_cycles():
    """48 steps of the bench deck (k = 2, M = 4) from a super-cycle: six
    replays of the graph of one super-cycle."""
    assert graphs.plan(0, 48, 2, 4) == [("supercycle", 6)]
    assert graphs.plan(3, 14, 2, 4) == [("step_nosort", 1), ("cycle_b", 2),
                                        ("supercycle", 1), ("step", 1)]


@pytest.fixture
def static_runner(monkeypatch):
    """Decks built after this fixture's call take the static runner on the
    CPU: ``_graph_ok()`` admits them as it would on the card."""
    def use():
        monkeypatch.setattr(Simulation, "_graph_ok", lambda self: True)
    return use


def assert_same(a, b):
    da, db = state_to_numpy(a.state), state_to_numpy(b.state)
    assert da.keys() == db.keys()
    for key in da:
        np.testing.assert_array_equal(da[key], db[key], err_msg=key)
    assert a.step_count == b.step_count


def test_graph_keys_are_the_step_decisions(static_runner):
    static_runner()
    sim = bench_deck.build(**SMALL, device="cpu")
    sim.modify_runparams(clean_div_e_interval=3, clean_div_b_interval=4,
                         sync_shared_interval=6)
    g, opts = sim.grid, sim.opts
    intervals = [h["sort_interval"] for h in sim._species]
    for start in range(14):
        for n in (1, 2, 8):
            want = tuple((step_sort_flags(t, g, opts, intervals),
                          _interval_hit(t, 3), _interval_hit(t, 4),
                          _interval_hit(t, 6))
                         for t in range(start, start + n))
            assert sim._graph_key(start, n) == want
    # a clean step makes its unit's key differ from its neighbours'
    assert sim._graph_key(2, 1) != sim._graph_key(3, 1)
    assert sim._graph_key(0, 8) != sim._graph_key(8, 8)
    sim.advance(24)
    assert sim.dispatch_counts["captures"] == len(sim._graphs.graphs) == 3
    assert sim.dispatch_counts["replays.supercycle"] == 3
    assert sim.dispatch_counts["eager_steps"] == 0


def test_advance_n_is_advance_1_n_times_on_the_bench_deck(static_runner):
    eager = bench_deck.build(**SMALL, device="cpu")
    static_runner()
    whole, split, ones = (bench_deck.build(**SMALL, device="cpu")
                          for _ in range(3))
    assert whole.graphed and not eager.graphed
    whole.advance(16)
    split.advance(3)
    split.advance(13)
    for _ in range(16):
        ones.advance(1)
    eager.advance(16)
    for sim in (split, ones, eager):
        assert_same(whole, sim)
    assert whole.dispatch_counts == {"captures": 1, "replays.supercycle": 2,
                                     "graphed_steps": 16}
    assert split.dispatch_counts["replays.cycle_b"] == 2
    assert ones.dispatch_counts["graphed_steps"] == 16
    assert eager.dispatch_counts == {"eager_steps": 16}
    assert whole.mover_counts() == {"electron": 0, "ion": 0}


def turbulence(mp, graphed):
    for key, v in TURB.items():
        mp.setenv(key, str(v))
    mod = importlib.reload(importlib.import_module(
        "vpic_tpu_torch.decks.turbulence"))
    if graphed:
        mp.setattr(Simulation, "_graph_ok", lambda self: True)
    sim = mod.deck(device="cpu")
    sim.finalize()
    return sim


def test_advance_n_is_advance_1_n_times_across_a_clean(monkeypatch):
    """Step 0 cleans div E and div B and syncs the shared faces (every 50
    steps): two graphs, one for the clean step and one for the others."""
    eager = turbulence(monkeypatch, False)
    whole = turbulence(monkeypatch, True)
    ones = turbulence(monkeypatch, True)
    assert whole.graphed and not eager.graphed
    whole.advance(4)
    for _ in range(4):
        ones.advance(1)
    eager.advance(4)
    assert_same(whole, ones)
    assert_same(whole, eager)
    assert whole.dispatch_counts["captures"] == 2
    assert whole.dispatch_counts["replays.step"] == 4


def test_a_held_state_is_a_value(static_runner):
    static_runner()
    sim = bench_deck.build(**SMALL, device="cpu")
    sim.advance(2)
    held = sim.state
    before = state_to_numpy(held)
    sim.advance(6)
    after = state_to_numpy(held)
    for key in before:
        np.testing.assert_array_equal(after[key], before[key], err_msg=key)
    assert not np.array_equal(state_to_numpy(sim.state)["field/ex"],
                              before["field/ex"])


def test_an_edit_between_advances_is_kept(static_runner):
    eager = bench_deck.build(**SMALL, device="cpu")
    static_runner()
    sim = bench_deck.build(**SMALL, device="cpu")
    for s in (sim, eager):
        s.advance(2)
        s.state.species[0].ux.mul_(1.5)
        s.state.field.ex.add_(1e-3)
        s.advance(6)
    assert_same(sim, eager)


def test_restore_and_modify_runparams_invalidate(static_runner, tmp_path):
    eager = bench_deck.build(**SMALL, device="cpu")
    static_runner()
    sim = bench_deck.build(**SMALL, device="cpu")
    sim.advance(4)
    sim.checkpoint(tmp_path / "ck")
    at4 = state_to_numpy(sim.state)
    sim.advance(4)
    sim.restore(tmp_path / "ck")
    assert sim.step_count == 4
    for key, v in state_to_numpy(sim.state).items():
        np.testing.assert_array_equal(v, at4[key], err_msg=key)
    sim.advance(4)
    eager.advance(8)
    assert_same(sim, eager)

    runner = sim._graphs
    for s in (sim, eager):
        s.modify_runparams(clean_div_e_interval=3, clean_div_b_interval=5)
        s.advance(8)
    assert sim._graphs is not runner and not runner.graphs
    assert_same(sim, eager)


def mini(**finalize):
    sim = Simulation(device="cpu")
    sim.define_units(1.0, 1.0)
    sim.define_timestep(0.1)
    sim.define_periodic_grid(0, 0, 0, 1, 1, 1, 4, 4, 1)
    sim.define_species("electron", -1.0, 1024)
    return sim


def _absorbing():
    sim = mini()
    sim.set_domain_particle_bc(0, "absorb")
    return sim


def _tally():
    sim = mini()
    sim.set_domain_particle_bc(3, sim.define_boundary(AbsorbTally(1)))
    return sim


DECKS = {
    "bench": (lambda: bench_deck.build(**SMALL, device="cpu"), {}, True),
    "unfused": (lambda: bench_deck.build(**SMALL, device="cpu"),
                dict(fused_push=False), True),
    "field injection": (mini, dict(user_field_injection=lambda st: st),
                        True),
    "merge sort (packed)": (lambda: bench_deck.build(**SMALL, device="cpu"),
                            dict(merge_sort=True), False),
    "four shards": (lambda: bench_deck.build(**SMALL, px=2, py=2,
                                             device="cpu"), {}, False),
    "absorbing face": (_absorbing, {}, False),
    "boundary handler": (_tally, {}, False),
    "collision hook": (mini, dict(user_particle_collisions=lambda st: st),
                       False),
    "injection hook": (mini, dict(user_particle_injection=lambda st: st),
                       False),
}


@pytest.mark.parametrize("name", list(DECKS))
def test_graph_ok_is_a_static_rule(name):
    """On the card a deck runs graphed unless it draws random keys on the
    host (rounds, emitters, injection, collisions), runs the packed merge
    re-sort or has several shards; the CPU always steps eagerly."""
    build, opts, ok = DECKS[name]
    sim = build()
    hooks = {k: v for k, v in opts.items() if k.startswith("user_")}
    if not sim.comms:
        sim.finalize(**hooks)
    runparams = {k: v for k, v in opts.items() if k not in hooks}
    if runparams:
        sim.modify_runparams(**runparams)
    assert not sim.graphed
    sim.mesh = [torch.device("cuda", 0)] * len(sim.mesh)
    assert sim._graph_ok() is ok


@pytest.fixture(scope="module")
def slice_runs():
    jsim = ge._build(**SLICE)
    jsim.advance(16)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(Simulation, "_graph_ok", lambda self: True)
        tsim = bench_deck.build(**SLICE, device="cpu")
    tsim.advance(16)
    assert tsim.dispatch_counts == {"captures": 1, "replays.supercycle": 2,
                                    "graphed_steps": 16}
    return dict(j1=state_to_numpy(jsim.state), t1=state_to_numpy(tsim.state),
                je=jsim.energies(), te=tsim.energies(),
                jnm=jsim.mover_counts(), tnm=tsim.mover_counts(),
                names=["electron", "ion"])


def test_slice_energies_and_movers_match_jax(slice_runs):
    torch_decks.check_energies_and_movers(slice_runs)
    assert slice_runs["tnm"] == {"electron": 0, "ion": 0}


@pytest.mark.parametrize("k", [0, 1], ids=["electron", "ion"])
def test_slice_particles_match_jax_as_sets(slice_runs, k):
    torch_decks.check_particles(slice_runs, k)


def test_slice_fields_match_jax(slice_runs):
    torch_decks.check_fields(slice_runs)
    assert set(FIELD_COMPONENTS) <= {k.split("/")[1] for k in
                                     slice_runs["t1"] if k.startswith(
                                         "field/")}
