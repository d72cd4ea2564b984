"""The sharded step as CUDA graphs (vpic_tpu_torch/engine/graphs.py over
the shards of one card) on the CPU, through the static runner: where the
card would replay a unit's graph, the CPU runs the unit's steps, every
shard in its thread, with the runner's copy-in and copy-out of the list
of per-shard states (``_graph_ok()`` patched to admit the decks, as
tests/test_torch_graphs.py does).

- A 2 x 2-shard bench deck over two super-cycles, and a two-z-shard deck
  cleaning div E every third step (an ``allsum`` inside the unit), bitwise
  their ``advance_eager`` runs on every shard, dispatched as
  ``graphs.plan`` says.
- The step deciding on the card on shards (``step=None``, the graphs'
  body; on the CPU every cond the select) bitwise the host-keyed
  ``advance_eager``: two z shards cleaning div E, div B and syncing every
  3, 4 and 6 steps, the 2 x 2 bench deck with those cleans, and its
  unfused path whose ions sort on their own interval (a cond of one
  shard); every predicate of a cond of several shards bitwise the same
  on every shard; graphs keyed by the sort flags alone.
- The cycled two-shard deck of tests/test_torch_shard.py through the
  runner for one super-cycle, held to the JAX package's multi-shard
  engine on the conftest's 8-device CPU mesh at that module's bars (16
  float32 ulps of each array's scale, energies 1e-6 relative, voxels
  exact).
- ``dryrun_multichip(2)`` asserting the JAX hook's one dispatch per case.
- A shard that fails inside a unit: the call raises its own exception,
  the static states keep the last whole unit's values and the next
  advance runs.
- A held list of states is a value; an edit between advances is kept; a
  restore and ``modify_runparams`` reload the static buffers; the
  diagnostics read them.
"""

import threading

import numpy as np
import pytest
import torch

from vpic_tpu.deck.api import Simulation as JSim

from vpic_tpu_torch.deck.api import Simulation
from vpic_tpu_torch.decks import bench_deck
from vpic_tpu_torch.engine import distributed as tdist
from vpic_tpu_torch.engine import graphs
from vpic_tpu_torch.engine import step as tstep
from vpic_tpu_torch.interop import state_to_numpy
from vpic_tpu_torch.particles import boundary as tboundary

from tests._torch_shard_common import (alive, bounded, check_against_jax,
                                       cycled, deck, port, run, snap)
from tests.test_torch_shard_equivalence import bounded_runs  # noqa: F401
from tests.torch_decks import hooked_shards

BENCH = dict(nx=8, ny=8, nz=1, npart=1024, px=2, py=2)


@pytest.fixture
def static_runner(monkeypatch):
    """Decks built after this fixture's call take the static runner."""
    def use():
        monkeypatch.setattr(Simulation, "_graph_ok", lambda self: True)
    return use


def assert_same_shards(a, b):
    assert len(a.states) == len(b.states) == a.grid.n_shards
    for r, (x, y) in enumerate(zip(a.states, b.states)):
        dx, dy = state_to_numpy(x), state_to_numpy(y)
        assert dx.keys() == dy.keys()
        for key in dx:
            np.testing.assert_array_equal(dx[key], dy[key],
                                          err_msg=f"shard {r} {key}")
    assert a.step_count == b.step_count


def test_four_shard_bench_deck_through_the_runner_is_eager(static_runner):
    """Two super-cycles (k = 2, M = 4) of the 2 x 2-shard bench deck: two
    replays of one capture, no eager step, bitwise the op-by-op run."""
    eager = bench_deck.build(**BENCH, device="cpu")
    static_runner()
    sim = bench_deck.build(**BENCH, device="cpu")
    assert sim.graphed and not eager.graphed
    out = sim.advance(16)
    eager.advance_eager(16)
    assert_same_shards(sim, eager)
    assert isinstance(out, list) and len(out) == 4
    assert graphs.plan(0, 16, 2, sim._cycle_mult) == [("supercycle", 2)]
    assert sim.dispatch_counts == {"captures": 1, "replays.supercycle": 2,
                                   "graphed_steps": 16}
    assert sim.mover_counts() == {"electron": 0, "ion": 0}
    assert sim.comms[0].rv.slots == [None] * 4


def test_two_z_shards_bitwise_across_a_clean(static_runner):
    """The 8x4x4 deck on two z shards, div E cleaned every third step: the
    clean's global RMS sums both shards (``allsum``) inside the unit, the
    clean decided from the state's step as on the card; 8 steps through
    the runner, 4 of them and then 4, bitwise eager."""
    eager = deck(port, pz=2, clean_div_e_interval=3)
    static_runner()
    whole = deck(port, pz=2, clean_div_e_interval=3)
    split = deck(port, pz=2, clean_div_e_interval=3)
    assert whole.graphed and whole.grid.gpz == 2
    whole.advance(8)
    split.advance(4)
    split.advance(4)
    eager.advance_eager(8)
    assert_same_shards(whole, eager)
    assert_same_shards(split, eager)
    # a step of its own per step (k = 1): one graph, the clean steps
    # (0, 3, 6) and the others alike, the clean a cond inside it
    assert whole.dispatch_counts == {"captures": 1, "replays.step": 8,
                                     "graphed_steps": 8}


CLEANS = dict(clean_div_e_interval=3, clean_div_b_interval=4,
              sync_shared_interval=6)
DECIDED = {
    "two z shards": (lambda: deck(port, pz=2, **CLEANS), 12,
                     {"captures": 1, "replays.step": 12}),
    "2x2 bench deck": (lambda: _bench_with(**CLEANS), 8,
                       {"captures": 1, "replays.supercycle": 1}),
    "2x2 unfused own intervals": (
        lambda: _bench_with(fused_push=False, sorted_deposit=False, **CLEANS),
        8, {"captures": 1, "replays.cycle": 4}),
}


def _bench_with(**opts):
    sim = bench_deck.build(**BENCH, device="cpu")
    sim.modify_runparams(**opts)
    return sim


@pytest.mark.parametrize("name", list(DECIDED))
def test_the_sharded_step_decided_on_the_card_is_host_keyed(
        static_runner, monkeypatch, name):
    """Through the runner, whose body steps with no host step (the cleans,
    the sync, the Marder passes and the ions' own sorts conds on the
    state's step), against ``advance_eager`` (the host's step and flags):
    bitwise on every shard; every cond of several shards was given the
    same predicate on every shard, bitwise."""
    build, steps, dispatch = DECIDED[name]
    eager = build()
    static_runner()
    sim = build()
    assert sim.graphed and sim.grid.n_shards > 1
    preds, orig = {}, tstep.cond

    def spy(pred, true_fn, false_fn, operands=(), comm=None):
        if comm is not None:
            preds.setdefault(comm.rank, []).append(pred.clone())
        return orig(pred, true_fn, false_fn, operands, comm=comm)

    monkeypatch.setattr(tstep, "cond", spy)
    sim.advance(steps)
    monkeypatch.setattr(tstep, "cond", orig)
    eager.advance_eager(steps)
    assert_same_shards(sim, eager)
    assert sim.dispatch_counts == dict(dispatch, graphed_steps=steps)
    assert sorted(preds) == list(range(sim.grid.n_shards))
    first = preds[0]
    # three interval conds a step, and the clean steps' Marder passes
    assert len(first) > 3 * steps
    for r, mine in preds.items():
        assert len(mine) == len(first), r
        assert all(torch.equal(a, b) for a, b in zip(mine, first)), r


def test_cycled_two_shards_through_the_runner_match_jax(static_runner,
                                                        monkeypatch):
    """tests/test_torch_shard.py's cycled deck (resort every 2 steps, ions
    every 4) on two shards, one super-cycle through the runner (4 steps:
    a sort of both species, one of the electrons, lanes received from the
    other shard, counted), held to the JAX package's multi-shard engine.
    Fewer steps cost the JAX package as much (it compiles its sorting and
    its plain step either way) and leave tca too small for the module's
    bar, which is relative to each array's scale."""
    jsim = cycled(JSim, px=2)
    for _ in range(4):
        jsim.advance(1)
    received = []
    orig = tboundary.received_lanes

    def counting(recv):
        cols, valid = orig(recv)
        received.append(int(valid.sum()))
        return cols, valid

    monkeypatch.setattr(tboundary, "received_lanes", counting)
    static_runner()
    sim = cycled(port, px=2)
    sim.advance(4)
    assert sim.dispatch_counts == {"captures": 1, "replays.supercycle": 1,
                                   "graphed_steps": 4}
    assert sum(received) > 0
    check_against_jax(snap(sim), snap(jsim), species=2)


def test_bounded_two_shards_through_the_runner_match_jax(static_runner,
                                                        bounded_runs):
    """tests/test_torch_shard.py's bounded deck (reflecting x faces,
    absorbing y, div E cleaned every step: its allsums and Marder passes
    a cond of both shards inside the unit) on two shards through the
    runner for its 6 steps, held to the JAX package's multi-shard engine
    (that module's fixture) at that module's bars."""
    j = bounded_runs[0]
    static_runner()
    sim = bounded(port, px=2)
    assert sim.graphed
    t = run(sim, 6)
    assert sim.dispatch_counts == {"captures": 1, "replays.step": 6,
                                   "graphed_steps": 6}
    check_against_jax(t, j)
    assert alive(t) == alive(j) < 1024


def test_dryrun_multichip_asserts_one_dispatch(static_runner):
    static_runner()
    logged = []
    out = tdist.dryrun_multichip(2, device="cpu", log=logged.append)
    assert set(out) == {"2d", "3d-z"}
    lines = [m for m in logged if "dispatch" in m]
    assert len(lines) == 4
    assert all("'replays.supercycle': 2" in m and "'captures': 1" in m
               for m in lines)


def test_check_one_dispatch_refuses_eager_steps(static_runner):
    static_runner()
    sim = bench_deck.build(**BENCH, device="cpu")
    sim.advance(8)
    tdist.check_one_dispatch(sim, 8, "bench")
    sim.advance_eager(1)
    with pytest.raises(AssertionError, match="dispatch"):
        tdist.check_one_dispatch(sim, 8, "bench")
    with pytest.raises(AssertionError, match="not one dispatch"):
        tdist.check_one_dispatch(sim, 9, "bench")


def test_a_failing_shard_inside_a_unit(static_runner):
    """Shard 1's field-injection hook raises in step 3, the second unit of
    ``advance(4)`` from step 2: advance raises that exception (not a
    ShardError), the shards' static states and the step count are those
    of step 3, bitwise an eager twin's, and the next advance runs."""
    armed = [True]

    def hook(state):
        if (armed[0] and int(state.step) == 3
                and threading.current_thread().name == "shard-1"):
            armed[0] = False
            raise KeyError("shard one")
        return state

    eager = hooked_shards("cpu", hook=lambda st: st)
    static_runner()
    sim = hooked_shards("cpu", hook=hook)
    assert sim.graphed
    sim.advance(2)
    with pytest.raises(KeyError, match="shard one"):
        sim.advance(4)
    assert sim.step_count == 3
    assert sim.comms[0].rv.slots == [None] * 4
    eager.advance_eager(3)
    assert_same_shards(sim, eager)
    sim.advance(5)
    eager.advance_eager(5)
    assert_same_shards(sim, eager)
    assert sim.dispatch_counts["eager_steps"] == 0


def test_a_held_list_of_states_is_a_value(static_runner):
    static_runner()
    sim = bench_deck.build(**BENCH, device="cpu")
    sim.advance(2)
    held = sim.states
    before = [state_to_numpy(st) for st in held]
    sim.advance(2)
    for r, st in enumerate(held):
        for key, v in state_to_numpy(st).items():
            np.testing.assert_array_equal(v, before[r][key],
                                          err_msg=f"shard {r} {key}")
    assert not np.array_equal(state_to_numpy(sim.states[0])["field/ex"],
                              before[0]["field/ex"])


def test_an_edit_between_advances_is_kept_on_every_shard(static_runner):
    eager = bench_deck.build(**BENCH, device="cpu")
    static_runner()
    sim = bench_deck.build(**BENCH, device="cpu")
    for s in (sim, eager):
        s.advance(2)
        for r, st in enumerate(s.states):
            st.species[0].ux.mul_(1.0 + 0.25 * r)
            st.field.ex.add_(1e-3)
        s.advance(3)
    assert_same_shards(sim, eager)


def test_restore_and_modify_runparams_on_shards(static_runner, tmp_path):
    """A checkpoint written from the static buffers, restored, and the
    runner rebuilt by modify_runparams: bitwise the eager run throughout."""
    eager = bench_deck.build(**BENCH, device="cpu")
    static_runner()
    sim = bench_deck.build(**BENCH, device="cpu")
    sim.advance(3)
    sim.checkpoint(tmp_path / "ck")
    sim.advance(2)
    sim.restore(tmp_path / "ck")
    assert sim.step_count == 3
    sim.advance(2)
    eager.advance_eager(5)
    assert_same_shards(sim, eager)
    runner = sim._graphs
    for s in (sim, eager):
        s.modify_runparams(clean_div_e_interval=2)
        s.advance(2)
    assert sim._graphs is not runner and not runner.graphs
    assert_same_shards(sim, eager)


def test_sharded_hydro_and_energies_read_the_static_buffers(static_runner):
    """The diagnostics of a graphed sharded deck (energies, the hydro
    dumps' merged faces, movers) read what the eager deck's give."""
    eager = bench_deck.build(**BENCH, device="cpu")
    static_runner()
    sim = bench_deck.build(**BENCH, device="cpu")
    sim.advance(3)
    eager.advance_eager(3)
    assert sim.energies() == eager.energies()
    for a, b in zip(sim._hydro("electron"), eager._hydro("electron")):
        assert torch.equal(a, b)
    assert sim.checksum_fields() == eager.checksum_fields()
