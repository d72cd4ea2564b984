"""The step decided on the card (vpic_tpu_torch/engine/cond.py, the port's
``lax.cond``) on the CPU, where ``cond`` is the select: both branches and
one ``torch.where`` per output tensor.

- ``cond`` gives the branch its predicate names, bitwise, over tensors,
  tuples, dicts and dataclasses, nested too; a slot both branches share
  stays the same tensor; branches of different structures raise; and it
  reads nothing back (every host read of a tensor raises).
- ``engine/step.sort_predicates`` (the sort flags computed from the
  state's step on the device) equals the host's ``step_sort_flags`` on
  every path and cadence.
- The step with every decision taken on the device (``advance(state)``)
  is bitwise the step with the host's decisions (``advance(state, flags,
  step)``) over steps that cross sorts, interval cleans and the
  shared-face sync, on the fused path and on the unfused path whose ions
  sort on their own interval.
- The cond of several shards (``cond(..., comm=...)``) under a capture,
  with the node maker (``cond.NODES``) replaced by a recorder that logs
  every node, allocation routing and branch's work in issue order, on 1,
  2 and 4 shards, plain and nested: each node is opened and closed once,
  by one shard, with one routing of its pool; every shard's part of a
  body lies inside the node; no shard issues after the cond before the
  node is closed; a shard that raises inside a body (or a node that
  cannot be made) fails the call with its own exception in bounded time
  and leaves no node open.
- ``vpic_tpu_torch.entry.entry()`` against ``__graft_entry__.entry()``
  over 8 steps at the slice bars of test_torch_slice.py: the same
  particles at start (momenta, uncentered by each package's initial
  interpolator, to 1e-6 relative); energies to 1e-6 relative, particles
  as sets by voxel and position and fields to 1e-5 absolute after 8
  steps.  The JAX side runs with Pallas disabled (tests/conftest.py), so
  its step sorts only the ions, on their own interval; the port's sorts
  on the deck's cadence, which moves lanes, not values.
"""

import contextlib
import dataclasses
import threading
import time

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as ge

from vpic_tpu_torch import entry as tentry
from vpic_tpu_torch.core.types import FIELD_COMPONENTS, Grid
from vpic_tpu_torch.decks import bench_deck
from vpic_tpu_torch.engine import cond as tcond
from vpic_tpu_torch.engine import distributed as tdist
from vpic_tpu_torch.engine import graphs
from vpic_tpu_torch.engine.cond import cond, select
from vpic_tpu_torch.engine.step import (StepOptions, make_advance,
                                        resolve_paths, sort_predicates,
                                        step_sort_flags)
from vpic_tpu_torch.field import stencil
from vpic_tpu_torch.interop import state_from_numpy, state_to_numpy
from vpic_tpu_torch.particles import push as ppush

from tests import torch_decks  # noqa: F401  (one torch thread)
from tests.test_torch_slice import _sorted_particles
from tests.test_torch_sort import _no_host_reads


@dataclasses.dataclass(frozen=True)
class Pair:
    a: torch.Tensor
    b: torch.Tensor
    name: str = "pair"


def _branches():
    x = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    y = torch.linspace(-1, 1, 5, dtype=torch.float64)

    def true_fn(p, d):
        return Pair(p.a * 2 + 1, p.b), {"y": d["y"] - 3, "n": d["n"]}

    def false_fn(p, d):
        return Pair(p.a - 7, p.b), {"y": d["y"] * 0.5, "n": d["n"] + 1}

    ops = (Pair(x, y.clone()), {"y": y, "n": torch.tensor(4)})
    return true_fn, false_fn, ops


@pytest.mark.parametrize("flag", [True, False])
def test_cond_gives_the_branch_taken(flag):
    true_fn, false_fn, ops = _branches()
    out = cond(torch.tensor(flag), true_fn, false_fn, ops)
    want = (true_fn if flag else false_fn)(*ops)
    got, ref = graphs._leaves(out), graphs._leaves(want)
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype and torch.equal(a, b)
    # the slot both branches pass through is the operand itself, and the
    # structure is the true branch's
    assert out[0].b is ops[0].b and out[0].name == "pair"


def test_nested_cond_gives_the_branch_taken():
    x = torch.arange(6, dtype=torch.float32)
    for p in (True, False):
        for q in (True, False):
            out = cond(torch.tensor(p),
                       lambda v: cond(torch.tensor(q), lambda w: w + 1,
                                      lambda w: w * 3, (v,)),
                       lambda v: (v - 7) * 0.5, (x,))
            want = ((x + 1 if q else x * 3) if p else (x - 7) * 0.5)
            assert torch.equal(out, want), (p, q)


def test_branches_of_different_structures_raise():
    x = torch.zeros(4)
    with pytest.raises(ValueError):
        select(torch.tensor(True), lambda v: v, lambda v: v[:2], (x,))
    with pytest.raises(ValueError):
        select(torch.tensor(True), lambda v: (v, v), lambda v: v, (x,))


def test_cond_reads_nothing_back(monkeypatch):
    """The select, nested, with every host read of a tensor raising."""
    true_fn, false_fn, ops = _branches()
    with monkeypatch.context() as mp:
        _no_host_reads(mp)
        out = cond(ops[1]["n"] > 3,
                   lambda p, d: cond(d["y"].sum() < 0, true_fn, false_fn,
                                     (p, d)),
                   false_fn, ops)
    want = false_fn(*ops)     # y sums to 0: the inner false branch
    for a, b in zip(graphs._leaves(out), graphs._leaves(want)):
        assert torch.equal(a, b)


PATHS = {"fused k=2 M=4": (dict(resort_interval=2), (0, 8)),
         "fused k=3 M=2": (dict(resort_interval=3), (0, 5, 3)),
         "fused k=1": (dict(resort_interval=1), (0, 8)),
         "unfused sorted": (dict(fused_push=False, sorted_deposit=True),
                            (0, 8)),
         "unfused own intervals": (dict(fused_push=False,
                                        sorted_deposit=False), (0, 8, 3))}


@pytest.mark.parametrize("name", list(PATHS))
def test_sort_predicates_are_the_host_flags(name):
    kw, intervals = PATHS[name]
    g = bench_deck.build(nx=8, ny=8, nz=1, npart=64, device="cpu").grid
    opts = StepOptions(**kw)
    for t in range(40):
        on_card = sort_predicates(torch.tensor(t, dtype=torch.int32), g,
                                  opts, intervals)
        assert tuple(bool(f) for f in on_card) == step_sort_flags(
            t, g, opts, intervals), t


STEPS = 10
CLEANS = dict(clean_div_e_interval=3, clean_div_b_interval=4,
              sync_shared_interval=6)


@pytest.mark.parametrize("path", ["fused", "unfused own intervals"])
def test_the_step_decided_on_the_card_is_the_host_keyed_step(path):
    """From one state, STEPS steps of ``advance(state)`` (every decision a
    cond on ``state.step``) against ``advance(state, flags, step)`` with
    the host's flags and step: every tensor bitwise equal after each."""
    sim = bench_deck.build(nx=16, ny=16, nz=1, npart=2048, device="cpu")
    extra = ({} if path == "fused" else
             dict(fused_push=False, sorted_deposit=False))
    opts = dataclasses.replace(sim.opts, **CLEANS, **extra)
    adv = make_advance(sim.grid, sim.comm, opts)
    intervals = [h["sort_interval"] for h in sim._species]
    assert resolve_paths(sim.grid, opts).fused == (path == "fused")
    card = host = sim.state
    for t in range(STEPS):
        card = adv(card)
        host = adv(host, step_sort_flags(t, sim.grid, opts, intervals), t)
        for a, b in zip(graphs._leaves(card), graphs._leaves(host)):
            assert torch.equal(a, b), t
    assert int(card.step) == STEPS


class Recorder:
    """``cond.NODES`` as a log: every capture test true, a stream per
    nesting depth (``body<depth>``; the capture's own is ``capture``),
    each thread's current stream kept per thread, and ``log`` the nodes
    opened and closed, the pools routed and released and the branches'
    work (:meth:`issue`: the shard, what, and the node open on the
    issuing thread's stream), in issue order (the shards' threads run one
    at a time).  ``fail_begin``: the next node cannot be made;
    ``end_error``: what ending a body's capture returns (a CUDA error
    where the failure invalidated it)."""

    def __init__(self):
        self.log, self.open, self.routed = [], {}, set()
        self.local = threading.local()
        self.made = 0
        self.fail_begin = False
        self.end_error = 0

    def _stream(self):
        return getattr(self.local, "stream", "capture")

    def capturing(self, pred):
        return True

    def parent(self, device):
        return self._stream()

    def body(self, device, depth):
        return f"body{depth}", f"pool{depth}"

    def renew(self, device, depth):
        self.log.append(("renew", depth))

    def handle(self, stream):
        return stream

    @contextlib.contextmanager
    def on(self, stream):
        prev, self.local.stream = self._stream(), stream
        try:
            yield
        finally:
            self.local.stream = prev

    def begin(self, parent, body, pred, negate):
        if self.fail_begin:
            raise RuntimeError("cond: the conditional node was not made")
        assert body not in self.open, f"{body} holds an open node"
        self.made += 1
        self.open[body] = self.made
        self.log.append(("open", self.made, parent, body,
                         bool(pred) != negate))

    def end(self, body):
        self.log.append(("close", self.open.pop(body)))
        return self.end_error

    def allocate(self, device, pool):
        assert pool not in self.routed, f"{pool} routed twice"
        self.routed.add(pool)
        self.log.append(("allocate", pool))

    def release(self, device, pool):
        self.routed.remove(pool)
        self.log.append(("release", pool))

    def issue(self, rank, what):
        self.log.append(("work", rank, what,
                         self.open.get(self._stream())))


@pytest.fixture
def recorder(monkeypatch):
    """A :class:`Recorder` as ``cond.NODES``, with tally words on the CPU
    (which the card's capture makes by ``cond.prepare``) and the launch
    counts that the tests touch restored after."""
    from vpic_tpu_torch.particles import push_cuda
    rec = Recorder()
    monkeypatch.setattr(tcond, "NODES", rec)
    monkeypatch.setattr(tcond, "_tallies", {torch.device("cpu"): torch.zeros(
        (tcond.TALLY_SLOTS,), dtype=torch.int64)})
    monkeypatch.setattr(tcond, "_bodies", [])
    for c, name in ((push_cuda.launches, "walk_only"),
                    (tcond.launches, "cond_set_if")):
        monkeypatch.setitem(c, name, 0)
    return rec


def _shard_conds(rec, n, nested, fail=None):
    """Every shard of an ``n``-shard rendezvous calls ``cond(pred, ...,
    comm=comm)`` between work before and after it, each branch counting a
    kernel launch and summing over the shards inside its body (an
    ``allsum``: turns and barriers) and, where ``nested``, calling a cond
    of its own.  ``fail``: (rank, where) of a shard that raises KeyError
    inside that body."""
    from vpic_tpu_torch.particles import push_cuda
    g = Grid(nx=4, ny=4, nz=4, gpx=n)
    comms = tdist.make_comms(g, tdist.make_mesh(g, ["cpu"]), timeout=30)

    def shard(comm):
        r = comm.rank

        def part(what, value):
            comm.allsum(torch.tensor(1.0))
            # issued after the body's last barrier: the node stays open
            # until every shard has issued this
            rec.issue(r, what)
            with push_cuda._lock:
                push_cuda.launches["walk_only"] += 1
            if fail == (r, what):
                raise KeyError(f"shard {r} in {what}")
            return value

        def true_fn(v):
            v = part("true", v * 2)
            if nested:
                v = cond(torch.tensor(False),
                         lambda w: part("inner true", w + 1),
                         lambda w: part("inner false", w - 1), (v,),
                         comm=comm)
            return v

        rec.issue(r, "before")
        # shard 0's predicate makes the node
        out = cond(torch.tensor(r == 0), true_fn,
                   lambda v: part("false", v + 5),
                   (torch.full((3,), float(r)),), comm=comm)
        rec.issue(r, "after")
        return out

    return lambda: tdist.run_shards(comms, shard)


@pytest.mark.parametrize("nested", [False, True], ids=["plain", "nested"])
@pytest.mark.parametrize("n", [1, 2, 4])
def test_the_cond_of_several_shards_nests_every_shard_in_one_node(
        recorder, n, nested):
    """Under the recorder, each node opens and closes once, made on shard
    0's predicate with one routing of its pool; every shard's part of a
    body lies inside it, nested nodes inside their parent's body; the
    work before the cond precedes the first node and the work after it
    follows the last close; one set kernel per node and one tally word
    per body, with every shard's launches."""
    from vpic_tpu_torch.particles import push_cuda
    rec = recorder
    _shard_conds(rec, n, nested)()
    log = rec.log
    opens = {e[1]: i for i, e in enumerate(log) if e[0] == "open"}
    closes = {e[1]: i for i, e in enumerate(log) if e[0] == "close"}
    # a node per body, each run where it holds: the outer true node (on
    # shard 0's predicate, true), the inner pair (on false), the outer
    # false node; no third node, since no branch passes its operand
    taken = {"true": True, "false": False}
    if nested:
        taken.update({"inner true": False, "inner false": True})
    want = set(taken)
    assert sorted(opens) == sorted(closes) == list(range(1, len(want) + 1))
    assert not rec.open and not rec.routed
    # one set kernel per node; each body one tally word for every shard's
    # launches, taken back from the host counts (the outer true body's
    # inner nodes' set kernels too)
    assert tcond.launches["cond_set_if"] == (2 if nested else len(want))
    assert push_cuda.launches["walk_only"] == 0
    deltas = [d for _, _, d in tcond._bodies]
    assert [d[0] for d in deltas] == [{"walk_only": n}] * len(want)
    assert sorted(d[-1].get("cond_set_if", 0) for d in deltas) == (
        [0, 0, 0, 2] if nested else [0, 0])
    allocs = [e for e in log if e[0] == "allocate"]
    assert len(allocs) == len(opens)
    runs = {e[1]: e[4] for e in log if e[0] == "open"}
    work = [(i, e) for i, e in enumerate(log) if e[0] == "work"]
    for what in want:
        lines = [(i, e) for i, e in work if e[2] == what]
        assert sorted(e[1] for _, e in lines) == list(range(n)), what
        node, = {e[3] for _, e in lines}
        assert opens[node] < min(i for i, _ in lines)
        assert max(i for i, _ in lines) < closes[node]
        assert runs[node] == taken[what], what
    for what in ("before", "after"):
        lines = [(i, e) for i, e in work if e[2] == what]
        assert sorted(e[1] for _, e in lines) == list(range(n))
        assert all(e[3] is None for _, e in lines)
    assert max(i for i, e in work if e[2] == "before") < min(opens.values())
    assert min(i for i, e in work if e[2] == "after") > max(closes.values())
    if nested:
        # the inner nodes open inside the outer true node, on its stream
        outer_true = next(e[1] for e in log if e[0] == "open")
        inner = [e for e in log if e[0] == "open" and e[2] == "body0"]
        assert len(inner) == 2
        assert all(opens[outer_true] < opens[e[1]] < closes[e[1]]
                   < closes[outer_true] for e in inner)


@pytest.mark.parametrize("where", ["true", "false", "inner true",
                                   "true, capture invalidated",
                                   "node not made"])
@pytest.mark.parametrize("n", [2, 4])
def test_a_shard_failing_inside_a_shared_node(recorder, n, where):
    """The last shard raises KeyError after its sum inside a body (or the
    recorder refuses the outer true node): the call raises that exception
    within seconds, every node opened is closed, no pool stays routed,
    and the bodies' pools are renewed; a body whose capture the failure
    invalidated is counted once, by the shard that closed it; the same
    shards then run the conds again."""
    rec = recorder
    fail = where.split(",")[0]
    run = _shard_conds(rec, n, nested=True,
                       fail=(None if where == "node not made"
                             else (n - 1, fail)))
    rec.fail_begin = where == "node not made"
    rec.end_error = 901 if "invalidated" in where else 0
    invalid = tcond.invalid_bodies
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError if rec.fail_begin else KeyError) as err:
        run()
    assert time.perf_counter() - t0 < 10
    assert "ShardError" not in type(err.value).__name__
    assert not rec.open and not rec.routed
    opened = [e[1] for e in rec.log if e[0] == "open"]
    assert sorted(e[1] for e in rec.log if e[0] == "close") == opened
    assert bool(opened) == (not rec.fail_begin)
    if opened:
        assert ("renew", 0) in rec.log
    assert tcond.invalid_bodies - invalid == (1 if rec.end_error else 0)
    rec.fail_begin = False
    rec.end_error = 0
    rec.log.clear()
    ok = _shard_conds(rec, n, nested=True)()
    assert len(ok) == n and not rec.open


@pytest.fixture(scope="module")
def entries():
    """Both packages' entry() on the CPU, then 8 steps of each."""
    jfn, (jst,) = ge.entry()
    jfn = jax.jit(jfn)
    tfn, (tst,) = tentry.entry(device="cpu")
    out = dict(j0=state_to_numpy(jst), t0=state_to_numpy(tst))
    for _ in range(8):
        jst, tst = jfn(jst), tfn(tst)
    out.update(j1=state_to_numpy(jst), t1=state_to_numpy(tst))
    return out


def _energies(d, g, q_ms):
    """The six field energies and each species' kinetic energy of a state
    (as numpy), by the port's diagnostics for both packages' states."""
    st = state_from_numpy(d)
    ef = stencil.finish_energy_f(g, stencil.local_energy_f(
        st.field, g, st.materials, st.material_grid)).tolist()
    ep = [float(ppush.energy_p(sp, st.interpolator, g)) * g.cvac ** 2 / q
          for sp, q in zip(st.species, q_ms)]
    return np.array(ef + ep)


def test_entry_matches_the_jax_entry(entries):
    g = bench_deck.build(**tentry.DECK, device="cpu").grid
    for k in range(2):
        for c in ("dx", "dy", "dz", "i", "q", "np"):
            key = f"species/{k}/{c}"
            np.testing.assert_array_equal(entries["t0"][key],
                                          entries["j0"][key], err_msg=key)
        # uncentered by each package's initial interpolator
        for c in ("ux", "uy", "uz"):
            key = f"species/{k}/{c}"
            np.testing.assert_allclose(entries["t0"][key],
                                       entries["j0"][key], rtol=1e-6,
                                       atol=1e-7, err_msg=key)
    assert int(entries["t1"]["step"]) == int(entries["j1"]["step"]) == 8
    q_ms = (-1.0, 1.0 / 25.0)
    np.testing.assert_allclose(_energies(entries["t1"], g, q_ms),
                               _energies(entries["j1"], g, q_ms), rtol=1e-6,
                               atol=1e-12)
    for k in range(2):
        t = _sorted_particles(entries["t1"], k)
        j = _sorted_particles(entries["j1"], k)
        np.testing.assert_array_equal(t["i"], j["i"])
        for c in ("dx", "dy", "dz", "ux", "uy", "uz", "q"):
            np.testing.assert_allclose(t[c], j[c], rtol=0, atol=1e-5,
                                       err_msg=c)
    for c in FIELD_COMPONENTS:
        np.testing.assert_allclose(entries["t1"][f"field/{c}"],
                                   entries["j1"][f"field/{c}"], rtol=0,
                                   atol=1e-5, err_msg=c)
