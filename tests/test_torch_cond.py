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
- ``vpic_tpu_torch.entry.entry()`` against ``__graft_entry__.entry()``
  over 8 steps at the slice bars of test_torch_slice.py: the same
  particles at start (momenta, uncentered by each package's initial
  interpolator, to 1e-6 relative); energies to 1e-6 relative, particles
  as sets by voxel and position and fields to 1e-5 absolute after 8
  steps.  The JAX side runs with Pallas disabled (tests/conftest.py), so
  its step sorts only the ions, on their own interval; the port's sorts
  on the deck's cadence, which moves lanes, not values.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as ge

from vpic_tpu_torch import entry as tentry
from vpic_tpu_torch.core.types import FIELD_COMPONENTS
from vpic_tpu_torch.decks import bench_deck
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
