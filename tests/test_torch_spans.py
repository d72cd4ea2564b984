"""The device-clock spans of the step's parts (vpic_tpu_torch/engine/
spans.py) on the CPU, whose host ring stamps as the card's ring does: a
16x16 periodic box of warm electrons cleaning div E and div B and
syncing its shared faces every 3 steps, stepped op by op and through the
static runner (the CPU's stand-in for a graph's replay).

- Each step's parts in order (sort, push, field), without overlap; on
  the runner each step inside its ``graphs.unit``, the unit's
  ``graphs.write_back`` after the parts, every span of a unit graphed;
  op by op nothing graphed and no ``graphs.*`` span.
- The field's span split in two around an injection hook, which runs
  outside it; one sort span (on the steps that sort) and one push span a
  step over two species.
- The clean spans on the clean steps alone, inside the step's last
  ``step.field``: the eager select's untaken branch leaves none.
- ``spans=False``: no records, and the state bitwise that of a run with
  the spans on.
- A ring that wrapped counts the stamps it overwrote in ``dropped``.
- Two shards on one device each record their own parts.
- ``records()`` after a new deck's ``finalize()`` holds that deck's only.
- ``align`` pairs a trace's stamp kernels with the run of stamps spaced
  as they are, on a synthetic card ring.
"""

import time

import numpy as np
import pytest
import torch

from vpic_tpu_torch.deck.api import Simulation
from vpic_tpu_torch.engine import spans
from vpic_tpu_torch.engine.step import CLEANS
from vpic_tpu_torch.interop import state_to_numpy

from tests.torch_decks import hooked_shards

STEPS = 4                                   # cleans on steps 0 and 3
PARTS = ["step.sort", "step.push", "step.field"]
# two shards migrate their lanes in boundary rounds, before the field
SHARDED = PARTS[:2] + ["step.boundary"] * 2 + PARTS[2:]
MODES = ["eager", "runner"]


def deck(monkeypatch, mode, px=1, on=True, hook=None):
    if mode == "runner":
        monkeypatch.setattr(Simulation, "_graph_ok", lambda self: True)
    sim = hooked_shards("cpu", hook=hook, px=px, py=1)
    sim.modify_runparams(clean_div_e_interval=3, clean_div_b_interval=3,
                         sync_shared_interval=3, spans=on)
    assert sim.graphed == (mode == "runner")
    return sim


def advance(sim, mode, n=STEPS):
    if mode == "runner":
        sim.advance_steps(n)
    else:
        sim.advance_eager(n)


def inside(a, b):
    return b.t0_ns <= a.t0_ns and a.t1_ns <= b.t1_ns


@pytest.mark.parametrize("mode", MODES)
def test_parts_in_order_without_overlap(monkeypatch, mode):
    sim = deck(monkeypatch, mode)
    advance(sim, mode)
    rec = spans.records()
    assert rec.dropped == 0
    units = [s for s in rec.spans if s.name == "graphs.unit"]
    assert [u.step for u in units] == (list(range(STEPS))
                                       if mode == "runner" else [])
    for t in range(STEPS):
        parts = [s for s in rec.spans if s.step == t
                 and s.name.startswith("step.") and s.name not in CLEANS]
        assert [s.name for s in parts] == PARTS
        assert all(a.t1_ns <= b.t0_ns for a, b in zip(parts, parts[1:]))
        assert all(s.graphed == (mode == "runner") and s.shard == 0
                   for s in parts)
        if mode == "runner":
            assert all(inside(s, units[t]) for s in parts)


@pytest.mark.parametrize("mode", MODES)
def test_field_span_splits_around_an_injection_hook(monkeypatch, mode):
    ran = []

    def hook(state):
        ran.append(time.perf_counter_ns())
        return state

    sim = deck(monkeypatch, mode, hook=hook)
    advance(sim, mode)
    rec = spans.records().spans
    assert len(ran) == STEPS
    for t, at in enumerate(ran):
        parts = [s for s in rec if s.step == t
                 and s.name.startswith("step.") and s.name not in CLEANS]
        assert [s.name for s in parts] == PARTS + ["step.field"]
        assert parts[2].t1_ns < at < parts[3].t0_ns


@pytest.mark.parametrize("mode", MODES)
def test_one_sort_and_one_push_span_a_step_over_species(monkeypatch, mode):
    """Electrons sorted every 2 steps, ions every 8: one step.sort span on
    the steps that sort any species, none on the others, and one
    step.push span a step around both species' pushes."""
    from vpic_tpu_torch.decks import bench_deck
    if mode == "runner":
        monkeypatch.setattr(Simulation, "_graph_ok", lambda self: True)
    sim = bench_deck.build(nx=16, ny=16, nz=1, npart=2048, device="cpu")
    assert len(sim.state.species) == 2
    assert sim.graphed == (mode == "runner")
    advance(sim, mode, 8)
    rec = spans.records().spans
    for t in range(8):
        names = [s.name for s in rec if s.step == t
                 and s.name.startswith("step.") and s.name not in CLEANS]
        assert names == (PARTS if t % 2 == 0 else PARTS[1:]), t


@pytest.mark.parametrize("mode", MODES)
def test_clean_spans_on_clean_steps_only(monkeypatch, mode):
    sim = deck(monkeypatch, mode)
    advance(sim, mode)
    rec = spans.records().spans
    for name in CLEANS:
        cleans = [s for s in rec if s.name == name]
        assert [s.step for s in cleans] == [0, 3], name
        for s in cleans:
            field = [f for f in rec if f.name == "step.field"
                     and f.step == s.step][-1]
            assert inside(s, field)
    names = [s.name for s in rec if s.name in CLEANS]
    assert names == list(CLEANS) * 2


@pytest.mark.parametrize("mode", MODES)
def test_write_back_on_units_only(monkeypatch, mode):
    sim = deck(monkeypatch, mode)
    advance(sim, mode)
    rec = spans.records().spans
    backs = [s for s in rec if s.name == "graphs.write_back"]
    if mode == "eager":
        assert not backs and not [s for s in rec
                                  if s.name.startswith("graphs.")]
        return
    units = [s for s in rec if s.name == "graphs.unit"]
    assert len(backs) == len(units) == STEPS
    for u, b in zip(units, backs):
        assert inside(b, u) and b.graphed and b.step == u.step
        parts = [s for s in rec if s.step == u.step
                 and s.name.startswith("step.")]
        assert all(s.t1_ns <= b.t0_ns for s in parts)


@pytest.mark.parametrize("mode", MODES)
def test_spans_off_record_nothing_and_change_nothing(monkeypatch, mode):
    on = deck(monkeypatch, mode)
    advance(on, mode)
    assert spans.records().spans
    off = deck(monkeypatch, mode, on=False)
    assert not off.opts.spans
    advance(off, mode)
    assert spans.records() == spans.Records([], 0)
    a, b = state_to_numpy(on.state), state_to_numpy(off.state)
    assert a.keys() == b.keys()
    for key in a:
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)


def test_a_wrapped_ring_counts_what_it_overwrote(monkeypatch):
    sim = deck(monkeypatch, "eager")
    advance(sim, "eager", 2)
    whole = spans.records()
    # op by op every span is taken and closed: two stamps each
    stamps = 2 * len(whole.spans)
    assert whole.dropped == 0
    monkeypatch.setattr(spans, "CAPACITY", 4)
    sim = deck(monkeypatch, "eager")
    advance(sim, "eager", 2)
    rec = spans.records()
    assert rec.dropped == stamps - 4
    # the last 4 stamps: the last step's push and field spans, its sort
    # lost to the wrap
    assert [s.name for s in rec.spans] == PARTS[1:]
    assert all(s.step == 1 for s in rec.spans)


@pytest.mark.parametrize("mode", MODES)
def test_two_shards_record_their_own_parts(monkeypatch, mode):
    sim = deck(monkeypatch, mode, px=2)
    advance(sim, mode)
    rec = spans.records().spans
    for shard in (0, 1):
        mine = [s for s in rec if s.shard == shard]
        for t in range(STEPS):
            parts = [s.name for s in mine if s.step == t
                     and s.name.startswith("step.") and s.name not in CLEANS]
            assert parts == SHARDED, (shard, t)
        assert [s.step for s in mine if s.name == CLEANS[0]] == [0, 3]
    units = [s for s in rec if s.name == "graphs.unit"]
    assert len(units) == (STEPS if mode == "runner" else 0)
    assert all(u.shard == 0 for u in units)


def test_records_after_finalize_are_the_new_decks(monkeypatch):
    old = deck(monkeypatch, "eager")
    advance(old, "eager")
    assert {s.step for s in spans.records().spans} == set(range(STEPS))
    new = deck(monkeypatch, "eager")
    advance(new, "eager", 1)
    rec = spans.records()
    assert {s.step for s in rec.spans} == {0}
    assert [s.name for s in rec.spans
            if s.name not in CLEANS] == PARTS


# a synthetic card ring: 30 steps of 80 ms, each 12 stamps at the same
# spacing (steps repeat it, as the card's do) with 1 us of jitter, the
# stamps 4-5 of every third step inside a conditional body
PERIOD_NS, SPACING_NS = 80_000_000, [0, 5e5, 2.1e7, 2.15e7, 2.2e7,
                                    2.3e7, 4e7, 4.1e7, 5.5e7, 6e7, 7e7,
                                    7.9e7]


def _card_ring(rng):
    t, steps, body = [], [], []
    for step in range(30):
        for i, dt in enumerate(SPACING_NS):
            t.append(step * PERIOD_NS + dt + rng.uniform(-500, 500))
            steps.append(step)
            body.append(step % 3 == 0 and i in (4, 5))
    t, body = np.array(t, dtype=np.int64), np.array(body)
    return t, np.array(steps, dtype=np.int64) << 32, body


@pytest.mark.parametrize("bodies", ["unseen", "seen", "misplaced"])
def test_align_pairs_a_trace_with_its_stamps(monkeypatch, bodies):
    """A trace of steps 10-19 whose clock runs 80 ppm slow against the
    card's, that does not show the stamp kernels inside conditional
    bodies, shows them, or shows them a clean's length late: given the
    window's steps, the kernels pair with their stamps (the misplaced ones
    with none), the offset tracked through the drift, and a time of the
    trace maps onto the card's clock."""
    rng = np.random.default_rng(3)
    t, words, body = _card_ring(rng)
    ring = (torch.device("cuda", 0), t, words, 0)
    monkeypatch.setattr(spans, "_stamps", lambda: [ring])
    window = ((words >> 32) >= 10) & ((words >> 32) <= 19)
    seen = np.flatnonzero(window & (~body if bodies == "unseen" else True))
    offset, drift = 1.234e6, 80e-6           # card's clock minus trace's
    card_us = t[seen] / 1e3
    mids = (card_us - offset - drift * (card_us - card_us[0])
            + rng.uniform(-1.0, 1.0, len(seen)))
    if bodies == "misplaced":
        mids[body[seen]] += 2.9e5
    kernels = [("(anonymous namespace)::stamp_kernel(...)", m - 1, m + 1)
               for m in mids]
    kernels += [("push_walk_kernel", 0.0, 3.0)]
    got = spans.align(kernels, steps=(10, 19))
    want = len(seen) - (bodies == "misplaced") * int(body[seen].sum())
    assert got.pairs == want
    assert got.offset_us == pytest.approx(offset, abs=2.0)
    assert got.residual_us <= 4.0
    # a time of the trace onto the card's clock, between two pairs
    k = len(seen) // 2
    t = 0.5 * (mids[k] + mids[k + 1])
    assert got.card_us(t) == pytest.approx(0.5 * (card_us[k] + card_us[k + 1]),
                                           abs=3.0)


def test_align_where_stamps_lie_close(monkeypatch):
    """Stamps 1.5-16 us apart (a small deck's), the two closing stamps of
    the unit before the trace's window 10 and 8.5 us ahead of its first
    (they read the window's first step), the offset half a vote's bin off
    the bin, and two kernels that the trace places 7.5 us from any stamp:
    the start is the bin's most voted us, and no kernel pairs with a
    neighbour of its stamp or with a stamp that is not its own."""
    rng = np.random.default_rng(5)
    spacing_us = [0, 1.5, 3, 16, 17.5, 33, 48, 64, 80, 95, 110, 118]
    t = np.array([step * 120_000 + dt * 1e3 + rng.uniform(-200, 200)
                  for step in range(8) for dt in spacing_us], dtype=np.int64)
    before = np.array([-10_000, -8_500], dtype=np.int64)
    steps = np.repeat(np.arange(8, dtype=np.int64), len(spacing_us))
    ring = (torch.device("cuda", 0), np.concatenate([before, t]),
            np.concatenate([[0, 0], steps]) << 32, 0)
    monkeypatch.setattr(spans, "_stamps", lambda: [ring])
    offset = 400 * spans.ALIGN_BIN_US + 0.49 * spans.ALIGN_BIN_US
    mids = t / 1e3 - offset + rng.uniform(-0.5, 0.5, len(t))
    strays = np.array([120.0 + 40.5, 480.0 + 40.5]) - offset
    got = spans.align([("stamp_kernel", m - 1, m + 1)
                       for m in np.concatenate([mids, strays])],
                      steps=(0, 7))
    assert got.pairs == len(t)
    assert got.residual_us <= 2.0
    assert got.offset_us == pytest.approx(offset, abs=1.0)


@pytest.mark.parametrize("jump_us", [4.5, 17.75, 24.0])
def test_align_follows_a_jump_of_the_traces_clock(monkeypatch, jump_us):
    """The trace's clock jumps against the card's halfway through a window
    of close stamps (17.75 us: near their spacing, as on the card): every
    kernel pairs with its stamp, the jump counted apart from the
    residual, and a time after it maps onto the card's clock by the new
    offset."""
    rng = np.random.default_rng(7)
    spacing_us = [0, 1.5, 3, 16, 17.5, 33, 48, 64, 80, 95, 110, 118]
    t = np.array([step * 120_000 + dt * 1e3 + rng.uniform(-200, 200)
                  for step in range(8) for dt in spacing_us], dtype=np.int64)
    steps = np.repeat(np.arange(8, dtype=np.int64), len(spacing_us))
    ring = (torch.device("cuda", 0), t, steps << 32, 0)
    monkeypatch.setattr(spans, "_stamps", lambda: [ring])
    offset = 2.5e5
    mids = t / 1e3 - offset + rng.uniform(-0.5, 0.5, len(t))
    mids[len(t) // 2:] += jump_us
    got = spans.align([("stamp_kernel", m - 1, m + 1) for m in mids],
                      steps=(0, 7))
    assert (got.pairs, got.jumps) == (len(t), 1)
    assert got.residual_us <= 2.0
    k = len(t) // 2 + 5
    assert got.card_us(mids[k]) == pytest.approx(t[k] / 1e3, abs=1.0)


def test_align_pairs_past_a_step_missing_from_the_trace(monkeypatch):
    """A trace that lost a step's stamp kernels (the next step repeats
    their spacing): the kernels after it pair with their own stamps, not
    a step early, and no jump is counted."""
    rng = np.random.default_rng(9)
    spacing_us = [0, 1.5, 3, 16, 17.5, 33, 48, 64, 80, 95, 110, 118]
    t = np.array([step * 120_000 + dt * 1e3 + rng.uniform(-200, 200)
                  for step in range(8) for dt in spacing_us], dtype=np.int64)
    steps = np.repeat(np.arange(8, dtype=np.int64), len(spacing_us))
    ring = (torch.device("cuda", 0), t, steps << 32, 0)
    monkeypatch.setattr(spans, "_stamps", lambda: [ring])
    shown = steps != 3
    mids = (t / 1e3 - 2.5e5 + rng.uniform(-0.5, 0.5, len(t)))[shown]
    got = spans.align([("stamp_kernel", m - 1, m + 1) for m in mids],
                      steps=(0, 7))
    assert (got.pairs, got.jumps) == (int(shown.sum()), 0)
    tr, card = got.points
    np.testing.assert_allclose(card, t[shown] / 1e3, atol=1.0)
