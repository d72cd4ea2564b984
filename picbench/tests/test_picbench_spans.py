"""The readers of the program's device-clock spans (``span_*``,
``replay_gap_us``) on a synthetic record with known medians, with
``vpic_tpu_torch.engine.spans.records`` in the program's place; each
reads nothing on a deck without its span, and nothing from a program
without the spans."""

import importlib
import sys

import pytest

from vpic_tpu_torch.engine import spans

US = 1000                                   # ns
# five one-step graphed units, 1000 us apart, cleans on steps 0 and 3;
# per step: two sorts, a push, a field, the cleans inside the field, the
# write-back, and the unit ending 100 us before the next begins (50 us
# after step 2)
SORT = {0: 90, 1: 30, 2: 50, 3: 90, 4: 40}            # us, summed
CLEAN = {0: (200, 100, 50), 3: (250, 150, 50)}        # us


def _record():
    out = []

    def add(name, step, t0, t1, graphed=True, shard=0):
        out.append(spans.Span(name, shard, step, graphed, t0 * US, t1 * US))

    for t in range(5):
        b = 1000 * t
        add("graphs.unit", t, b, b + (950 if t == 2 else 900))
        add("step.sort", t, b + 10, b + 10 + SORT[t] - 10)
        add("step.sort", t, b + 100, b + 110)
        add("step.push", t, b + 120, b + 180)
        c = b + 200
        for name, d in zip(_clean_names(), CLEAN.get(t, ())):
            add(name, t, c, c + d)
            c += d
        add("step.field", t, b + 190, max(c, b + 240) + 10)
        add("graphs.write_back", t, b + 800, b + 880)
    # op-by-op spans, which the readers leave out
    add("step.sort", 1, 9000, 9900, graphed=False)
    add("step.clean_div_e", 1, 9900, 9990, graphed=False)
    return spans.Records(sorted(out, key=lambda s: s.t0_ns), 0)


def _clean_names():
    from vpic_tpu_torch.engine.step import CLEANS
    return CLEANS


WANT = {
    "span_sort_ms": 0.04,                   # steps 1, 2, 4: 30, 50, 40 us
    "span_push_ms": 0.06,
    "span_field_ms": 0.06,                  # 190 to 250 us on plain steps
    "span_clean_ms": 0.4,                   # 350 and 450 us
    "span_write_back_ms": 0.08,
    "replay_gap_us": 100.0,                 # 100, 100, 50, 100
}


def read(name):
    return importlib.import_module(f"picbench.metrics.{name}").read({})


@pytest.mark.parametrize("name", list(WANT))
def test_span_readers_give_the_known_medians(monkeypatch, name):
    monkeypatch.setattr(spans, "records", _record)
    assert read(name) == pytest.approx(WANT[name])


def _without(*names):
    rec = _record()
    return lambda: spans.Records(
        [s for s in rec.spans if s.name not in names], 0)


@pytest.mark.parametrize("name,gone", [
    ("span_sort_ms", ("step.sort",)),
    ("span_push_ms", ("step.push",)),
    ("span_field_ms", ("step.field",)),
    ("span_clean_ms", ("step.clean_div_e", "step.clean_div_b",
                       "step.sync_shared")),
    ("span_write_back_ms", ("graphs.write_back",)),
    ("replay_gap_us", ("graphs.unit",)),
])
def test_span_readers_without_their_span_read_nothing(monkeypatch, name,
                                                       gone):
    monkeypatch.setattr(spans, "records", _without(*gone))
    assert read(name) is None


@pytest.mark.parametrize("name", list(WANT))
def test_span_readers_without_graphed_spans_read_nothing(monkeypatch, name):
    rec = _record()
    monkeypatch.setattr(spans, "records", lambda: spans.Records(
        [s._replace(graphed=False) for s in rec.spans], 0))
    assert read(name) is None


@pytest.mark.parametrize("name", list(WANT))
def test_span_readers_of_a_program_without_spans_read_nothing(monkeypatch,
                                                              name):
    # as a program without engine.spans: its import fails, though the
    # record here would give a number
    from vpic_tpu_torch import engine
    monkeypatch.setattr(spans, "records", _record)
    monkeypatch.delattr(engine, "spans")
    monkeypatch.setitem(sys.modules, "vpic_tpu_torch.engine.spans", None)
    assert read(name) is None


def _with_profiled_steps():
    """_record's five steps, then six more (5-10) as the profiler leaves
    them: every part stretched, 2 ms between units, a clean on step 5."""
    rec = _record()
    out = list(rec.spans)

    def add(name, step, t0, t1):
        out.append(spans.Span(name, 0, step, True, t0 * US, t1 * US))

    for t in range(5, 11):
        b = 5000 + 3000 * (t - 5)
        add("graphs.unit", t, b, b + 990)
        add("step.sort", t, b + 10, b + 410)
        add("step.push", t, b + 420, b + 720)
        add("step.field", t, b + 730, b + 930)
        if t == 5:
            add(_clean_names()[0], t, b + 740, b + 2740)
        add("graphs.write_back", t, b + 940, b + 985)
    return spans.Records(sorted(out, key=lambda s: s.t0_ns), 0)


@pytest.mark.parametrize("name", list(WANT))
def test_span_readers_leave_out_the_profiled_steps(monkeypatch, name):
    monkeypatch.setattr(spans, "records", _with_profiled_steps)
    reader = importlib.import_module(f"picbench.metrics.{name}")
    assert reader.read({"profiled_steps": [(5, 11)]}) == pytest.approx(
        WANT[name])
    # the same spans with no steps named as profiled read otherwise
    assert reader.read({"profiled_steps": []}) != pytest.approx(WANT[name])


def test_span_readers_of_one_run_read_the_rings_once(monkeypatch):
    reads = []

    def counted():
        reads.append(1)
        return _record()

    monkeypatch.setattr(spans, "records", counted)
    rec = {}
    got = {name: importlib.import_module(f"picbench.metrics.{name}").read(rec)
           for name in WANT}
    assert got == pytest.approx(WANT)
    assert len(reads) == 1
    read("span_sort_ms")                    # a new run reads anew
    assert len(reads) == 2
