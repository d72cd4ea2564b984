"""What the program's device-clock spans (``vpic_tpu_torch/engine/
spans.py``) give the per-layer readers of ``span_*`` and
``replay_gap_us``: the graphed, taken spans of the run so far (in a
traced run the set-up's, the warm-up's and the traced window's units,
clean steps among them), per step and per unit.  A program without the
spans gives None, and so does every reader."""

import collections
import statistics

# the spans around the true branch of each interval cond
# (vpic_tpu_torch/engine/step.CLEANS)
CLEANS = ("step.clean_div_e", "step.clean_div_b", "step.sync_shared")


# the last run's record and its graphed spans: the readers of one run
# share one read of the program's rings
_last = [None, None]


def graphed(rec):
    """The graphed spans of the run whose record is ``rec``, by begin,
    read once per run; None where the program has no spans or stamped
    none in a graph."""
    if _last[0] is not rec:
        try:
            from vpic_tpu_torch.engine import spans
        except ImportError:
            return None
        _last[:] = rec, [s for s in spans.records().spans
                         if s.graphed] or None
    return _last[1]


def ms(s) -> float:
    return (s.t1_ns - s.t0_ns) / 1e6


def per_step_ms(rec, names, clean: bool):
    """The median over graphed steps, the clean ones (those with a clean
    span) where ``clean``, else the others, of a step's ms in the spans
    ``names``, summed over the step's spans and shards; None without
    such a span."""
    recs = graphed(rec)
    if recs is None:
        return None
    cleans = {s.step for s in recs if s.name in CLEANS}
    per = collections.defaultdict(float)
    for s in recs:
        if s.name in names and (s.step in cleans) == clean:
            per[s.step] += ms(s)
    return statistics.median(per.values()) if per else None


def units(rec):
    """(unit span, its steps, its write-back span) of every graphed unit,
    by begin: the steps are those of the step spans inside the unit."""
    recs = graphed(rec)
    if recs is None:
        return []
    out = []
    for u in (s for s in recs if s.name == "graphs.unit"):
        inner = [s for s in recs if s is not u and u.t0_ns <= s.t0_ns
                 and s.t1_ns <= u.t1_ns]
        steps = len({s.step for s in inner if s.name.startswith("step.")})
        back = next((s for s in inner if s.name == "graphs.write_back"),
                    None)
        out.append((u, steps, back))
    return out
