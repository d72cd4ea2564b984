"""Device us from the end of one graphed unit's span ``graphs.unit`` to
the begin of the next's, median over units whose steps follow on: the
card's time between two replays."""

import statistics

from picbench.metrics import _spans


def read(rec):
    units = _spans.units(rec)
    gaps = [(v.t0_ns - u.t1_ns) / 1e3
            for (u, n, _), (v, _, _) in zip(units, units[1:])
            if n and v.step == u.step + n]
    return statistics.median(gaps) if gaps else None
