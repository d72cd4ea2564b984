"""Device ms per graphed step in the program's span ``graphs.write_back``
(a unit's copy of its outputs into the graph's static state): per
replayed unit over its steps, median over the units."""

import statistics

from picbench.metrics import _spans


def read(rec):
    per = [_spans.ms(back) / steps for _, steps, back in _spans.units(rec)
           if back is not None and steps]
    return statistics.median(per) if per else None
