"""Device ms per graphed step in the program's span ``step.push``, summed
over the step's spans, median over the graphed steps without a clean."""

from picbench.metrics import _spans


def read(rec):
    return _spans.per_step_ms(rec, {"step.push"}, clean=False)
