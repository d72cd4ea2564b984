"""Device ms per graphed clean step in the program's clean spans (the
div-E and div-B cleans with their Marder passes and the shared-face sync,
inside conditional nodes), summed, median over the graphed clean steps."""

from picbench.metrics import _spans


def read(rec):
    return _spans.per_step_ms(rec, set(_spans.CLEANS), clean=True)
