"""Busy device ms per step in the program's scope ``step.push``, from the
op-by-op traced steps."""

from picbench.metrics import part_ms


def read(rec):
    return part_ms(rec, "step.push")
