"""The port's resort cadence on two shards held to the JAX package's and
to its own one-shard run (the bars are tests/test_torch_shard.py's)."""

import pytest

from vpic_tpu.deck.api import Simulation as JSim

from tests._torch_shard_common import (check_against_jax, check_against_one,
                                       cycled, port, run, snap)


@pytest.fixture(scope="module")
def cycled_runs():
    jsim = cycled(JSim, px=2)
    for _ in range(8):   # the same 8 steps as one dispatch of 2 cycles
        jsim.advance(1)
    return (snap(jsim), run(cycled(port, px=2), 8), run(cycled(port), 8))


def test_multishard_cycle_executables(cycled_runs):
    """The resort cadence (every 2 steps, ions every 4) on two shards for
    two whole super-cycles, both species."""
    j, t, t1 = cycled_runs
    check_against_jax(t, j, species=2)
    check_against_one(t, t1, ("ex", "ey", "cbz", "jfx"), rtol=3e-4,
                      atol=3e-5, e_rtol=2e-4, species=2)
