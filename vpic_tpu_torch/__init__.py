"""vpic_tpu_torch: the PyTorch + CUDA port of vpic_tpu.

The same deck API and state contract as ``vpic_tpu`` (the JAX package,
which stays the reference), run eagerly by PyTorch on the card, one
shard or several in one process.  The particle push+walk+deposit is a
hand-written CUDA kernel on the card (``csrc/push_walk.cu``, built at
first use); everything else is plain PyTorch.  This package imports no
JAX.
"""

from .core.types import FieldState, Grid, SimState, SpeciesState
from .deck.api import Simulation

__all__ = ["FieldState", "Grid", "SimState", "SpeciesState", "Simulation"]
