"""The port's counterpart of ``__graft_entry__.entry()``: the whole step of
the bench deck as one function of the state.

``entry()`` returns ``(fn, (state,))``: ``fn(state) -> state`` is one step
of the bench deck at 32^2 cells with 4096 particles per species
(``decks/bench_deck.build``, the JAX hook's ``_build(nx=32, ny=32, nz=1,
npart=4096)``), and ``state`` the deck's state after finalize.  ``fn``
decides everything on the card from ``state.step``, as the JAX step
does: each species' sort on the deck's cadence (every 2 steps, the ions
every 8; ``engine/step.sort_predicates``) and the interval cleans, each an
``engine/cond.cond``.  So one capture of ``fn`` into a CUDA graph,
replayed, steps the deck at any step count; eagerly (and on the CPU)
both branches of each decision run and the decision selects.  It runs on
the card unless ``device="cpu"``.

    from vpic_tpu_torch.entry import entry
    fn, (state,) = entry()              # entry(device="cpu") on the CPU
    for _ in range(8):
        state = fn(state)

The JAX hook's ``make_advance`` sorts every species every step on its
fused path (``do_sort=True``); the port's step follows the deck's cadence
on the card, as ``Simulation.advance`` does, so ``fn`` replayed is
bitwise ``Simulation.advance`` of the same deck.
"""

from __future__ import annotations

DECK = dict(nx=32, ny=32, nz=1, npart=4096)


def entry(device="cuda"):
    """``(fn, (state,))``: the bench deck's step and its state at step 0
    (module docstring)."""
    from .decks import bench_deck
    from .engine.step import make_advance

    sim = bench_deck.build(**DECK, device=device)
    return make_advance(sim.grid, sim.comm, sim.opts), (sim.state,)
