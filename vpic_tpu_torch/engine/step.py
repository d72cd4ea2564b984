"""The time step of the closed single-device configuration
(``vpic_tpu/engine/step.py``; vpic_simulation::advance, advance.cxx:13-244):

  sort (cadence below) -> advance_p per species (the CUDA push+walk kernel
  on the card) -> clear_jf + unload_accumulator + synchronize_jf ->
  advance_b(1/2) -> advance_e -> advance_b(1/2) -> load_interpolator

Configurations that need boundary rounds (absorbing or custom particle
faces, migration), emitters, injection or collision hooks, non-periodic
field faces or several devices are not ported: :func:`make_advance` raises
for them.
"""

from __future__ import annotations

import dataclasses

import torch
from torch.profiler import record_function

from ..core.types import Grid, NEIGHBOR_REFLECT, PERIODIC_FIELDS, SimState
from ..field import ghost, stencil, sync
from ..particles import aux as paux
from ..particles import push_cuda
from ..sf import interp as sfi

# profiler scopes of the step's parts: a torch.profiler trace attributes
# each device kernel to the scope that launched it
PHASES = ("step.sort", "step.push", "step.field")


@dataclasses.dataclass(frozen=True)
class StepOptions:
    """Runtime controls (vpic.cxx:13-48 defaults)."""

    # streak segments budgeted per lane (capped by the active axes below)
    n_walk: int = 4
    # re-sort particles by voxel every k steps; a species whose own
    # sort_interval exceeds k sorts on every M-th resort step only
    resort_interval: int = 1


def sort_flags(step: int, opts: StepOptions, sort_intervals) -> tuple:
    """Which species sort before the push of ``step`` (the per-species
    cadence of vpic_tpu/deck/api.py:624-741).  With k = resort_interval,
    sorting happens on steps that are multiples of k; a species with
    sort_interval > k has multiple ceil(sort_interval/k), and all such
    species follow the smallest of those multiples M: every species sorts
    on every M-th resort step, the others only on the rest."""
    k = opts.resort_interval
    if k <= 1:
        return (True,) * len(sort_intervals)
    if step % k:
        return (False,) * len(sort_intervals)
    mults = [-(-si // k) if si > k else 1 for si in sort_intervals]
    slow = [m for m in mults if m > 1]
    M = min(slow) if slow else 1
    if (step // k) % M == 0:
        return (True,) * len(sort_intervals)
    return tuple(m == 1 for m in mults)


def walk_segments(g: Grid, opts: StepOptions) -> int:
    """The ``n_walk`` the step passes to the push.  Under the Courant limit
    a particle crosses at most one face per active axis: n_axes+1 segments
    suffice, one more on reflecting walls."""
    n_axes = (g.gnx > 1) + (g.gny > 1) + (g.gnz > 1)
    has_refl = any(b == NEIGHBOR_REFLECT for b in g.pbc)
    return min(opts.n_walk, n_axes + 1 + int(has_refl))


def make_advance(g: Grid, comm, opts: StepOptions = StepOptions(),
                 pcomm=None, emitters=(), boundary_handlers=(), **hooks):
    """The advance function ``(state, do_sort) -> state`` of a closed
    single-device configuration; ``do_sort`` holds one flag per species."""
    ghost.require_periodic(g)
    unported = [k for k, v in hooks.items() if v is not None]
    if pcomm is not None or emitters or boundary_handlers or unported:
        raise NotImplementedError(
            "boundary rounds, emitters and deck hooks are not ported "
            f"(got hooks {unported})")
    if any(b not in (PERIODIC_FIELDS, NEIGHBOR_REFLECT) for b in g.pbc):
        raise NotImplementedError(
            f"particle boundary codes {g.pbc} need boundary rounds, which "
            "are not ported")
    n_walk = walk_segments(g, opts)

    def advance(state: SimState, do_sort) -> SimState:
        nb = state.grid_arrays.neighbor
        acc = torch.zeros((g.nv, 12), dtype=torch.float32,
                          device=state.interpolator.device)
        species = []
        for sp, ds in zip(state.species, do_sort):
            if ds:
                with record_function(PHASES[0]):
                    sp = paux.sort_p(sp)
            with record_function(PHASES[1]):
                sp, acc = push_cuda.advance_p(sp, state.interpolator, acc,
                                              nb, g, n_walk=n_walk)
            species.append(sp)

        with record_function(PHASES[2]):
            f = sfi.clear_jf(state.field, g)
            if species:
                f = sfi.unload_accumulator(f, acc, g)
            f = sync.synchronize_jf(f, g, comm)

            f = stencil.advance_b(f, g, 0.5)
            f = stencil.advance_e(f, g, state.materials, None, comm)
            f = stencil.advance_b(f, g, 0.5)

            interp = (sfi.load_interpolator(f, g) if species
                      else state.interpolator)
        return dataclasses.replace(state, field=f, species=tuple(species),
                                   interpolator=interp, step=state.step + 1)

    return advance
