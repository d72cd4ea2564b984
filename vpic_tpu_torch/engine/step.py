"""The time step of the single-device configuration
(``vpic_tpu/engine/step.py``; vpic_simulation::advance, advance.cxx:13-244):

  sort (cadence below) -> advance_p per species -> clear_jf +
  unload_accumulator + synchronize_jf -> advance_b(1/2) -> advance_e ->
  advance_b(1/2) -> (interval) div-E clean -> (interval) div-B clean ->
  (interval) shared-face sync -> load_interpolator

The push takes one of three paths (:func:`resolve_paths`):

- fused (the default): the CUDA push+walk kernel on the card;
- unfused (``fused_push=False``): the plain push math and first streak
  segment, segment 1's currents through the CUDA deposit kernel, the
  lanes still moving through the kernel's walk_only entry;
- packed (``make_advance(packed=True)``, which the deck API uses under
  ``merge_sort=True``): the fused kernel on ``PackedSpecies`` rows, sorted
  by the merge re-sort (its CUDA assembly kernel) or a full sort.

Field faces may be periodic or local (PEC, symmetric, PMC, absorbing);
particle faces periodic or reflecting.  Configurations that need boundary
rounds (absorbing or custom particle faces, migration), emitters,
injection or collision hooks, or several devices are not ported:
:func:`make_advance` raises for them.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch
from torch.profiler import record_function

from ..core.types import (FIELD_COMPONENTS, FieldState, Grid,
                          NEIGHBOR_REFLECT, PackedSpecies, PERIODIC_FIELDS,
                          SimState)
from ..field import ghost, stencil, sync
from ..particles import aux as paux
from ..particles import push as ppush
from ..particles import push_cuda
from ..sf import interp as sfi

# profiler scopes of the step's parts: a torch.profiler trace attributes
# each device kernel to the scope that launched it
PHASES = ("step.sort", "step.push", "step.field")


@dataclasses.dataclass(frozen=True)
class StepOptions:
    """Runtime controls (vpic.cxx:13-48 defaults)."""

    # div-E clean, div-B clean and shared-face sync on the steps that are
    # multiples of these (0: never)
    clean_div_e_interval: int = 0
    clean_div_b_interval: int = 0
    sync_shared_interval: int = 0
    # streak segments budgeted per lane (capped by the active axes below)
    n_walk: int = 4
    # re-sort particles by voxel every k steps; a species whose own
    # sort_interval exceeds k sorts on every M-th resort step only
    resort_interval: int = 1
    # every species sorts every step on the unfused push (whose segment 1
    # always deposits through the deposit kernel, exact in any lane order);
    # None = auto: nv <= 120_000 (the JAX package's VMEM budget, kept so
    # both packages sort alike)
    sorted_deposit: Optional[bool] = None
    # the fused push+walk kernel; None = on (the JAX package's
    # fused_vmem_ok is always true); on forces sorted_deposit
    fused_push: Optional[bool] = None
    # the merge re-sort of packed species (and, in the deck API, the packed
    # cycle that carries its key0/ctot); None = off
    merge_sort: Optional[bool] = None


class Paths(NamedTuple):
    fused: bool
    sorted_deposit: bool
    merge_sort: bool


def resolve_paths(g: Grid, opts: StepOptions) -> Paths:
    """The JAX package's resolution of the three switches
    (``vpic_tpu/engine/step.py:152-170, 218-231``)."""
    fused = True if opts.fused_push is None else bool(opts.fused_push)
    sorted_dep = (g.nv <= 120_000 if opts.sorted_deposit is None
                  else bool(opts.sorted_deposit))
    return Paths(fused=fused, sorted_deposit=sorted_dep or fused,
                 merge_sort=bool(opts.merge_sort))


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


def step_sort_flags(step: int, g: Grid, opts: StepOptions,
                    sort_intervals) -> tuple:
    """Which species sort before the push of ``step`` on the path ``opts``
    selects: the :func:`sort_flags` cadence on the fused (and packed) path,
    every species every step on the unfused path with the sorted deposit,
    and otherwise each species with a sort_interval on the multiples of it
    (``vpic_tpu/engine/step.py:242-255``)."""
    paths = resolve_paths(g, opts)
    if paths.fused:
        return sort_flags(step, opts, sort_intervals)
    if paths.sorted_deposit:
        return (True,) * len(sort_intervals)
    return tuple(si > 0 and step % si == 0 for si in sort_intervals)


def walk_segments(g: Grid, opts: StepOptions) -> int:
    """The ``n_walk`` the step passes to the push.  Under the Courant limit
    a particle crosses at most one face per active axis: n_axes+1 segments
    suffice, one more on reflecting walls."""
    n_axes = (g.gnx > 1) + (g.gny > 1) + (g.gnz > 1)
    has_refl = any(b == NEIGHBOR_REFLECT for b in g.pbc)
    return min(opts.n_walk, n_axes + 1 + int(has_refl))


def _interval_hit(step: int, interval: int) -> bool:
    return interval > 0 and step % interval == 0


def _where(cond, a: FieldState, b: FieldState) -> FieldState:
    """``a`` where the 0-d bool ``cond`` holds, else ``b``, per component
    (the JAX package's ``lax.cond`` on a device scalar, without a host
    read)."""
    return a.replace(**{c: torch.where(cond, getattr(a, c), getattr(b, c))
                        for c in FIELD_COMPONENTS
                        if getattr(a, c) is not getattr(b, c)})


def _rms(g: Grid, comm, local):
    err, vol = local
    return stencil.finish_rms(g, comm.allsum(err), comm.allsum(vol))


def clean_div_e(state: SimState, g: Grid, comm) -> FieldState:
    """advance.cxx:151-173: rho accumulation and up to two Marder passes,
    each taken only where the rms error before it is above 0."""
    f = sfi.clear_rhof(state.field, g)
    for sp in state.species:
        if isinstance(sp, PackedSpecies):
            sp = ppush.unpack_species(sp, g)
        f = paux.accumulate_rho_p(f, sp, g)
    f = sync.synchronize_rho(f, g, comm)
    mat = state.materials
    f = stencil.compute_div_e_err(f, g, mat, None, comm)
    rms = _rms(g, comm, stencil.local_rms_div_e_err(f, g))
    f1 = stencil.compute_div_e_err(stencil.clean_div_e(f, g, mat, None), g,
                                   mat, None, comm)
    rms1 = _rms(g, comm, stencil.local_rms_div_e_err(f1, g))
    f2 = _where(rms1 > 0, stencil.clean_div_e(f1, g, mat, None), f1)
    return _where(rms > 0, f2, f)


def clean_div_b(f: FieldState, g: Grid, comm) -> FieldState:
    """advance.cxx:177-195."""
    f = stencil.compute_div_b_err(f, g)
    rms = _rms(g, comm, stencil.local_rms_div_b_err(f, g))
    f1 = stencil.compute_div_b_err(stencil.clean_div_b(f, g, comm), g)
    rms1 = _rms(g, comm, stencil.local_rms_div_b_err(f1, g))
    f2 = _where(rms1 > 0, stencil.clean_div_b(f1, g, comm), f1)
    return _where(rms > 0, f2, f)


def make_advance(g: Grid, comm, opts: StepOptions = StepOptions(),
                 pcomm=None, emitters=(), boundary_handlers=(),
                 packed: bool = False, **hooks):
    """The advance function ``(state, do_sort, step) -> state`` of a
    single-device configuration; ``do_sort`` holds one flag per species
    (:func:`step_sort_flags`) and ``step`` is the host's count of the
    state's step, which sets the interval cleans (the step is never read
    from the device).  ``packed``: the species are ``PackedSpecies``,
    which needs the fused push."""
    ghost.check_faces(g)
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
    paths = resolve_paths(g, opts)
    if packed and not paths.fused:
        raise ValueError("the packed advance needs the fused push")

    def sort(sp):
        if not packed:
            return paux.sort_p(sp)
        if not paths.merge_sort:
            return paux.sort_p_packed(sp, g)
        # the drift of this species' own sort interval sizes the movers
        k = max(opts.resort_interval, sp.sort_interval)
        return paux.sort_p_packed_merge(sp, g, k)

    def push(sp, interp, acc, nb):
        if packed:
            return push_cuda.advance_p_packed(sp, interp, acc, nb, g,
                                              n_walk=n_walk)
        return push_cuda.advance_p(sp, interp, acc, nb, g, n_walk=n_walk,
                                   fused=paths.fused)

    def advance(state: SimState, do_sort, step: int) -> SimState:
        nb = state.grid_arrays.neighbor
        acc = torch.zeros((g.nv, 12), dtype=torch.float32,
                          device=state.interpolator.device)
        species = []
        for sp, ds in zip(state.species, do_sort):
            if ds:
                with record_function(PHASES[0]):
                    sp = sort(sp)
            with record_function(PHASES[1]):
                sp, acc = push(sp, state.interpolator, acc, nb)
            species.append(sp)
        state = dataclasses.replace(state, species=tuple(species))

        with record_function(PHASES[2]):
            f = sfi.clear_jf(state.field, g)
            if species:
                f = sfi.unload_accumulator(f, acc, g)
            f = sync.synchronize_jf(f, g, comm)

            f = stencil.advance_b(f, g, 0.5)
            f = stencil.advance_e(f, g, state.materials, None, comm)
            f = stencil.advance_b(f, g, 0.5)

            if _interval_hit(step, opts.clean_div_e_interval):
                f = clean_div_e(dataclasses.replace(state, field=f), g, comm)
            if _interval_hit(step, opts.clean_div_b_interval):
                f = clean_div_b(f, g, comm)
            if _interval_hit(step, opts.sync_shared_interval):
                f, _ = sync.synchronize_tang_e_norm_b(f, g, comm)

            interp = (sfi.load_interpolator(f, g) if species
                      else state.interpolator)
        return dataclasses.replace(state, field=f, interpolator=interp,
                                   step=state.step + 1)

    return advance
