"""The time step of one shard (``vpic_tpu/engine/step.py``;
vpic_simulation::advance, advance.cxx:13-244):

  sort (cadence below) -> user particle collisions -> advance_p per
  species -> emitters -> user particle injection -> boundary rounds x
  num_comm_round + finish -> clear_jf + unload_accumulator +
  synchronize_jf -> user current injection -> advance_b(1/2) ->
  advance_e -> user field injection -> advance_b(1/2) -> (interval) div-E
  clean -> (interval) div-B clean -> (interval) shared-face sync ->
  load_interpolator

The push takes one of three paths (:func:`resolve_paths`):

- fused (the default): the CUDA push+walk kernel on the card;
- unfused (``fused_push=False``): the plain push math and first streak
  segment, segment 1's currents through the CUDA deposit kernel, the
  lanes still moving through the kernel's walk_only entry;
- packed (``make_advance(packed=True)``, which the deck API uses under
  ``merge_sort=True``): the fused kernel on ``PackedSpecies`` rows, sorted
  by the merge re-sort (its CUDA assembly kernel) or a full sort.

Field faces may be periodic or local (PEC, symmetric, PMC, absorbing).
Particle faces may be periodic, reflecting, absorbing or custom
(``boundary/models.py``).  Absorbing and custom faces, emitters and the
injection hook need the boundary rounds (``particles/boundary.py``),
whose walks run on the kernel's walk_only entry; the packed cycle refuses
them and the collision hook, as the JAX package's does.  On a sharded
grid every shard runs this step in its own thread
(``engine/distributed.py``) with its ``ShardComm`` as ``comm`` and
``pcomm``: the field exchanges and the sums go through it, and ``pcomm``
turns the boundary rounds on, which carry the lanes that cross to
another shard; the decisions that hold its turns take the cond of every
shard (:func:`make_advance`).
"""

from __future__ import annotations

import dataclasses
import inspect
from typing import NamedTuple, Optional

import torch
from torch.profiler import record_function

from ..comm import facecomm
from ..core import random as rnd
from ..core.types import (FieldState, Grid, NEIGHBOR_REFLECT, PackedSpecies,
                          PERIODIC_FIELDS, SimState)
from ..field import ghost, stencil, sync
from ..particles import aux as paux
from ..particles import boundary as pboundary
from ..particles import push as ppush
from ..particles import push_cuda
from ..sf import interp as sfi
from .cond import cond

# profiler scopes of the step's parts: a torch.profiler trace attributes
# each device kernel to the scope that launched it.  The first three run
# on every path; the others only where the deck has a collision hook,
# emitters or an injection hook, or boundary rounds.
PHASES = ("step.sort", "step.push", "step.field", "step.collide",
          "step.emit", "step.boundary")
CORE_PHASES = PHASES[:3]
HOOKS = ("user_particle_collisions", "user_particle_injection",
         "user_current_injection", "user_field_injection")


@dataclasses.dataclass(frozen=True)
class StepOptions:
    """Runtime controls (vpic.cxx:13-48 defaults)."""

    # boundary rounds per step (num_comm_round, vpic.cxx:17)
    num_comm_round: int = 3
    # capacity of a round's pending buffer (the particle injector)
    max_inj: int = 16384
    # lanes sent per face per round between shards (None: the buffer's
    # capacity); the rest are retried in the next round
    # (boundary_p.c:341-385)
    mig_cap: Optional[int] = None
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
    if (step // k) % cycle_mult(opts, sort_intervals) == 0:
        return (True,) * len(sort_intervals)
    return tuple(si <= k for si in sort_intervals)


def cycle_mult(opts: StepOptions, sort_intervals) -> int:
    """M of :func:`sort_flags`: the smallest multiple ceil(sort_interval/k)
    among the species whose sort_interval exceeds k = resort_interval, 1
    where there is none or k <= 1 (the JAX package's ``_cycle_mult``,
    ``vpic_tpu/deck/api.py:642-648``)."""
    k = opts.resort_interval
    slow = [-(-si // k) for si in sort_intervals if si > k]
    return min(slow) if slow and k > 1 else 1


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


def sort_predicates(step, g: Grid, opts: StepOptions,
                    sort_intervals) -> tuple:
    """:func:`step_sort_flags` decided on the card from the state's step
    (a 0-d int32 tensor): per species a 0-d bool tensor, or a constant
    where the path fixes it (every species every step).  The JAX step
    reads ``state.step`` on the device (``vpic_tpu/engine/step.py:
    252-255``)."""
    paths = resolve_paths(g, opts)
    n = len(sort_intervals)
    if paths.fused:
        k = opts.resort_interval
        if k <= 1:
            return (True,) * n
        hit = step % k == 0
        M = cycle_mult(opts, sort_intervals)
        every = hit & ((step // k) % M == 0) if M > 1 else hit
        return tuple(hit if si <= k else every for si in sort_intervals)
    if paths.sorted_deposit:
        return (True,) * n
    return tuple(step % si == 0 if si > 0 else False
                 for si in sort_intervals)


def graph_sort_flags(step: int, g: Grid, opts: StepOptions,
                     sort_intervals) -> tuple:
    """The sort flags that key a graph of a deck, as the JAX
    package's dispatch units fix them (``vpic_tpu/deck/api.py:612, 684,
    717, 732``): :func:`step_sort_flags` on the paths that sort on the
    resort cadence or every step; on the unfused path without the sorted
    deposit, None for a species with its own sort interval (the step
    decides it on the card, as the JAX step's ``lax.cond`` does) and
    False for the others."""
    paths = resolve_paths(g, opts)
    if paths.fused or paths.sorted_deposit:
        return step_sort_flags(step, g, opts, sort_intervals)
    return tuple(None if si > 0 else False for si in sort_intervals)


def _same(x):
    return x


def _rms(g: Grid, comm, local):
    err, vol = local
    return stencil.finish_rms(g, comm.allsum(err), comm.allsum(vol))


def clean_div_e(state: SimState, g: Grid, comm) -> FieldState:
    """advance.cxx:151-173: rho accumulation and up to two Marder passes,
    each taken only where the rms error before it is above 0, nested as
    the JAX package's ``lax.cond``s (``vpic_tpu/engine/step.py:75-96``):
    ``engine/cond.cond`` with the shard's ``comm``, whose passes hold the
    rendezvous' turns (the sums, the halo exchanges), so that on a
    sharded grid one node holds every shard's pass.  The rms error is the
    same on every shard (``ShardComm.allsum``), so every shard takes the
    same branch."""
    f = sfi.clear_rhof(state.field, g)
    for sp in state.species:
        if isinstance(sp, PackedSpecies):
            sp = ppush.unpack_species(sp, g)
        f = paux.accumulate_rho_p(f, sp, g)
    f = sync.synchronize_rho(f, g, comm)
    mat, matg = state.materials, state.material_grid
    f = stencil.compute_div_e_err(f, g, mat, matg, comm)
    rms = _rms(g, comm, stencil.local_rms_div_e_err(f, g))

    def marder(f):
        f1 = stencil.compute_div_e_err(stencil.clean_div_e(f, g, mat, matg),
                                       g, mat, matg, comm)
        rms1 = _rms(g, comm, stencil.local_rms_div_e_err(f1, g))
        return cond(rms1 > 0,
                    lambda f1: stencil.clean_div_e(f1, g, mat, matg),
                    _same, (f1,), comm=comm)

    return cond(rms > 0, marder, _same, (f,), comm=comm)


def clean_div_b(f: FieldState, g: Grid, comm) -> FieldState:
    """advance.cxx:177-195, nested as :func:`clean_div_e`'s passes
    (``vpic_tpu/engine/step.py:99-116``)."""
    f = stencil.compute_div_b_err(f, g)
    rms = _rms(g, comm, stencil.local_rms_div_b_err(f, g))

    def marder(f):
        f1 = stencil.compute_div_b_err(stencil.clean_div_b(f, g, comm), g)
        rms1 = _rms(g, comm, stencil.local_rms_div_b_err(f1, g))
        return cond(rms1 > 0, lambda f1: stencil.clean_div_b(f1, g, comm),
                    _same, (f1,), comm=comm)

    return cond(rms > 0, marder, _same, (f,), comm=comm)


def needs_boundary(g: Grid, pcomm=None, emitters=(), boundary_handlers=(),
                   user_particle_injection=None) -> bool:
    """Whether anything can leave a lane pending after the push or add one
    mid-step: migration, absorbing or custom faces, handlers, emitters or
    injection (``vpic_tpu/engine/step.py:178-184``).  Periodic and
    reflecting faces resolve inside the walk; without rounds a lane left
    pending is a dropped mover (advance.cxx:98-103)."""
    return (pcomm is not None or bool(boundary_handlers) or bool(emitters)
            or user_particle_injection is not None
            or any(b not in (PERIODIC_FIELDS, NEIGHBOR_REFLECT)
                   for b in g.pbc))


def _injection(hook):
    """The injection hook as ``(state, acc, f) -> (state, acc, f)``: a
    hook of one parameter takes and returns the state (both signatures of
    ``vpic_tpu/engine/step.py:344-356``)."""
    params = inspect.signature(hook).parameters.values()
    if len(params) >= 3 or any(p.kind == p.VAR_POSITIONAL for p in params):
        return hook
    return lambda state, acc, f: (hook(state), acc, f)


def make_advance(g: Grid, comm, opts: StepOptions = StepOptions(),
                 pcomm=None, emitters=(), boundary_handlers=(),
                 packed: bool = False, **hooks):
    """The advance function ``(state, do_sort=None, step=None) -> state``
    of one shard (``comm``: its ``ShardComm``; ``pcomm``: the same on a
    sharded grid).  ``do_sort`` holds one flag per species
    (:func:`step_sort_flags`), a flag None (or ``do_sort`` None) decided
    on the card from ``state.step`` (:func:`sort_predicates`); ``step``,
    the host's count of the state's step, sets the interval cleans and
    the shared-face sync, and where it is None they are decided on the
    card from ``state.step``, as the JAX step decides them, on every grid.
    A decision on the card is an ``engine/cond.cond``: conditional nodes
    in a CUDA graph, both branches and a select eagerly; nothing is read
    back.  The cleans, the sync and the Marder passes hold the
    rendezvous' turns (the sums, the halo exchanges), so they take the
    cond with ``comm``: on a sharded grid one node holds every shard's
    part, as the JAX package's ``lax.cond`` inside ``shard_map`` has every
    shard take one branch.  A species' own sort interval (the unfused
    path) holds no turn: a cond of the shard alone.  ``packed``: the
    species are ``PackedSpecies``,
    which needs the fused push and a closed configuration.  ``hooks``: the
    deck's ``user_*`` sections (deck_wrapper.cxx:16-36): collisions
    ``state -> state`` after the sort, injection ``(state, acc, f) ->
    (state, acc, f)`` or ``state -> state`` after the emitters, current
    and field injection ``state -> state`` after the current unload and
    after advance_e."""
    ghost.check_faces(g)
    unknown = sorted(set(hooks) - set(HOOKS))
    if unknown:
        raise TypeError(f"unknown deck hooks {unknown}")
    collide = hooks.get("user_particle_collisions")
    inject = hooks.get("user_particle_injection")
    inject_j = hooks.get("user_current_injection")
    inject_f = hooks.get("user_field_injection")
    boundary = needs_boundary(g, pcomm, emitters, boundary_handlers, inject)
    n_walk = walk_segments(g, opts)
    paths = resolve_paths(g, opts)
    if packed and (not paths.fused or boundary or collide is not None):
        raise ValueError("the packed advance needs the fused push and a "
                         "closed configuration (no boundary rounds, "
                         "emitters, injection or collisions)")
    if inject is not None:
        inject = _injection(inject)

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
                                   fused=paths.fused,
                                   count_pending=not boundary)

    # the columns that the emitters, the injector and the rounds write in
    # place; the injector and lanes from another shard write the tags too
    written = pboundary.WRITTEN + (
        ("tag",) if inject is not None or pcomm is not None else ())

    def rounds(state: SimState, f, acc, nb):
        """num_comm_round boundary rounds over every species, then the
        leftovers counted (``vpic_tpu/engine/step.py:358-383``).  Each
        (round, species) draws from its own key of one split of the
        state's random state, split as the JAX package splits it.  The
        rounds scatter into the species' columns in place (the step owns
        them)."""
        rng, key = rnd.split(state.rng)
        bstate = state.boundary_state
        species = list(state.species)
        for _ in range(opts.num_comm_round if species else 0):
            for k, sp in enumerate(species):
                key, k2 = rnd.split(key)
                species[k], f, acc, bstate = pboundary.process_boundary(
                    sp, f, acc, nb, g, pcomm, opts.max_inj, n_walk,
                    handlers=boundary_handlers, bstate=bstate, key=k2,
                    step=state.step, mig_cap=opts.mig_cap)
        species = tuple(pboundary.finish_boundary(sp) for sp in species)
        return dataclasses.replace(state, species=species, rng=rng,
                                   boundary_state=bstate), f, acc

    def advance(state: SimState, do_sort=None, step=None) -> SimState:
        nb = state.grid_arrays.neighbor
        acc = torch.zeros((g.nv, 12), dtype=torch.float32,
                          device=state.interpolator.device)
        # the field as the step starts: as in the JAX package, the
        # emitters, the injection hook and the rounds take it from here
        f = state.field
        given = state
        flags = (None,) * len(state.species) if do_sort is None else do_sort
        if any(ds is None for ds in flags):
            on_card = sort_predicates(
                state.step, g, opts, [sp.sort_interval for sp in
                                      state.species])
            flags = [c if ds is None else ds
                     for ds, c in zip(flags, on_card)]
        species = []
        for sp, ds in zip(state.species, flags):
            if isinstance(ds, torch.Tensor):
                with record_function(PHASES[0]):
                    sp = cond(ds, sort, _same, (sp,))
            elif ds:
                with record_function(PHASES[0]):
                    sp = sort(sp)
            species.append(sp)
        state = dataclasses.replace(state, species=tuple(species))
        if collide is not None:
            with record_function(PHASES[3]):
                state = collide(state)
        species = []
        for sp in state.species:
            with record_function(PHASES[1]):
                sp, acc = push(sp, state.interpolator, acc, nb)
            species.append(sp)
        if boundary:
            # the push made most columns anew; copy those still shared
            # with the state the step received before writing in place
            with record_function(PHASES[5]):
                species = [pboundary.owned(sp, sp0, written)
                           for sp, sp0 in zip(species, given.species)]
        state = dataclasses.replace(state, species=tuple(species))

        if emitters or inject is not None:
            with record_function(PHASES[4]):
                for emitter in emitters:
                    state, acc, f = emitter(state, acc, f)
                if inject is not None:
                    # the injector finds its shard's box through the comm
                    with facecomm.bound(pcomm):
                        state, acc, f = inject(state, acc, f)
        if boundary:
            with record_function(PHASES[5]):
                state, f, acc = rounds(state, f, acc, nb)

        with record_function(PHASES[2]):
            f = sfi.clear_jf(f, g)
            if state.species:
                f = sfi.unload_accumulator(f, acc, g)
            f = sync.synchronize_jf(f, g, comm)
        if inject_j is not None:
            state = inject_j(dataclasses.replace(state, field=f))
            f = state.field
        with record_function(PHASES[2]):
            f = stencil.advance_b(f, g, 0.5)
            f = stencil.advance_e(f, g, state.materials,
                                  state.material_grid, comm)
        if inject_f is not None:
            state = inject_f(dataclasses.replace(state, field=f))
            f = state.field
        with record_function(PHASES[2]):
            f = stencil.advance_b(f, g, 0.5)

            cleans = (
                (opts.clean_div_e_interval, lambda f: clean_div_e(
                    dataclasses.replace(state, field=f), g, comm)),
                (opts.clean_div_b_interval,
                 lambda f: clean_div_b(f, g, comm)),
                (opts.sync_shared_interval,
                 lambda f: sync.synchronize_tang_e_norm_b(f, g, comm)[0]))
            for interval, fn in cleans:
                if interval <= 0:
                    continue
                if step is None:
                    f = cond(state.step % interval == 0, fn, _same, (f,),
                             comm=comm)
                elif step % interval == 0:
                    f = fn(f)

            interp = (sfi.load_interpolator(f, g) if state.species
                      else state.interpolator)
        return dataclasses.replace(state, field=f, interpolator=interp,
                                   step=state.step + 1)

    return advance
