"""Several shards in one process (``vpic_tpu/engine/distributed.py``; the
reference's 3D domain decomposition, src/grid/partition.c:36-85, and its
mp/MPI layer).

The JAX package runs one program over a ``('z', 'y', 'x')`` device mesh,
on a state whose every leaf is stacked on leading (pz, py, px) axes.  The
port holds a list of per-shard ``SimState``s in rank order (rank = sx +
gpx*(sy + gpy*sz); ``interop.states_to_numpy`` gives the stacked form)
and runs the same per-shard body for every shard, each in its own host
thread, so that the step code stays the single-shard step.  The field
halos, the shared-face merges, the sums and the particle migration meet
at the shards' common :class:`~vpic_tpu_torch.comm.facecomm.Rendezvous`
through their ``ShardComm``s.  The rendezvous runs the threads in turns,
one at a time between two barriers, so the host issues every shard's work
as it would a single shard's.

``make_mesh`` places shard r on ``devices[r % len(devices)]``: every shard
on one card, or one per card where there are as many.  A neighbor's
payload on another device is copied with ``.to``.  Every shard launches
on the caller's current stream of its device (``particles/push_cuda.py``),
so that where every shard lives on the one card a unit of steps is
captured, every shard's work in the eager order, into one CUDA graph
(``engine/graphs.py``), which replays with no thread and no rendezvous.
The step's decisions on the card that hold the rendezvous' turns (the
cleans, the sync, the Marder passes) are there one conditional node
around every shard's part (``engine/cond.py``), as the JAX package's
``lax.cond`` inside its ``shard_map`` has every shard take one branch.

A shard that raises breaks the rendezvous; the call then raises that
shard's exception.  A wait longer than the rendezvous' timeout, or a
barrier that a finished shard never reached, raises
:class:`~vpic_tpu_torch.comm.facecomm.ShardError`.
"""

from __future__ import annotations

import threading
from typing import List, Optional

import torch

from ..comm.facecomm import Rendezvous, ShardComm, ShardError
from ..core.types import Grid
from .step import StepOptions, make_advance


def shard_coords(g: Grid) -> list:
    """(sx, sy, sz) of every shard, in rank order."""
    return [(sx, sy, sz) for sz in range(g.gpz) for sy in range(g.gpy)
            for sx in range(g.gpx)]


def make_mesh(g: Grid, devices=None) -> List[torch.device]:
    """The device of each shard, in rank order: shard r on
    ``devices[r % len(devices)]`` (default: the card), each card by its
    index, so that ``cuda`` and ``cuda:0`` name one card."""
    devices = [_indexed(torch.device(d)) for d in (devices or ["cuda"])]
    return [devices[r % len(devices)] for r in range(g.n_shards)]


def _indexed(d: torch.device) -> torch.device:
    """``d`` with a card named by its index: ``cuda`` is the current card
    (0 where no card is visible, for a mesh that is only named)."""
    if d.type != "cuda" or d.index is not None:
        return d
    return torch.device("cuda", torch.cuda.current_device()
                        if torch.cuda.is_available() else 0)


# the default of make_comms' timeout, in seconds: long enough for a first
# step that builds the kernels
RENDEZVOUS_TIMEOUT = 300.0


def make_comms(g: Grid, mesh, timeout: Optional[float] = None
               ) -> List[ShardComm]:
    """One ``ShardComm`` per shard, meeting at one rendezvous whose waits
    last at most ``timeout`` seconds (default :data:`RENDEZVOUS_TIMEOUT`,
    read at the call)."""
    rv = Rendezvous(len(mesh), RENDEZVOUS_TIMEOUT if timeout is None
                    else timeout)
    return [ShardComm(g, s, rv, d) for s, d in zip(shard_coords(g), mesh)]


def run_shards(comms, fn, *per_shard):
    """``[fn(comm, *args) for each shard]``, each shard in its own thread
    (one shard: in the caller's) with its device as the current CUDA
    device and the caller's current stream on that device as the
    thread's: PyTorch keeps the current stream per thread, so a worker
    would otherwise start on the default stream, off a capture stream
    (``engine/graphs.py``).  The rendezvous runs the threads one at a
    time, in turns between barriers, and drops its payloads and what the
    shards shared (the collective conds', ``engine/cond.py``) at the end
    of every run, a failed one too.
    ``per_shard``: lists of per-shard arguments.  A shard that raises
    aborts the rendezvous; the call raises the first shard's exception
    that is not a ``ShardError``, or else a ``ShardError``."""
    n = len(comms)
    out, errors = [None] * n, [None] * n
    rv = comms[0].rv
    rv.start()
    streams = [torch.cuda.current_stream(c.device)
               if c.device is not None and c.device.type == "cuda" else None
               for c in comms]

    def body(r):
        comm = comms[r]
        try:
            rv.enter(r)
            if streams[r] is not None:
                with torch.cuda.device(comm.device), \
                        torch.cuda.stream(streams[r]):
                    out[r] = fn(comm, *(a[r] for a in per_shard))
            else:
                out[r] = fn(comm, *(a[r] for a in per_shard))
            rv.finish(r)
        except BaseException as e:     # noqa: BLE001 - re-raised below
            errors[r] = e
            rv.abort(r, e)

    try:
        if n == 1:
            body(0)
        else:
            threads = [threading.Thread(target=body, args=(r,),
                                        name=f"shard-{r}") for r in range(n)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
    finally:
        rv.clear()
    failed = [e for e in errors if e is not None]
    if failed:
        root = [e for e in failed if not isinstance(e, ShardError)]
        raise (root or failed)[0]
    return out


def make_distributed_init(g: Grid, comms):
    """``states -> states``: the initialization pass (``engine/init.py``)
    on every shard."""
    from .init import initialize_state

    def init(states):
        return run_shards(comms, lambda c, st: initialize_state(st, g, c),
                          states)
    return init


def make_distributed_advance(g: Grid, comms,
                             opts: StepOptions = StepOptions(), **kw):
    """``(states, do_sort, step) -> states``: one step of every shard
    (``step`` None: the cleans and the sync decided on the card),
    each shard's comm its ``comm`` and, on a sharded grid, its ``pcomm``,
    which turns migration on (``kw``: the emitters, handlers and deck
    hooks of ``make_advance``)."""
    advs = [make_advance(g, c, opts, pcomm=c if g.is_multishard else None,
                         **kw) for c in comms]

    def advance(states, do_sort, step):
        return run_shards(comms, lambda c, adv, st: adv(st, do_sort, step),
                          advs, states)
    return advance


def make_distributed_hydro(g: Grid, comms, sid: int):
    """``states -> [hydro]``: each shard's (nv, 14) hydro moments of
    species ``sid``, with the shared faces merged across shards before a
    dump (sf_interface.h:156-163)."""
    from ..particles import aux as paux
    from ..sf import hydro as sfhydro

    def hydro(comm, st):
        h = sfhydro.clear_hydro(g, st.interpolator.device)
        h = paux.accumulate_hydro_p(h, st.species[sid], st.interpolator, g)
        return sfhydro.synchronize_hydro(h, g, comm)

    return lambda states: run_shards(comms, hydro, states)


def dryrun_multichip(n_devices: int, device="cuda", log=print) -> dict:
    """The port's counterpart of ``__graft_entry__.dryrun_multichip``: the
    bench deck on a 2D (y, x) layout of ``n_devices`` shards for two whole
    super-cycles (8 steps: resort every 2, ions every 4), then the
    z-sharded 3D case for 8 steps, each held to the one-shard run of the
    same deck (fields rtol 2e-4 / atol 2e-5, energies rtol 1e-4, alive
    count exact), every shard on ``device``.  Where a deck runs as CUDA
    graphs (``sim.graphed``), its 8 steps are also the JAX hook's one
    dispatch (``__graft_entry__.dryrun_multichip``): one unit of the
    dispatch plan, two replays of one super-cycle (k = 2, M = 2) captured
    once, and no eager step.  Returns each case's energies."""
    import numpy as np

    from ..decks import bench_deck

    n = int(n_devices)
    px = 1
    while px * 2 <= n and n % (px * 2) == 0 and px < 4:
        px *= 2
    py = n // px
    cases = [("2d", dict(nx=4 * px, ny=4 * py, nz=1, px=px, py=py, pz=1))]
    if n >= 2:
        pz3 = 2
        py3 = max(1, n // (2 * px)) if px * 2 <= n else 1
        px3 = n // (pz3 * py3)
        cases.append(("3d-z", dict(nx=4 * px3, ny=4 * py3, nz=4 * pz3,
                                    px=px3, py=py3, pz=pz3)))
    out = {}
    for label, kw in cases:
        sims = [bench_deck.build(npart=512, ion_sort_mult=2, device=device,
                                 **dict(kw, **({} if shards else
                                               dict(px=1, py=1, pz=1))))
                for shards in (False, True)]
        for sim in sims:
            sim.advance_steps(8)
        one, many = sims
        for name, sim in zip(("1 shard", "shards"), sims):
            if sim.graphed:
                check_one_dispatch(sim, 8, f"{label} {name}")
                log(f"dryrun_multichip({n}) {label} {name}: dispatch "
                    f"{dict(sim.dispatch_counts)}")
        for comp in ("ex", "ey", "ez", "cbx", "cby", "cbz", "jfx"):
            np.testing.assert_allclose(global_field(many, comp),
                                       global_field(one, comp), rtol=2e-4,
                                       atol=2e-5, err_msg=f"{label} {comp}")
        e1, e = one.energies(), many.energies()
        for k in e1:
            np.testing.assert_allclose(e[k], e1[k], rtol=1e-4, atol=1e-9,
                                       err_msg=f"{label} energy {k}")
        for sid in range(len(one.states[0].species)):
            assert alive_count(many, sid) == alive_count(one, sid), label
        out[label] = e
    g = many.grid
    kcap = min(many.opts.mig_cap or many.opts.max_inj, many.opts.max_inj)
    log(f"dryrun_multichip({n}): mesh=({py},{px}) and the z-sharded 3D "
        f"case match their one-shard runs over 8 steps; migration payload "
        f"{kcap} lanes/face, {len(many.states[0].species)} species, "
        f"{g.n_shards} shards")
    return out


def check_one_dispatch(sim, steps: int, label: str) -> None:
    """``steps`` steps from step 0 of a graphed ``sim`` were one unit of
    the dispatch plan (the JAX package's one jitted dispatch), replayed
    from one capture with no eager step."""
    from .graphs import plan

    k = sim.opts.resort_interval
    units = plan(0, steps, k, sim._cycle_mult, cycles=k > 1)
    if len(units) != 1:
        raise AssertionError(f"{label}: {steps} steps are the units "
                             f"{units}, not one dispatch")
    kind, count = units[0]
    want = {"captures": 1, f"replays.{kind}": count, "graphed_steps": steps}
    if dict(sim.dispatch_counts) != want:
        raise AssertionError(f"{label}: dispatch {dict(sim.dispatch_counts)}"
                             f", expected {want}")


def compare_layouts(devices=None, steps: int = 16, windows: int = 3,
                    log=print, **deck) -> dict:
    """The bench deck (default 128x128, 2 x 2 097 152 particles on 2 x 2
    shards) with shard r on ``devices[r % len(devices)]`` (default: every
    visible card) against the same shards all on ``devices[0]``: after
    ``steps`` steps the field and species checksums of the two layouts
    are equal, then ``windows`` timed windows of ``steps`` steps of each,
    every device synchronized around a window.  Returns each layout's
    checksums and seconds per step."""
    import statistics
    import time

    from ..decks import bench_deck

    deck = dict(dict(nx=128, ny=128, nz=1, npart=2_097_152, px=2, py=2),
                **deck)
    devices = [torch.device(d) for d in (devices or [
        f"cuda:{k}" for k in range(torch.cuda.device_count())])]

    def sync():
        for d in {d for d in devices if d.type == "cuda"}:
            torch.cuda.synchronize(d)

    sims = {"spread": bench_deck.build(**deck, devices=devices),
            "one device": bench_deck.build(**deck, devices=devices[:1])}
    for sim in sims.values():
        sim.advance_steps(steps)
    out = {name: dict(sums=(sim.checksum_fields(),
                            sim.checksum_species("electron"),
                            sim.checksum_species("ion")),
                      mesh=[str(st.interpolator.device)
                            for st in sim.states])
           for name, sim in sims.items()}
    if out["spread"]["sums"] != out["one device"]["sums"]:
        raise AssertionError(f"the layouts differ: {out}")
    for name, sim in sims.items():
        step_s = []
        for _ in range(windows):
            sync()
            t0 = time.perf_counter()
            sim.advance_steps(steps)
            sync()
            step_s.append((time.perf_counter() - t0) / steps)
        out[name]["step_s"] = step_s
        log(f"{name} {out[name]['mesh']}: median "
            f"{statistics.median(step_s) * 1e3:.4f} ms/step (min "
            f"{min(step_s) * 1e3:.4f}, max {max(step_s) * 1e3:.4f}), "
            f"checksums after {steps} steps equal to the other layout's")
    return out


def global_field(sim, comp: str):
    """The owned block of field component ``comp`` over the global box,
    assembled from every shard ([z, y, x] numpy)."""
    import numpy as np

    from ..interop import to_numpy

    g = sim.grid
    own = lambda st: to_numpy(getattr(st.field, comp))[
        1:g.nz + 1, 1:g.ny + 1, 1:g.nx + 1]
    states = sim.states
    blocks = [[[own(states[sx + g.gpx * (sy + g.gpy * sz)])
                for sx in range(g.gpx)] for sy in range(g.gpy)]
              for sz in range(g.gpz)]
    return np.concatenate([np.concatenate([np.concatenate(row, axis=2)
                                           for row in plane], axis=1)
                           for plane in blocks], axis=0)


def alive_count(sim, sid: int = 0) -> int:
    """The live particles of species ``sid`` over every shard."""
    return sum(int(st.species[sid].alive.sum()) for st in sim.states)
