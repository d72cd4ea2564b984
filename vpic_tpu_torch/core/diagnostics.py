"""Observability: checksums, phase timers and logging
(``vpic_tpu/core/diagnostics.py``; the reference's auxiliary diagnostics).

- Checksums (misc.cxx:107-171 + util/CheckSum.hxx): SHA-1 digests of the
  field and particle state, over the same bytes in the same order as the
  JAX package's, so a state loaded from it gives its digest.
- Phase timers (vpic.hxx:214-218 p/s/g/f/u_time): :func:`time_phases`
  runs each part of a step on its own, synchronizing the card around it.
- sim_log (deck_wrapper.cxx:45-53): rank-0 stderr logging.
"""

from __future__ import annotations

import hashlib
import sys
import time

import numpy as np
import torch

from ..interop import to_numpy
from .types import FIELD_COMPONENTS


def sim_log(msg, rank: int = 0):
    """Rank-0 stderr log line (deck_wrapper.cxx:48-53)."""
    if rank == 0:
        print(f"[vpic_tpu_torch] {msg}", file=sys.stderr, flush=True)


def _host(t) -> np.ndarray:
    return np.ascontiguousarray(to_numpy(t))


def _states(state) -> list:
    return list(state) if isinstance(state, (list, tuple)) else [state]


def checksum_fields(state) -> str:
    """SHA-1 over every field component (output_checksum_fields,
    misc.cxx:109-139); of a list of per-shard states, each component of
    every shard in rank order (the bytes of the JAX package's stacked
    state)."""
    h = hashlib.sha1()
    for name in FIELD_COMPONENTS:
        for st in _states(state):
            h.update(_host(getattr(st.field, name)))
    return h.hexdigest()


def checksum_species(state, sid: int) -> str:
    """SHA-1 over the live particles of one species (of every shard of a
    list of states) in canonical order (by voxel, then tag, then dx), so
    it does not depend on the slots (output_checksum_species,
    misc.cxx:141-171)."""
    sps = [st.species[sid] for st in _states(state)]
    cols = [np.concatenate([_host(getattr(sp, k))[_host(sp.alive)]
                            for sp in sps])
            for k in ("i", "tag", "dx", "dy", "dz", "ux", "uy", "uz", "q")]
    order = np.lexsort((cols[2], cols[1], cols[0]))
    h = hashlib.sha1()
    for c in cols:
        h.update(np.ascontiguousarray(c[order]))
    return h.hexdigest()


def time_phases(sim, n_steps: int = 3) -> dict:
    """Seconds per call of each part of the step, each run ``n_steps``
    times on its own after one warm-up call, with the card synchronized
    before and after (a debugging aid: the step itself runs the parts
    back to back).  The parts run op by op, outside any CUDA graph, on
    their own: the times of the parts as the step runs them, inside a
    graph's replay too, are the device-clock spans'
    (``engine/spans.records``), and the step's wall time is
    ``Simulation.advance``'s.  On a sharded deck each call runs the part
    on every shard, in the shards' threads."""
    from ..engine import distributed as dist
    from ..engine.step import walk_segments
    from ..field import stencil, sync
    from ..particles import aux as paux
    from ..particles import push_cuda
    from ..sf import interp as sfi

    g = sim.grid
    n_walk = walk_segments(g, sim.opts)
    devs = {st.interpolator.device for st in sim.states}

    def sync_dev():
        for d in devs:
            if d.type == "cuda":
                torch.cuda.synchronize(d)

    def each(fn):
        return lambda: dist.run_shards(sim.comms, fn, sim.states)

    out = {}

    def timed(name, fn):
        fn()
        sync_dev()
        t0 = time.perf_counter()
        for _ in range(n_steps):
            fn()
        sync_dev()
        out[name] = (time.perf_counter() - t0) / n_steps

    def acc0(st):
        return torch.zeros((g.nv, 12), dtype=torch.float32,
                           device=st.interpolator.device)

    for k, h in enumerate(sim._species):
        timed(f"sort[{h['name']}]",
              each(lambda c, st: paux.sort_p(st.species[k])))
        timed(f"advance_p[{h['name']}]", each(lambda c, st: push_cuda.advance_p(
            st.species[k], st.interpolator, acc0(st),
            st.grid_arrays.neighbor, g, n_walk=n_walk)))
    timed("advance_b", each(lambda c, st: stencil.advance_b(st.field, g,
                                                            0.5)))
    timed("advance_e", each(lambda c, st: stencil.advance_e(
        st.field, g, st.materials, st.material_grid, c)))
    timed("synchronize_jf", each(lambda c, st: sync.synchronize_jf(
        st.field, g, c)))
    timed("load_interpolator", each(lambda c, st: sfi.load_interpolator(
        st.field, g)))
    timed("unload_accumulator", each(lambda c, st: sfi.unload_accumulator(
        st.field, acc0(st), g)))
    return out
