"""Initialization consistency pass (``vpic_tpu/engine/init.py``;
vpic_simulation::initialize, initialize.cxx:13-100): synchronize shared
faces, clean div B, initialize the radiation damping fields, compute bound
charge, clean div E, re-sync, load the interpolator and uncenter the
particle momenta (u_0 -> u_{-1/2})."""

from __future__ import annotations

import dataclasses

from ..core.types import Grid, SimState
from ..field import stencil, sync
from ..particles import aux as paux
from ..particles import push as ppush
from ..sf import interp as sfi


def initialize_state(state: SimState, g: Grid, comm) -> SimState:
    f = state.field
    mat, matg = state.materials, state.material_grid

    f, _ = sync.synchronize_tang_e_norm_b(f, g, comm)
    f = stencil.compute_div_b_err(f, g)
    f = stencil.clean_div_b(f, g, comm)
    f = stencil.compute_curl_b(f, g, mat, matg, comm)

    f = sfi.clear_rhof(f, g)
    for sp in state.species:
        f = paux.accumulate_rho_p(f, sp, g)
    f = sync.synchronize_rho(f, g, comm)
    f = stencil.compute_rhob(f, g, mat, matg, comm)

    f = stencil.compute_div_e_err(f, g, mat, matg, comm)
    err, vol = stencil.local_rms_div_e_err(f, g)
    rms = stencil.finish_rms(g, comm.allsum(err), comm.allsum(vol))
    if bool(rms > 0):
        f = stencil.clean_div_e(f, g, mat, matg)

    f, _ = sync.synchronize_tang_e_norm_b(f, g, comm)

    interp = sfi.load_interpolator(f, g)
    species = tuple(ppush.uncenter_p(sp, interp, g) for sp in state.species)
    return dataclasses.replace(state, field=f, interpolator=interp,
                               species=species)
