"""Yee-mesh FDTD field solver, vacuum path (``vpic_tpu/field/stencil.py``
with a single material): whole-slab stencils over the owned region of

- advance_b            (standard/advance_b.c:12-161)
- advance_e            (standard/advance_e.c:8-330, exponentially
                        differenced Ampere with TCA radiation damping)
- compute_curl_b       (standard/compute_curl_b.c:8-18)
- compute_div_e_err / local_rms_div_e_err / clean_div_e
- compute_div_b_err / local_rms_div_b_err / clean_div_b
- compute_rhob         (standard/compute_rhob.c:8-12)
- local_energy_f       (standard/energy_f.c:50-77)

``matg`` must be None: coefficients are the scalars of material 0 (the
reference's vacuum variant, standard/vacuum/vfa.c).  Reductions run in
float64 like the reference.
"""

from __future__ import annotations

import torch

from ..core.types import FieldState, Grid, MaterialTable
from . import ghost
from .slabs import own_slice, shifted


def _p(g: Grid, axis: int, scale: float):
    n = (g.gnx, g.gny, g.gnz)[axis]
    rd = (g.rdx, g.rdy, g.rdz)[axis]
    return scale * rd if n > 1 else 0.0


def _ix(g: Grid, kind: str):
    return tuple(own_slice(g, kind, a) for a in (2, 1, 0))


def _coef(mat: MaterialTable, matg, name: str):
    if matg is not None:
        raise NotImplementedError("per-voxel materials are not ported")
    return getattr(mat, name)[0]


def _add(arr, ix, v):
    out = arr.clone()
    out[ix] += v
    return out


def _set(arr, ix, v):
    out = arr.clone()
    out[ix] = v
    return out


def advance_b(f: FieldState, g: Grid, frac: float) -> FieldState:
    """Faraday step: cB -= frac*c*dt * curl E."""
    px, py, pz = (_p(g, a, frac * g.cvac * g.dt) for a in range(3))

    def curl(kind, e_a, e_b, p_a, p_b, da, db):
        return (p_a * (shifted(g, e_b, kind, **da) - shifted(g, e_b, kind))
                - p_b * (shifted(g, e_a, kind, **db) - shifted(g, e_a, kind)))

    dbx = curl("face_x", f.ey, f.ez, py, pz, dict(dy=1), dict(dz=1))
    dby = curl("face_y", f.ez, f.ex, pz, px, dict(dz=1), dict(dx=1))
    dbz = curl("face_z", f.ex, f.ey, px, py, dict(dx=1), dict(dy=1))
    return f.replace(cbx=_add(f.cbx, _ix(g, "face_x"), -dbx),
                     cby=_add(f.cby, _ix(g, "face_y"), -dby),
                     cbz=_add(f.cbz, _ix(g, "face_z"), -dbz))


def _rmu_curl_b(f: FieldState, g: Grid, mat: MaterialTable, matg,
                scale: float):
    """For each E component p_a*d_a(cB_b*rmu_b) - p_b*d_b(cB_a*rmu_a),
    backward differences (reads the tang-B ghost planes)."""
    px, py, pz = (_p(g, a, scale) for a in range(3))

    def term(kind, cb_name, rmu, p, axis):
        cb = getattr(f, cb_name)
        d = {("dx", "dy", "dz")[axis]: -1}
        c = _coef(mat, matg, rmu)
        return p * (shifted(g, cb, kind) * c - shifted(g, cb, kind, **d) * c)

    tcax = term("edge_x", "cbz", "rmuz", py, 1) - term("edge_x", "cby",
                                                       "rmuy", pz, 2)
    tcay = term("edge_y", "cbx", "rmux", pz, 2) - term("edge_y", "cbz",
                                                       "rmuz", px, 0)
    tcaz = term("edge_z", "cby", "rmuy", px, 0) - term("edge_z", "cbx",
                                                       "rmux", py, 1)
    return tcax, tcay, tcaz


def compute_curl_b(f: FieldState, g: Grid, mat: MaterialTable, matg,
                   comm) -> FieldState:
    """tca = c*dt*curl(cB/mu) (compute_curl_b.c:8-18)."""
    f = ghost.ghost_tang_b(f, g, comm)
    tcax, tcay, tcaz = _rmu_curl_b(f, g, mat, matg, g.cvac * g.dt)
    f = f.replace(tcax=_set(f.tcax, _ix(g, "edge_x"), tcax),
                  tcay=_set(f.tcay, _ix(g, "edge_y"), tcay),
                  tcaz=_set(f.tcaz, _ix(g, "edge_z"), tcaz))
    return ghost.adjust_tang_e(f, g, comm)


def advance_e(f: FieldState, g: Grid, mat: MaterialTable, matg,
              comm) -> FieldState:
    """tca = (1+damp)*c*dt*curl(cB/mu) - damp*tca;
    e = decay*e + drive*(tca - dt/eps0 * jf)  (advance_e.c:8-25)."""
    f = ghost.ghost_tang_b(f, g, comm)
    damp = g.damp
    cj = g.dt / g.eps0
    curls = _rmu_curl_b(f, g, mat, matg, (1.0 + damp) * g.cvac * g.dt)
    out = {}
    for comp, curl in zip("xyz", curls):
        ix = _ix(g, "edge_" + comp)
        e = getattr(f, "e" + comp)
        tca_old = getattr(f, "tca" + comp)[ix]
        jf = getattr(f, "jf" + comp)[ix]
        decay = _coef(mat, matg, "decay" + comp)
        drive = _coef(mat, matg, "drive" + comp)
        tca = curl - damp * tca_old
        out["tca" + comp] = _set(getattr(f, "tca" + comp), ix, tca)
        out["e" + comp] = _set(e, ix, decay * e[ix] + drive * (tca - cj * jf))
    f = f.replace(**out)
    return ghost.adjust_tang_e(f, g, comm)


def _div_eps_e(f: FieldState, g: Grid, mat, matg, scale: float):
    """sum_a p_a*(eps_a*e_a - eps_a*e_a(shift -1)) over the nodes."""
    kind = "node"
    total = None
    for axis, (e_name, eps) in enumerate((("ex", "epsx"), ("ey", "epsy"),
                                          ("ez", "epsz"))):
        e = getattr(f, e_name)
        d = {("dx", "dy", "dz")[axis]: -1}
        c = _coef(mat, matg, eps)
        t = _p(g, axis, scale) * (shifted(g, e, kind) * c
                                  - shifted(g, e, kind, **d) * c)
        total = t if total is None else total + t
    return total


def compute_div_e_err(f: FieldState, g: Grid, mat: MaterialTable, matg,
                      comm) -> FieldState:
    """div_e_err = nonconductive*(div(eps*E) - (rhof+rhob)/eps0)
    (compute_div_e_err.c:7-12)."""
    f = ghost.ghost_norm_e(f, g, comm)
    ix = _ix(g, "node")
    nonc = _coef(mat, matg, "nonconductive")
    err = nonc * (_div_eps_e(f, g, mat, matg, 1.0)
                  - (1.0 / g.eps0) * (f.rhof[ix] + f.rhob[ix]))
    f = f.replace(div_e_err=_set(f.div_e_err, ix, err))
    return ghost.adjust_div_e_err(f, g, comm)


def _node_weights(n: int, device):
    w = torch.ones((n + 1,), dtype=torch.float64, device=device)
    w[0] = 0.5
    w[-1] = 0.5
    return w


def local_rms_div_e_err(f: FieldState, g: Grid):
    """(sum, volume); boundary node planes weighted 1/2 each
    (compute_rms_div_e_err.c)."""
    e = f.div_e_err[_ix(g, "node")].to(torch.float64)
    dev = e.device
    wt = (_node_weights(g.nz, dev)[:, None, None]
          * _node_weights(g.ny, dev)[None, :, None]
          * _node_weights(g.nx, dev)[None, None, :])
    err = torch.sum(wt * e * e)
    vol = g.nx * g.ny * g.nz * g.dx * g.dy * g.dz
    return err * g.dx * g.dy * g.dz, torch.tensor(vol, dtype=torch.float64,
                                                    device=dev)


def finish_rms(g: Grid, global_err, global_vol):
    return g.eps0 * torch.sqrt(global_err / global_vol)


def _marder_coeff(g: Grid):
    px, py, pz = (_p(g, a, 1.0) for a in range(3))
    alphadt = 0.3888889 / (px * px + py * py + pz * pz)
    return alphadt * px, alphadt * py, alphadt * pz


def clean_div_e(f: FieldState, g: Grid, mat: MaterialTable,
                matg) -> FieldState:
    """e += drive*alphadt*grad(div_e_err) (clean_div_e.c:6-14)."""
    out = {}
    for axis, (comp, p) in enumerate(zip("xyz", _marder_coeff(g))):
        kind = "edge_" + comp
        d = {("dx", "dy", "dz")[axis]: 1}
        grad = (shifted(g, f.div_e_err, kind, **d)
                - shifted(g, f.div_e_err, kind))
        drive = _coef(mat, matg, "drive" + comp)
        out["e" + comp] = _add(getattr(f, "e" + comp), _ix(g, kind),
                               drive * p * grad)
    return f.replace(**out)


def compute_div_b_err(f: FieldState, g: Grid) -> FieldState:
    """div_b_err = div cB on cells (compute_div_b_err.c:44-48)."""
    px, py, pz = (_p(g, a, 1.0) for a in range(3))
    kind = "cell"
    err = (px * (shifted(g, f.cbx, kind, dx=1) - shifted(g, f.cbx, kind))
           + py * (shifted(g, f.cby, kind, dy=1) - shifted(g, f.cby, kind))
           + pz * (shifted(g, f.cbz, kind, dz=1) - shifted(g, f.cbz, kind)))
    return f.replace(div_b_err=_set(f.div_b_err, _ix(g, kind), err))


def local_rms_div_b_err(f: FieldState, g: Grid):
    e = f.div_b_err[_ix(g, "cell")].to(torch.float64)
    vol = g.nx * g.ny * g.nz * g.dx * g.dy * g.dz
    return (torch.sum(e * e) * g.dx * g.dy * g.dz,
            torch.tensor(vol, dtype=torch.float64, device=e.device))


def clean_div_b(f: FieldState, g: Grid, comm) -> FieldState:
    """cb += alphadt*grad(div_b_err) (clean_div_b.c:6-50)."""
    f = ghost.ghost_div_b(f, g, comm)
    out = {}
    for axis, (comp, p) in enumerate(zip("xyz", _marder_coeff(g))):
        kind = "face_" + comp
        d = {("dx", "dy", "dz")[axis]: -1}
        grad = (shifted(g, f.div_b_err, kind)
                - shifted(g, f.div_b_err, kind, **d))
        out["cb" + comp] = _add(getattr(f, "cb" + comp), _ix(g, kind),
                                p * grad)
    return f.replace(**out)


def compute_rhob(f: FieldState, g: Grid, mat: MaterialTable, matg,
                 comm) -> FieldState:
    """rhob = nonconductive*(eps0*div(eps*E) - rhof) (compute_rhob.c)."""
    f = ghost.ghost_norm_e(f, g, comm)
    ix = _ix(g, "node")
    nonc = _coef(mat, matg, "nonconductive")
    rhob = nonc * (_div_eps_e(f, g, mat, matg, g.eps0) - f.rhof[ix])
    f = f.replace(rhob=_set(f.rhob, ix, rhob))
    return ghost.adjust_rhob(f, g, comm)


def local_energy_f(f: FieldState, g: Grid, mat: MaterialTable, matg):
    """Per-component field energies averaged to cell centers
    (energy_f.c:50-77): a (6,) float64 tensor; finish with
    :func:`finish_energy_f`."""
    kind = "cell"

    def wsum(name, coef, shifts, weight):
        arr = getattr(f, name)
        c = _coef(mat, matg, coef)
        total = 0.0
        for sh in shifts:
            v = shifted(g, arr, kind, **dict(sh))
            total = total + torch.sum((c * v * v).to(torch.float64))
        return weight * total

    e_sh = lambda a, b: ((), ((a, 1),), ((b, 1),), ((a, 1), (b, 1)))
    return torch.stack([
        wsum("ex", "epsx", e_sh("dy", "dz"), 0.25),
        wsum("ey", "epsy", e_sh("dz", "dx"), 0.25),
        wsum("ez", "epsz", e_sh("dx", "dy"), 0.25),
        wsum("cbx", "rmux", ((), (("dx", 1),)), 0.5),
        wsum("cby", "rmuy", ((), (("dy", 1),)), 0.5),
        wsum("cbz", "rmuz", ((), (("dz", 1),)), 0.5),
    ])


def finish_energy_f(g: Grid, global_en):
    return (0.5 * g.eps0 * g.dx * g.dy * g.dz) * global_en
