"""Yee-mesh FDTD field solver (``vpic_tpu/field/stencil.py``): whole-slab
stencils over the owned region of

- advance_b            (standard/advance_b.c:12-161)
- advance_e            (standard/advance_e.c:8-330, exponentially
                        differenced Ampere with TCA radiation damping)
- compute_curl_b       (standard/compute_curl_b.c:8-18)
- compute_div_e_err / local_rms_div_e_err / clean_div_e
- compute_div_b_err / local_rms_div_b_err / clean_div_b
- compute_rhob         (standard/compute_rhob.c:8-12)
- local_energy_f       (standard/energy_f.c:50-77)

Material coefficients: with ``matg`` None every voxel takes row 0 of the
table as a scalar (the reference's vacuum variant, standard/vacuum/vfa.c);
otherwise each coefficient is gathered through the per-voxel ids
(standard/sfa.c), over the whole ghosted id grid at each call, and sampled
at the same shift as the field it multiplies.  Reductions run in float64
like the reference.
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


def _coef_grid(mat: MaterialTable, matg, name: str, id_field: str):
    """Coefficient ``name`` over the ghosted id grid ``id_field`` (one
    gather; ``index_select`` takes the int32 ids as they are), or the
    scalar of table row 0 without a material grid."""
    table = getattr(mat, name)
    if matg is None:
        return table[0]
    ids = getattr(matg, id_field)
    return table.index_select(0, ids.reshape(-1)).view(ids.shape)


def _at(g: Grid, c, kind: str, dx=0, dy=0, dz=0):
    """A coefficient of :func:`_coef_grid` over ``kind``'s owned block
    shifted by (dx, dy, dz); a scalar stays a scalar."""
    return c if c.dim() == 0 else shifted(g, c, kind, dx, dy, dz)


def _coef(mat: MaterialTable, matg, name: str, g: Grid, kind: str,
          id_field: str, dx=0, dy=0, dz=0):
    """Material coefficient sampled over ``kind``'s owned block, shifted as
    the field it multiplies (``vpic_tpu/field/stencil.py:_coef``)."""
    return _at(g, _coef_grid(mat, matg, name, id_field), kind, dx, dy, dz)


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

    rmu = {a: _coef_grid(mat, matg, "rmu" + a, "fmat" + a) for a in "xyz"}

    def term(kind, a, p, axis):
        # cB_a*rmu_a here and one cell back along ``axis``: each value
        # times the coefficient of its own face
        cb, c = getattr(f, "cb" + a), rmu[a]
        d = {("dx", "dy", "dz")[axis]: -1}
        return p * (shifted(g, cb, kind) * _at(g, c, kind)
                    - shifted(g, cb, kind, **d) * _at(g, c, kind, **d))

    tcax = term("edge_x", "z", py, 1) - term("edge_x", "y", pz, 2)
    tcay = term("edge_y", "x", pz, 2) - term("edge_y", "z", px, 0)
    tcaz = term("edge_z", "y", px, 0) - term("edge_z", "x", py, 1)
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
        kind = "edge_" + comp
        ix = _ix(g, kind)
        e = getattr(f, "e" + comp)
        tca_old = getattr(f, "tca" + comp)[ix]
        jf = getattr(f, "jf" + comp)[ix]
        decay = _coef(mat, matg, "decay" + comp, g, kind, "emat" + comp)
        drive = _coef(mat, matg, "drive" + comp, g, kind, "emat" + comp)
        tca = curl - damp * tca_old
        out["tca" + comp] = _set(getattr(f, "tca" + comp), ix, tca)
        out["e" + comp] = _set(e, ix, decay * e[ix] + drive * (tca - cj * jf))
    f = f.replace(**out)
    return ghost.adjust_tang_e(f, g, comm)


def _div_eps_e(f: FieldState, g: Grid, mat, matg, scale: float):
    """sum_a p_a*(eps_a*e_a - eps_a*e_a(shift -1)) over the nodes, each
    e_a times the eps of its own edge."""
    kind = "node"
    total = None
    for axis, a in enumerate("xyz"):
        e = getattr(f, "e" + a)
        d = {("dx", "dy", "dz")[axis]: -1}
        c = _coef_grid(mat, matg, "eps" + a, "emat" + a)
        t = _p(g, axis, scale) * (shifted(g, e, kind) * _at(g, c, kind)
                                  - shifted(g, e, kind, **d)
                                  * _at(g, c, kind, **d))
        total = t if total is None else total + t
    return total


def compute_div_e_err(f: FieldState, g: Grid, mat: MaterialTable, matg,
                      comm) -> FieldState:
    """div_e_err = nonconductive*(div(eps*E) - (rhof+rhob)/eps0)
    (compute_div_e_err.c:7-12)."""
    f = ghost.ghost_norm_e(f, g, comm)
    ix = _ix(g, "node")
    nonc = _coef(mat, matg, "nonconductive", g, "node", "nmat")
    err = nonc * (_div_eps_e(f, g, mat, matg, 1.0)
                  - (1.0 / g.eps0) * (f.rhof[ix] + f.rhob[ix]))
    f = f.replace(div_e_err=_set(f.div_e_err, ix, err))
    return ghost.adjust_div_e_err(f, g, comm)


def _node_weights(n: int, device):
    w = torch.ones((n + 1,), dtype=torch.float64, device=device)
    # fills on the device: a Python number set by index is copied from the
    # host, which a CUDA graph's capture refuses (engine/graphs.py)
    w[0].fill_(0.5)
    w[-1].fill_(0.5)
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
    # a fill on the device, not a copy from the host: the clean steps run
    # inside CUDA graphs (engine/graphs.py), whose capture refuses copies
    # from pageable host memory
    return err * g.dx * g.dy * g.dz, torch.full((), vol, dtype=torch.float64,
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
        drive = _coef(mat, matg, "drive" + comp, g, kind, "emat" + comp)
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
            torch.full((), vol, dtype=torch.float64, device=e.device))


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
    nonc = _coef(mat, matg, "nonconductive", g, "node", "nmat")
    rhob = nonc * (_div_eps_e(f, g, mat, matg, g.eps0) - f.rhof[ix])
    f = f.replace(rhob=_set(f.rhob, ix, rhob))
    return ghost.adjust_rhob(f, g, comm)


def local_energy_f(f: FieldState, g: Grid, mat: MaterialTable, matg):
    """Per-component field energies averaged to cell centers
    (energy_f.c:50-77): a (6,) float64 tensor; finish with
    :func:`finish_energy_f`."""
    kind = "cell"

    def wsum(name, coef, id_field, shifts, weight):
        # every shifted value times the coefficient at the same shift
        arr = getattr(f, name)
        c = _coef_grid(mat, matg, coef, id_field)
        total = 0.0
        for sh in shifts:
            d = dict(sh)
            v = shifted(g, arr, kind, **d)
            total = total + torch.sum((_at(g, c, kind, **d) * v * v)
                                      .to(torch.float64))
        return weight * total

    e_sh = lambda a, b: ((), ((a, 1),), ((b, 1),), ((a, 1), (b, 1)))
    return torch.stack([
        wsum("ex", "epsx", "ematx", e_sh("dy", "dz"), 0.25),
        wsum("ey", "epsy", "ematy", e_sh("dz", "dx"), 0.25),
        wsum("ez", "epsz", "ematz", e_sh("dx", "dy"), 0.25),
        wsum("cbx", "rmux", "fmatx", ((), (("dx", 1),)), 0.5),
        wsum("cby", "rmuy", "fmaty", ((), (("dy", 1),)), 0.5),
        wsum("cbz", "rmuz", "fmatz", ((), (("dz", 1),)), 0.5),
    ])


def finish_energy_f(g: Grid, global_en):
    return (0.5 * g.eps0 * g.dx * g.dy * g.dz) * global_en
