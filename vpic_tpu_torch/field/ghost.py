"""Ghost fills and local boundary adjusts of the Yee mesh, periodic faces
only (the self-joined path of ``vpic_tpu/field/ghost.py``; reference
local.c:50-445 and remote.c:61-297).

On a periodic face the ghost plane receives the opposite face's mirror
plane through :class:`~vpic_tpu_torch.comm.facecomm.LocalComm`, and every
local adjust is a no-op.  Every function raises NotImplementedError for any
other field boundary code: PEC, PMC, symmetric and absorbing faces are not
ported yet.
"""

from __future__ import annotations

from ..core.types import (
    FACE_AXIS,
    FACE_DIR,
    FieldState,
    Grid,
    PERIODIC_FIELDS,
)
from .slabs import own_slice

# cyclic transverse axes for a face axis: x->(y,z), y->(z,x), z->(x,y)
CYC = ((1, 2), (2, 0), (0, 1))
_E = ("ex", "ey", "ez")
_CB = ("cbx", "cby", "cbz")
_TCA = ("tcax", "tcay", "tcaz")
_JF = ("jfx", "jfy", "jfz")


def require_periodic(g: Grid) -> None:
    if any(b != PERIODIC_FIELDS for b in g.fbc):
        raise NotImplementedError(
            f"field boundary codes {g.fbc}: only periodic faces are ported")


def _kp_ix(g: Grid, kind: str, axis: int, idx: int):
    """Index of the plane ``axis == idx`` over `kind`'s transverse
    ownership ranges, ``[z, y, x]`` order."""
    ix = [idx if a == axis else own_slice(g, kind, a) for a in range(3)]
    return (ix[2], ix[1], ix[0])


def _face_geom(g: Grid, face: int):
    """(axis X, transverse (Y,Z), lo?, ghost idx, mirror idx, face idx)."""
    X = FACE_AXIS[face]
    lo = FACE_DIR[face] < 0
    n = (g.nx, g.ny, g.nz)[X]
    gi = 0 if lo else n + 1
    mi = 1 if lo else n
    fi = 1 if lo else n + 1
    return X, CYC[X], lo, gi, mi, fi


def ghost_tang_b(f: FieldState, g: Grid, comm) -> FieldState:
    """Fill tangential cB ghosts on every face (local.c:50-122)."""
    require_periodic(g)
    payloads = {}
    for face in range(6):
        X, (Y, Z), _, _, mi, _ = _face_geom(g, face)
        payloads[face] = tuple(
            getattr(f, _CB[T])[_kp_ix(g, "face_" + "xyz"[T], X, mi)]
            for T in (Y, Z))
    recv = comm.exchange(payloads)

    out = {c: getattr(f, c).clone() for c in _CB}
    for face in range(6):
        X, (Y, Z), _, gi, _, _ = _face_geom(g, face)
        for k, T in enumerate((Y, Z)):
            out[_CB[T]][_kp_ix(g, "face_" + "xyz"[T], X, gi)] = recv[face][k]
    return f.replace(**out)


def ghost_norm_e(f: FieldState, g: Grid, comm) -> FieldState:
    """Fill normal-E ghosts (local.c:128-179)."""
    require_periodic(g)
    payloads = {}
    for face in range(6):
        X, _, _, _, mi, _ = _face_geom(g, face)
        payloads[face] = getattr(f, _E[X])[_kp_ix(g, "edge_" + "xyz"[X],
                                                  X, mi)]
    recv = comm.exchange(payloads)

    out = {c: getattr(f, c).clone() for c in _E}
    for face in range(6):
        X, _, _, gi, _, _ = _face_geom(g, face)
        out[_E[X]][_kp_ix(g, "edge_" + "xyz"[X], X, gi)] = recv[face]
    return f.replace(**out)


def ghost_div_b(f: FieldState, g: Grid, comm) -> FieldState:
    """Fill div_b_err ghosts (local.c:182-215)."""
    require_periodic(g)
    payloads = {}
    for face in range(6):
        X, _, _, _, mi, _ = _face_geom(g, face)
        payloads[face] = f.div_b_err[_kp_ix(g, "cell", X, mi)]
    recv = comm.exchange(payloads)

    dbe = f.div_b_err.clone()
    for face in range(6):
        X, _, _, gi, _, _ = _face_geom(g, face)
        dbe[_kp_ix(g, "cell", X, gi)] = recv[face]
    return f.replace(div_b_err=dbe)


# Local adjusts (local.c:224-444) touch only non-periodic faces.


def adjust_tang_e(f: FieldState, g: Grid, comm) -> FieldState:
    require_periodic(g)
    return f


def adjust_norm_b(f: FieldState, g: Grid, comm) -> FieldState:
    require_periodic(g)
    return f


def adjust_div_e_err(f: FieldState, g: Grid, comm) -> FieldState:
    require_periodic(g)
    return f


def adjust_jf(f: FieldState, g: Grid, comm) -> FieldState:
    require_periodic(g)
    return f


def adjust_rhof(f: FieldState, g: Grid, comm) -> FieldState:
    require_periodic(g)
    return f


def adjust_rhob(f: FieldState, g: Grid, comm) -> FieldState:
    require_periodic(g)
    return f
