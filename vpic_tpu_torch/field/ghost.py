"""Ghost fills and local boundary adjusts of the Yee mesh
(``vpic_tpu/field/ghost.py``; reference local.c:50-445 and
remote.c:61-297).

Each face takes either the plane its neighbor sends through the comm's
exchange (a periodic face, or a face between two shards) or its local
boundary value (PEC/anti-symmetric, symmetric, PMC or the absorbing
Higdon face).  On a sharded non-periodic axis every shard receives the
wrapped plane and only the outermost shards' outer faces take the local
value, as ``comm.is_global_boundary(face)`` says (the JAX package's
``_blend`` and ``_apply_local_mask``, whose traced mask is a plain bool
per shard here).  The local adjusts touch only those faces.
"""

from __future__ import annotations

import torch

from ..core.types import (
    ABSORB_FIELDS,
    ANTI_SYMMETRIC_FIELDS,
    FACE_AXIS,
    FACE_DIR,
    FieldState,
    Grid,
    PERIODIC_FIELDS,
    PMC_FIELDS,
    SYMMETRIC_FIELDS,
)
from .slabs import own_slice

# cyclic transverse axes for a face axis: x->(y,z), y->(z,x), z->(x,y)
CYC = ((1, 2), (2, 0), (0, 1))
_E = ("ex", "ey", "ez")
_CB = ("cbx", "cby", "cbz")
_TCA = ("tcax", "tcay", "tcaz")
_JF = ("jfx", "jfy", "jfz")
_LOCAL = (ANTI_SYMMETRIC_FIELDS, SYMMETRIC_FIELDS, PMC_FIELDS, ABSORB_FIELDS)


def check_faces(g: Grid) -> None:
    """Raise for a field boundary code that is not a global face's."""
    bad = [b for b in g.fbc if b != PERIODIC_FIELDS and b not in _LOCAL]
    if bad:
        raise ValueError(f"bad field boundary codes {bad}")


def _is_local(comm, g: Grid, face: int, recv) -> bool:
    """Whether ``face`` takes its local boundary value: nothing was
    received there, or it is a non-periodic face on the global boundary
    (``vpic_tpu/field/ghost.py:_blend``)."""
    return recv is None or (g.fbc[face] != PERIODIC_FIELDS
                            and comm.is_global_boundary(face))


def _kp_ix(g: Grid, kind: str, axis: int, idx: int, shift=(0, 0, 0)):
    """Index of the plane ``axis == idx + shift[axis]`` over `kind`'s
    transverse ownership ranges (shifted), ``[z, y, x]`` order."""
    ix = []
    for a in range(3):
        if a == axis:
            ix.append(idx + shift[a])
        else:
            s = own_slice(g, kind, a)
            ix.append(slice(s.start + shift[a], s.stop + shift[a]))
    return (ix[2], ix[1], ix[0])


def _rd(g: Grid, axis: int) -> float:
    return (g.rdx, g.rdy, g.rdz)[axis]


def _face_geom(g: Grid, face: int):
    """(axis X, transverse (Y,Z), lo?, ghost idx, mirror idx, face idx)."""
    X = FACE_AXIS[face]
    lo = FACE_DIR[face] < 0
    n = (g.nx, g.ny, g.nz)[X]
    gi = 0 if lo else n + 1
    mi = 1 if lo else n
    fi = 1 if lo else n + 1
    return X, CYC[X], lo, gi, mi, fi


# ---------------------------------------------------------------------------
# Ghost fills
# ---------------------------------------------------------------------------


def ghost_tang_b(f: FieldState, g: Grid, comm) -> FieldState:
    """Fill tangential cB ghosts on every face (local.c:50-122 +
    remote.c:61-134)."""
    check_faces(g)
    payloads = {}
    for face in range(6):
        X, (Y, Z), _, _, mi, _ = _face_geom(g, face)
        payloads[face] = tuple(
            getattr(f, _CB[T])[_kp_ix(g, "face_" + "xyz"[T], X, mi)]
            for T in (Y, Z))
    recv = comm.exchange(payloads)

    out = {c: getattr(f, c).clone() for c in _CB}
    for face in range(6):
        X, (Y, Z), lo, gi, mi, fi = _face_geom(g, face)
        bc = g.fbc[face]
        local = _is_local(comm, g, face, recv[face])
        for k, (T, other) in enumerate(((Y, Z), (Z, Y))):
            kind = "face_" + "xyz"[T]
            cb = out[_CB[T]]
            if not local:
                val = recv[face][k]
            elif bc == ANTI_SYMMETRIC_FIELDS:
                val = cb[_kp_ix(g, kind, X, mi)].clone()
            elif bc in (SYMMETRIC_FIELDS, PMC_FIELDS):
                val = -cb[_kp_ix(g, kind, X, mi)]
            else:
                val = _higdon_tang_b(f, g, cb, kind, X, T, Y, other, lo,
                                     gi, mi, fi)
            cb[_kp_ix(g, kind, X, gi)] = val
    return f.replace(**out)


def _higdon_tang_b(f, g: Grid, cb, kind, X, T, Y, other, lo, gi, mi, fi):
    """The absorbing face's tangential cB ghost: the first-order Higdon
    condition with a 15 degree cone (local.c:61-107), in the JAX package's
    operation order."""
    higend = 1.03527618 if (g.nx > 1 or g.ny > 1 or g.nz > 1) else 1.0
    cdt = g.cvac * g.dt
    drv = cdt * _rd(g, X) * higend
    decay = (1.0 - drv) / (1.0 + drv)
    drive = 2.0 * drv / (1.0 + drv)
    sgn = 1.0 if lo else -1.0
    d = -1 if lo else 1
    eT = getattr(f, _E[other])
    eX = getattr(f, _E[X])
    t1 = (cdt * _rd(g, X)) * (eT[_kp_ix(g, kind, X, fi - d)]
                              - eT[_kp_ix(g, kind, X, fi)]) * sgn
    sh = [0, 0, 0]
    sh[other] = 1
    t2 = (cdt * _rd(g, other)) * (eX[_kp_ix(g, kind, X, mi, tuple(sh))]
                                  - eX[_kp_ix(g, kind, X, mi)])
    ghost_old = cb[_kp_ix(g, kind, X, gi)]
    mirror = cb[_kp_ix(g, kind, X, mi)]
    if T == Y:
        return decay * ghost_old + drive * mirror - t1 + t2
    return decay * ghost_old + drive * mirror + t1 - t2


def ghost_norm_e(f: FieldState, g: Grid, comm) -> FieldState:
    """Fill normal-E ghosts (local.c:128-179 + remote.c:136-206); a local
    face also fills the tca ghost, as the reference does."""
    check_faces(g)
    payloads = {}
    for face in range(6):
        X, _, _, _, mi, _ = _face_geom(g, face)
        payloads[face] = getattr(f, _E[X])[_kp_ix(g, "edge_" + "xyz"[X],
                                                  X, mi)]
    recv = comm.exchange(payloads)

    out = {c: getattr(f, c).clone() for c in _E + _TCA}
    for face in range(6):
        X, _, lo, gi, mi, _ = _face_geom(g, face)
        kind = "edge_" + "xyz"[X]
        bc = g.fbc[face]
        e, tca = out[_E[X]], out[_TCA[X]]
        gix = _kp_ix(g, kind, X, gi)
        if not _is_local(comm, g, face, recv[face]):
            # the remote path exchanges E only (remote.c:136-206)
            e[gix] = recv[face]
            continue
        e_m, tca_m = e[_kp_ix(g, kind, X, mi)], tca[_kp_ix(g, kind, X, mi)]
        if bc == ANTI_SYMMETRIC_FIELDS:
            local_e, local_tca = e_m.clone(), tca_m.clone()
        elif bc in (SYMMETRIC_FIELDS, PMC_FIELDS):
            local_e, local_tca = -e_m, -tca_m
        else:
            mi2 = gi - 2 * (-1 if lo else 1)
            local_e = 2.0 * e_m - e[_kp_ix(g, kind, X, mi2)]
            local_tca = 2.0 * tca_m - tca[_kp_ix(g, kind, X, mi2)]
        e[gix] = local_e
        tca[gix] = local_tca
    return f.replace(**out)


def ghost_div_b(f: FieldState, g: Grid, comm) -> FieldState:
    """Fill div_b_err ghosts (local.c:182-215 + remote.c:208-279)."""
    check_faces(g)
    payloads = {}
    for face in range(6):
        X, _, _, _, mi, _ = _face_geom(g, face)
        payloads[face] = f.div_b_err[_kp_ix(g, "cell", X, mi)]
    recv = comm.exchange(payloads)

    dbe = f.div_b_err.clone()
    for face in range(6):
        X, _, _, gi, mi, _ = _face_geom(g, face)
        bc = g.fbc[face]
        gix = _kp_ix(g, "cell", X, gi)
        mirror = dbe[_kp_ix(g, "cell", X, mi)]
        if not _is_local(comm, g, face, recv[face]):
            dbe[gix] = recv[face]
        elif bc == ANTI_SYMMETRIC_FIELDS:
            dbe[gix] = mirror.clone()
        elif bc in (SYMMETRIC_FIELDS, PMC_FIELDS):
            dbe[gix] = -mirror
        else:
            # a fill on the device, not a number copied from the host (a
            # CUDA graph's capture refuses that)
            dbe[gix].fill_(0.0)
    return f.replace(div_b_err=dbe)


# ---------------------------------------------------------------------------
# Local adjusts (local.c:224-444): each touches the face planes of the
# local faces only.
# ---------------------------------------------------------------------------


def _adjust(f: FieldState, g: Grid, comm, plane, rule) -> FieldState:
    """For each face on the global boundary in turn, ``rule(bc)`` gives
    None (leave the face) or a function of the face plane; ``plane(face)``
    gives, per component it sets, (kind, axis, index) of the plane."""
    check_faces(g)
    out = {}
    for face in range(6):
        fn = rule(g.fbc[face])
        if fn is None or not comm.is_global_boundary(face):
            continue
        for c, (kind, X, idx) in plane(face).items():
            if c not in out:
                out[c] = getattr(f, c).clone()
            ix = _kp_ix(g, kind, X, idx)
            out[c][ix] = fn(out[c][ix])
    return f.replace(**out)


def _zero(p):
    return torch.zeros_like(p)


def _double(p):
    return 2.0 * p


def _only(*codes):
    """The rule that zeroes the face plane on the faces of ``codes``."""
    return lambda bc: _zero if bc in codes else None


def _zero_or_double(bc):
    """Zero on a PEC face, doubled on every other local face (the image
    charge or current of a symmetric, PMC or absorbing face)."""
    if bc == PERIODIC_FIELDS:
        return None
    return _zero if bc == ANTI_SYMMETRIC_FIELDS else _double


def _tang_plane(g: Grid, comps):
    """The face plane of each face's two transverse components, on their
    edge lattices; ``comps`` are per-axis name tuples."""
    def plane(face):
        X, (Y, Z), _, _, _, fi = _face_geom(g, face)
        return {c[T]: ("edge_" + "xyz"[T], X, fi) for T in (Y, Z)
                for c in comps}
    return plane


def _node_plane(g: Grid, name: str):
    def plane(face):
        X, _, _, _, _, fi = _face_geom(g, face)
        return {name: ("node", X, fi)}
    return plane


def adjust_tang_e(f: FieldState, g: Grid, comm) -> FieldState:
    return _adjust(f, g, comm, _tang_plane(g, (_E, _TCA)),
                   _only(ANTI_SYMMETRIC_FIELDS))


def adjust_norm_b(f: FieldState, g: Grid, comm) -> FieldState:
    def plane(face):
        X, _, _, _, _, fi = _face_geom(g, face)
        return {_CB[X]: ("face_" + "xyz"[X], X, fi)}
    return _adjust(f, g, comm, plane, _only(SYMMETRIC_FIELDS))


def adjust_div_e_err(f: FieldState, g: Grid, comm) -> FieldState:
    return _adjust(f, g, comm, _node_plane(g, "div_e_err"),
                   _only(ANTI_SYMMETRIC_FIELDS, ABSORB_FIELDS))


def adjust_jf(f: FieldState, g: Grid, comm) -> FieldState:
    return _adjust(f, g, comm, _tang_plane(g, (_JF,)), _zero_or_double)


def adjust_rhof(f: FieldState, g: Grid, comm) -> FieldState:
    return _adjust(f, g, comm, _node_plane(g, "rhof"), _zero_or_double)


def adjust_rhob(f: FieldState, g: Grid, comm) -> FieldState:
    return _adjust(f, g, comm, _node_plane(g, "rhob"),
                   _only(ANTI_SYMMETRIC_FIELDS))
