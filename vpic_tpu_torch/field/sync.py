"""Shared-face synchronization (``vpic_tpu/field/sync.py``; reference
remote.c:298-622) of periodic faces and of the faces between shards.

Three sequential axis passes (x, y, z) merge edge and corner values
transitively.  A face on the global boundary of a non-periodic axis keeps
its own values (the JAX package's mask).  With uniform spacing the reference's weights reduce to:
jf and rhof summed, rhob averaged, tangential E and normal B averaged.
"""

from __future__ import annotations

import torch

from ..core.types import FieldState, Grid
from . import ghost
from .ghost import _CB, _E, _JF, _TCA, CYC, _face_geom, _is_local, _kp_ix


def _merge_pass(arrays: dict, g: Grid, comm, axis: int, specs):
    """One axis pass over the face pair (axis, axis+3).  ``specs`` lists
    (array key, kind, combine); combine(own, recv) -> (new, err or None).
    Updates ``arrays`` (fresh copies owned by the caller) in place and
    returns the float64 sum of the errors."""
    faces = (axis, axis + 3)
    payloads = {}
    for face in faces:
        X, _, _, _, _, fi = _face_geom(g, face)
        payloads[face] = tuple(arrays[key][_kp_ix(g, kind, X, fi)].clone()
                               for key, kind, _ in specs)
    recv = comm.exchange(payloads)

    err = 0.0
    for face in faces:
        if _is_local(comm, g, face, recv[face]):
            continue
        X, _, _, _, _, fi = _face_geom(g, face)
        for k, (key, kind, combine) in enumerate(specs):
            ix = _kp_ix(g, kind, X, fi)
            new, e = combine(arrays[key][ix], recv[face][k])
            arrays[key][ix] = new
            if e is not None:
                err = err + torch.sum(e)
    return err


def _sum(own, recv):
    return own + recv, None


def _avg(own, recv):
    return 0.5 * (own + recv), None


def _avg_err(own, recv):
    d = own.to(torch.float64) - recv.to(torch.float64)
    return 0.5 * (own + recv), d * d


def synchronize_jf(f: FieldState, g: Grid, comm) -> FieldState:
    """Additive merge of face current (remote.c:416-506)."""
    f = ghost.adjust_jf(f, g, comm)
    arrays = {c: getattr(f, c).clone() for c in _JF}
    for axis in range(3):
        Y, Z = CYC[axis]
        _merge_pass(arrays, g, comm, axis,
                    [(_JF[Y], "edge_" + "xyz"[Y], _sum),
                     (_JF[Z], "edge_" + "xyz"[Z], _sum)])
    return f.replace(**arrays)


def synchronize_rho(f: FieldState, g: Grid, comm) -> FieldState:
    """rhof summed, rhob averaged across shared node planes
    (remote.c:532-621)."""
    f = ghost.adjust_rhof(f, g, comm)
    f = ghost.adjust_rhob(f, g, comm)
    arrays = {"rhof": f.rhof.clone(), "rhob": f.rhob.clone()}
    for axis in range(3):
        _merge_pass(arrays, g, comm, axis,
                    [("rhof", "node", _sum), ("rhob", "node", _avg)])
    return f.replace(**arrays)


def synchronize_tang_e_norm_b(f: FieldState, g: Grid, comm):
    """Average shared tangential E / normal B; returns (f, float64
    desynchronization error) (remote.c:298-414)."""
    f = ghost.adjust_tang_e(f, g, comm)
    f = ghost.adjust_norm_b(f, g, comm)
    arrays = {c: getattr(f, c).clone() for c in _E + _TCA + _CB}
    err = 0.0
    for axis in range(3):
        Y, Z = CYC[axis]
        err = err + _merge_pass(arrays, g, comm, axis, [
            (_CB[axis], "face_" + "xyz"[axis], _avg_err),
            (_E[Y], "edge_" + "xyz"[Y], _avg_err),
            (_TCA[Y], "edge_" + "xyz"[Y], _avg),
            (_E[Z], "edge_" + "xyz"[Z], _avg_err),
            (_TCA[Z], "edge_" + "xyz"[Z], _avg),
        ])
    return f.replace(**arrays), err
