"""Hydrodynamic moment staging (``vpic_tpu/sf/hydro.py``;
src/sf_interface/hydro.c).

The hydro array is ``(nv, 14)`` float32 in the HYDRO component order
(sf_interface.h:28-38: jx,jy,jz,rho,px,py,pz,ke,txx,tyy,tzz,tyz,tzx,txy).
"""

from __future__ import annotations

import torch

from ..core.types import Grid, PERIODIC_FIELDS
from ..field.ghost import _face_geom, _is_local, _kp_ix, check_faces
from ..particles.aux import N_HYDRO


def clear_hydro(g: Grid, device="cpu"):
    return torch.zeros((g.nv, N_HYDRO), dtype=torch.float32, device=device)


def _node_plane(g: Grid, face: int):
    X, _, _, _, _, fi = _face_geom(g, face)
    return _kp_ix(g, "node", X, fi) + (slice(None),)


def local_adjust_hydro(h, g: Grid, comm):
    """Double every moment on the node planes of the faces on the global
    boundary of a non-periodic axis (hydro.c:132-165)."""
    check_faces(g)
    h4 = h.reshape(g.nzg, g.nyg, g.nxg, N_HYDRO).clone()
    for face in range(6):
        if (g.fbc[face] == PERIODIC_FIELDS
                or not comm.is_global_boundary(face)):
            continue
        ix = _node_plane(g, face)
        h4[ix] = 2.0 * h4[ix]
    return h4.reshape(g.nv, N_HYDRO)


def synchronize_hydro(h, g: Grid, comm):
    """Additive node-plane merge of all 14 moments before dumps
    (hydro.c:28-124), across periodic faces and the faces between shards;
    three sequential axis passes like synchronize_jf."""
    h4 = local_adjust_hydro(h, g, comm).reshape(g.nzg, g.nyg, g.nxg,
                                                N_HYDRO)
    for axis in range(3):
        faces = (axis, axis + 3)
        recv = comm.exchange({face: h4[_node_plane(g, face)].clone()
                              for face in faces})
        for face in faces:
            if not _is_local(comm, g, face, recv[face]):
                ix = _node_plane(g, face)
                h4[ix] = h4[ix] + recv[face]
    return h4.reshape(g.nv, N_HYDRO)
