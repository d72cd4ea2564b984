"""Slab helpers for the Yee mesh (as ``vpic_tpu/field/slabs.py``).

Arrays are ``[z, y, x]`` with one ghost layer on every side; physical axes
are 0=x, 1=y, 2=z.  Ownership ranges encode the Yee staggering
(field_advance.h:80-171):

- ``edge_a``: along axis a owned 1..n_a, transverse 1..n+1;
- ``face_a``: along axis a owned 1..n_a+1, transverse 1..n;
- ``node``: 1..n+1 on every axis;  ``cell``: 1..n on every axis.
"""

from __future__ import annotations

from ..core.types import Grid


def own_slice(g: Grid, kind: str, axis: int) -> slice:
    """Ownership range of a component along one physical axis."""
    n = (g.nx, g.ny, g.nz)[axis]
    if kind == "node":
        return slice(1, n + 2)
    if kind == "cell":
        return slice(1, n + 1)
    if kind.startswith("edge_"):
        a = "xyz".index(kind[-1])
        return slice(1, n + 1) if axis == a else slice(1, n + 2)
    if kind.startswith("face_"):
        a = "xyz".index(kind[-1])
        return slice(1, n + 2) if axis == a else slice(1, n + 1)
    raise ValueError(kind)


def shifted(g: Grid, arr, kind: str, dx=0, dy=0, dz=0):
    """The owned block of ``kind`` shifted by (dx,dy,dz) cells: the values
    of ``arr`` at (x+dx, y+dy, z+dz) for each owned (x,y,z)."""
    ix = []
    for a, d in ((2, dz), (1, dy), (0, dx)):
        s = own_slice(g, kind, a)
        ix.append(slice(s.start + d, s.stop + d))
    return arr[tuple(ix)]
