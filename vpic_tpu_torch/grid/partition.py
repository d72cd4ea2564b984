"""The per-cell particle neighbor table of one domain (src/grid/ops.c:26-130,
as in ``vpic_tpu/grid/partition.py``; numpy only)."""

from __future__ import annotations

import numpy as np
import torch

from ..core.types import (
    FACE_AXIS,
    FACE_DIR,
    Grid,
    GridArrays,
    NEIGHBOR_ABSORB,
    NEIGHBOR_MIGRATE_BASE,
    NEIGHBOR_REFLECT,
    PERIODIC_FIELDS,
)


def _pbc_code(pbc: int) -> int:
    """Translate a Grid.pbc entry into a neighbor-table code."""
    if pbc in (NEIGHBOR_REFLECT, NEIGHBOR_ABSORB):
        return pbc
    if pbc <= -9:  # custom handler code, stored verbatim
        return pbc
    raise ValueError(f"bad particle boundary condition {pbc}")


def build_neighbor_table(g: Grid, shard=(0, 0, 0)) -> np.ndarray:
    """The (nv, 6) int32 neighbor table of one shard.

    Owned voxels get, per face: the neighbor voxel, a periodic wrap (single
    shard along that axis), a migrate-to-shard code, or a particle boundary
    code.  Ghost voxels are never consulted by the walker and hold
    NEIGHBOR_ABSORB."""
    nxg, nyg, nzg = g.nxg, g.nyg, g.nzg
    shards = (g.gpx, g.gpy, g.gpz)
    dims = (g.nx, g.ny, g.nz)

    Z, Y, X = np.meshgrid(np.arange(nzg), np.arange(nyg), np.arange(nxg),
                          indexing="ij")
    coords = (X, Y, Z)

    nb = np.full((nzg, nyg, nxg, 6), NEIGHBOR_ABSORB, dtype=np.int32)

    def voxel(xx, yy, zz):
        return (xx + nxg * (yy + nyg * zz)).astype(np.int32)

    owned = ((X >= 1) & (X <= g.nx) & (Y >= 1) & (Y <= g.ny)
             & (Z >= 1) & (Z <= g.nz))

    for face in range(6):
        ax, dr = FACE_AXIS[face], FACE_DIR[face]
        n_ax = dims[ax]
        c = coords[ax]
        at_edge = (c == 1) if dr < 0 else (c == n_ax)

        step = [X, Y, Z]
        step[ax] = step[ax] + dr
        interior = voxel(*step)

        wrap = [X, Y, Z]
        wrap[ax] = np.where(dr < 0, n_ax, 1) * np.ones_like(c)
        wrapped = voxel(*wrap)

        gpbc = g.pbc[face]
        if shards[ax] > 1:
            sc = shard[ax]
            at_global_low = dr < 0 and sc == 0
            at_global_high = dr > 0 and sc == shards[ax] - 1
            if (g.join[face] is None
                    and (at_global_low or at_global_high)
                    and gpbc != PERIODIC_FIELDS):
                edge_val = np.int32(_pbc_code(gpbc))
            else:
                edge_val = np.int32(NEIGHBOR_MIGRATE_BASE - face)
            vals = np.where(at_edge, edge_val, interior)
        elif gpbc == PERIODIC_FIELDS:
            vals = np.where(at_edge, wrapped, interior)
        else:
            vals = np.where(at_edge, np.int32(_pbc_code(gpbc)), interior)

        nb[..., face] = np.where(owned, vals, np.int32(NEIGHBOR_ABSORB))

    return nb.reshape(-1, 6)


def make_grid_arrays(g: Grid, shard=(0, 0, 0), device="cpu") -> GridArrays:
    return GridArrays(neighbor=torch.as_tensor(
        build_neighbor_table(g, shard), device=device))


def shard_origin(g: Grid, shard=(0, 0, 0)):
    """Local domain corner of a shard (partition_periodic_box's Cartesian
    decomposition, src/grid/partition.c:36-85)."""
    lx = (g.gx1 - g.gx0) / g.gpx
    ly = (g.gy1 - g.gy0) / g.gpy
    lz = (g.gz1 - g.gz0) / g.gpz
    return (g.gx0 + lx * shard[0], g.gy0 + ly * shard[1],
            g.gz0 + lz * shard[2])
