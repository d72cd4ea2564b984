"""Charge deposit and the particle sort (``vpic_tpu/particles/aux.py``).

- accumulate_rho_p (src/species_advance/standard/rho_p.c:24-79)
- sort_p           (src/species_advance/standard/sort_p.c:16-102): a stable
  sort by plain voxel that also compacts zombies and free slots to the tail.
"""

from __future__ import annotations

import torch

from ..core.types import FieldState, Grid, SpeciesState

# node offsets in deposit order w0..w7 (rho_p.c:70-79), x fastest
_NODE_OFFS = ((0, 0, 0), (1, 0, 0), (0, 1, 0), (1, 1, 0),
              (0, 0, 1), (1, 0, 1), (0, 1, 1), (1, 1, 1))


def trilinear_weights(q, dx, dy, dz, r8V):
    """(n, 8) trilinear node weights w/8 * (1 +/- x)(1 +/- y)(1 +/- z)."""
    w = r8V * q
    ws = []
    for ox, oy, oz in _NODE_OFFS:
        wx = (1.0 + dx) if ox else (1.0 - dx)
        wy = (1.0 + dy) if oy else (1.0 - dy)
        wz = (1.0 + dz) if oz else (1.0 - dz)
        ws.append(w * wx * wy * wz)
    return torch.stack(ws, dim=-1)


def accumulate_rho_p(f: FieldState, sp: SpeciesState, g: Grid) -> FieldState:
    """Trilinear node deposit of charge into rhof (rho_p.c)."""
    alive = sp.alive
    q = torch.where(alive, sp.q, 0.0)
    r8V = float(torch.tensor(0.125 * g.rdx * g.rdy * g.rdz,
                             dtype=torch.float32))
    w = trilinear_weights(q, sp.dx, sp.dy, sp.dz, r8V)
    offs = torch.tensor([ox + g.nxg * (oy + g.nyg * oz)
                         for ox, oy, oz in _NODE_OFFS],
                        dtype=torch.int64, device=w.device)
    idx = torch.where(alive, sp.i, 0).long()[:, None] + offs[None, :]
    rhof = f.rhof.reshape(-1).index_add(0, idx.reshape(-1), w.reshape(-1))
    return f.replace(rhof=rhof.reshape(g.shape))


def sort_p(sp: SpeciesState) -> SpeciesState:
    """Sort particles by voxel with a stable ``torch.sort`` and compact
    zombies and free slots to the tail, refreshing ``np``.  Assumes the
    mover state (mdx.., pc) is clear, which holds between steps."""
    key = torch.where(sp.alive, sp.i, 2 ** 30)
    key_s, order = torch.sort(key, stable=True)
    live = torch.sum(sp.alive).to(torch.int32)
    in_range = torch.arange(sp.max_np, dtype=torch.int32,
                            device=key.device) < live
    cols = {k: getattr(sp, k)[order] for k in ("dx", "dy", "dz", "ux", "uy",
                                                "uz")}
    return sp.replace(
        np=live, i=torch.where(in_range, key_s, 0),
        q=torch.where(in_range, sp.q[order], 0.0),
        tag=torch.where(in_range, sp.tag[order], 0), **cols)
