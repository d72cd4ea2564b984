"""Charge and hydro deposits and the particle sort
(``vpic_tpu/particles/aux.py``).

- accumulate_rho_p   (src/species_advance/standard/rho_p.c:24-79)
- accumulate_rhob    (src/species_advance/standard/boundary_p.c:9-71)
- accumulate_hydro_p (src/species_advance/standard/hydro_p.c:25-161)
- sort_p             (src/species_advance/standard/sort_p.c:16-102): a
  stable sort by plain voxel that also compacts zombies and free slots to
  the tail.
- sort_p_packed, sort_p_packed_merge: the same for a PackedSpecies, by a
  full sort or by the merge re-sort (``sort.py``, ``sort_cuda.py``).

The deposits sum in int64 fixed point (:func:`deposit_nodes`), so on
the card they repeat bit for bit whatever order the atomics of
``index_add_`` take: integer addition is associative.  One implementation
serves both devices.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.types import FieldState, Grid, PackedSpecies, SpeciesState
from . import sort, sort_cuda
from .push import ONE_THIRD, interpolate_fields

# node offsets in deposit order w0..w7 (rho_p.c:70-79), x fastest
_NODE_OFFS = ((0, 0, 0), (1, 0, 0), (0, 1, 0), (1, 1, 0),
              (0, 0, 1), (1, 0, 1), (0, 1, 1), (1, 1, 1))

N_HYDRO = 14
HYDRO = dict(jx=0, jy=1, jz=2, rho=3, px=4, py=5, pz=6, ke=7,
             txx=8, tyy=9, tzz=10, tyz=11, tzx=12, txy=13)

# lanes per pass of deposit_nodes: bounds its (lanes, 8, columns) int64
# contributions (a hydro pass holds 2^18 * 8 * 14 words, 235 MB)
DEPOSIT_CHUNK = 1 << 18


def _by_node(axis: int, low, high):
    """(n, 8): per node of ``_NODE_OFFS``, ``high`` where the node's offset
    along ``axis`` is 1, else ``low``."""
    return torch.stack([high if o[axis] else low for o in _NODE_OFFS], -1)


def trilinear_weights(q, dx, dy, dz, r8V):
    """(n, 8) trilinear node weights w/8 * (1 +/- x)(1 +/- y)(1 +/- z),
    each the product ((w * wx) * wy) * wz."""
    w = r8V * q
    wx, wy, wz = (_by_node(a, 1.0 - d, 1.0 + d)
                  for a, d in enumerate((dx, dy, dz)))
    return w[:, None] * wx * wy * wz


def _r8V(g: Grid) -> float:
    return float(np.float32(0.125 * g.rdx * g.rdy * g.rdz))


def deposit_scale(bound, lanes: int):
    """2^S per column as float64, S = floor(62 - log2(8 * lanes * bound))
    clamped to [-200, 200]: a node takes at most one contribution per lane,
    each below ``bound`` in magnitude, so its fixed-point sum stays below
    2^62 with a factor 8 to spare.  A zero bound (a q = 0 species) gives
    2^200 and all-zero words."""
    s = torch.floor(62.0 - torch.log2(8.0 * float(lanes)
                                      * bound.to(torch.float64)))
    return torch.exp2(s.clamp(-200.0, 200.0))


def deposit_nodes(base, vox, contrib_fn, bound, g: Grid,
                  chunk: int = DEPOSIT_CHUNK):
    """``base`` (nv, c) float32 plus the per-node sums of contributions:
    ``contrib_fn(lanes)`` gives the (m, 8, c) contributions of the lane
    slice ``lanes`` at the 8 nodes of voxel ``vox[lanes]`` (deposit order
    of ``_NODE_OFFS``).  Each is rounded half to even to an integer at the
    column's scale (:func:`deposit_scale` from ``bound``, (c,) upper bounds
    of |contribution|), summed in int64 and converted back once."""
    n = vox.shape[0]
    scale = deposit_scale(bound, n)
    # node k of _NODE_OFFS is offset (k & 1, k >> 1 & 1, k >> 2 & 1), made
    # on the device: the clean steps' rho deposit runs inside CUDA graphs
    # (engine/graphs.py), whose capture refuses copies from the host
    k = torch.arange(8, dtype=torch.int64, device=vox.device)
    offs = (k & 1) + g.nxg * ((k >> 1 & 1) + g.nyg * (k >> 2 & 1))
    fix = torch.zeros(base.shape, dtype=torch.int64, device=vox.device)
    for start in range(0, n, chunk):
        lanes = slice(start, start + chunk)
        c = contrib_fn(lanes)
        words = torch.round(c.to(torch.float64) * scale).to(torch.int64)
        idx = vox[lanes].long()[:, None] + offs[None, :]
        fix.index_add_(0, idx.reshape(-1), words.reshape(-1, c.shape[-1]))
    return base + (fix.to(torch.float64) / scale).to(torch.float32)


def _bound(q, vals, r8V: float, col):
    """(c,) float64 upper bounds of |contribution| per column: a node
    weight is at most 8 |r8V q|, times |value| and the column factor
    ``col`` (mc/q for the momentum columns)."""
    if q.numel() == 0:
        return torch.zeros_like(col)
    lane = q.abs().to(torch.float64) * abs(r8V)
    return 8.0 * col * (lane[:, None] * vals.abs().to(torch.float64)) \
        .amax(dim=0)


def accumulate_rho_p(f: FieldState, sp: SpeciesState, g: Grid) -> FieldState:
    """Trilinear node deposit of charge into rhof (rho_p.c), in fixed
    point."""
    alive = sp.alive
    q = torch.where(alive, sp.q, 0.0)
    r8V = _r8V(g)
    one = torch.ones((1,), dtype=torch.float64, device=q.device)
    bound = _bound(q, torch.ones_like(q)[:, None], r8V, one)
    rhof = deposit_nodes(
        f.rhof.reshape(-1, 1), torch.where(alive, sp.i, 0),
        lambda s: trilinear_weights(q[s], sp.dx[s], sp.dy[s], sp.dz[s],
                                    r8V)[:, :, None], bound, g)
    return f.replace(rhof=rhof.reshape(g.shape))


def rhob_weights(g: Grid, vox, w):
    """Boundary-corrected node weights for rhob (boundary_p.c:53-63): a
    weight doubles on each domain-edge node plane its node sits on (the
    low nodes of cells with index 1, the high nodes of cells with index n,
    on every axis)."""
    j = vox // g.nxg
    ix = vox - j * g.nxg
    iz = j // g.nyg
    iy = j - iz * g.nyg
    for a, (n, idx) in enumerate(((g.nx, ix), (g.ny, iy), (g.nz, iz))):
        w = torch.where(_by_node(a, idx == 1, idx == n), w * 2.0, w)
    return w


def accumulate_rhob(f: FieldState, g: Grid, vox, q, dx, dy, dz,
                    mask) -> FieldState:
    """Deposit the masked lanes' charge into rhob with the boundary-
    corrected weights of :func:`rhob_weights` (absorbed, emitted and
    injected particles, boundary_p.c:9-71), in fixed point as
    :func:`accumulate_rho_p`: one bound covers the three doublings."""
    qm = torch.where(mask, q, 0.0)
    vox0 = torch.where(mask, vox, 0)
    r8V = _r8V(g)
    col = torch.full((1,), 8.0, dtype=torch.float64, device=qm.device)
    bound = _bound(qm, torch.ones_like(qm)[:, None], r8V, col)
    rhob = deposit_nodes(
        f.rhob.reshape(-1, 1), vox0,
        lambda s: rhob_weights(g, vox0[s], trilinear_weights(
            qm[s], dx[s], dy[s], dz[s], r8V))[:, :, None], bound, g)
    return f.replace(rhob=rhob.reshape(g.shape))


def hydro_moments(sp: SpeciesState, interp, g: Grid):
    """Per lane: the voxel, the charge and the 14 hydro values
    (hydro_p.c:25-161, the JAX package's operation order): columns 0-3
    (vx, vy, vz, 1) are weighted by the node weight, columns 4-13 (ux,
    uy, uz, ke, the stress products) by the node weight times mc/q."""
    alive = sp.alive
    f32 = lambda v: float(np.float32(v))
    q_m = np.float32(sp.q_m)
    qdt_2mc = f32(np.float32(np.float32(np.float32(0.5) * q_m)
                             * np.float32(g.dt)) / np.float32(g.cvac))
    qdt_4mc2 = f32(np.float32(np.float32(np.float32(0.25) * q_m)
                              * np.float32(g.dt))
                   / np.float32(g.cvac * g.cvac))
    c = f32(g.cvac)
    vox = torch.where(alive, sp.i, 0)
    ip = interp[vox.long()]
    ex, ey, ez, cbx, cby, cbz = interpolate_fields(ip, sp.dx, sp.dy, sp.dz)
    ux = sp.ux + qdt_2mc * ex
    uy = sp.uy + qdt_2mc * ey
    uz = sp.uz + qdt_2mc * ez

    ke_mc = ux * ux + uy * uy + uz * uz
    gamma = torch.sqrt(1.0 + ke_mc)
    ke_mc = ke_mc * c / (gamma + 1.0)
    vg = torch.full_like(gamma, c) / gamma
    w0 = qdt_4mc2 * vg
    w1 = cbx * cbx + cby * cby + cbz * cbz
    w2 = w0 * w0 * w1
    w3 = w0 * (1.0 + ONE_THIRD * w2 * (1.0 + 0.4 * w2))
    w4 = w3 / (1.0 + w1 * w3 * w3)
    w4 = w4 + w4
    a0 = ux + w3 * (uy * cbz - uz * cby)
    a1 = uy + w3 * (uz * cbx - ux * cbz)
    a2 = uz + w3 * (ux * cby - uy * cbx)
    ux = ux + w4 * (a1 * cbz - a2 * cby)
    uy = uy + w4 * (a2 * cbx - a0 * cbz)
    uz = uz + w4 * (a0 * cby - a1 * cbx)
    vx, vy, vz = ux * vg, uy * vg, uz * vg
    vals = torch.stack([vx, vy, vz, torch.ones_like(vx),
                        ux, uy, uz, ke_mc,
                        ux * vx, uy * vy, uz * vz, uy * vz, uz * vx, ux * vy],
                       dim=-1)
    return vox, torch.where(alive, sp.q, 0.0), vals


def accumulate_hydro_p(h, sp: SpeciesState, interp, g: Grid,
                       chunk: int = DEPOSIT_CHUNK):
    """Deposit the 14 hydrodynamic moments (hydro_p.c:25-161) into the
    (nv, 14) array ``h``, in fixed point with one scale per moment (jx and
    txx differ by orders of magnitude)."""
    vox, q, vals = hydro_moments(sp, interp, g)
    r8V = _r8V(g)
    mc_q = float(np.float32(np.float32(g.cvac) / np.float32(sp.q_m)))
    col = torch.tensor([1.0] * 4 + [abs(mc_q)] * 10, dtype=torch.float64,
                       device=vals.device)
    bound = _bound(q, vals, r8V, col)

    def contrib(s):
        w = trilinear_weights(q[s], sp.dx[s], sp.dy[s], sp.dz[s], r8V)
        wm = w * mc_q
        v = vals[s]
        return torch.cat([w[:, :, None] * v[:, None, :4],
                          wm[:, :, None] * v[:, None, 4:]], dim=-1)
    return deposit_nodes(h, vox, contrib, bound, g, chunk)


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


def sort_p_packed(psp: PackedSpecies, g: Grid) -> PackedSpecies:
    """sort_p for a PackedSpecies: a stable ``torch.sort`` by row 7; the
    dead tail stays zero and ``np`` is unchanged.  It does not keep the
    merge re-sort's carry, so it invalidates ``key0``."""
    p = psp.pk
    in_range = torch.arange(psp.max_np, dtype=torch.int32,
                            device=p.device) < psp.np
    key = torch.where(in_range, (p[7] + 0.5).to(torch.int32), 2 ** 30)
    key_s, order = torch.sort(key, stable=True)
    rows = p[:, order]
    rows[7] = torch.where(in_range, key_s, 0).to(torch.float32)
    return psp.replace(pk=rows, key0=torch.full_like(psp.key0, -1))


def sort_p_packed_merge(psp: PackedSpecies, g: Grid,
                        steps_since_sort: int = 1) -> PackedSpecies:
    """The merge re-sort of a PackedSpecies (``aux.py:215-257`` of the JAX
    package), with the mover buffer provisioned for ``steps_since_sort``
    steps of drift (:func:`sort.mover_capacity`).  Falls back to a full
    sort when the carry is missing or the movers overflow, decided on the
    device (no host read); the anomaly count (0 in any valid run) adds to
    ``nm`` on the device.  Counts the fast and slow sorts under the
    species' name (``sort_cuda.sort_counts``)."""
    m_cap = sort.mover_capacity(psp.max_np, steps_since_sort)
    res = sort_cuda.merge_sort_packed(psp.pk, psp.np, psp.key0, psp.ctot,
                                      g.nv, m_cap, species=psp.name)
    return psp.replace(pk=res.pk, key0=res.key0, ctot=res.ctot,
                       nm=psp.nm + res.anomaly)
