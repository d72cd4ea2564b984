"""Particle push and charge-conserving current deposition, plain PyTorch
(the XLA path of ``vpic_tpu/particles/push.py``).

- :func:`advance_p` (advance_p.cxx:68-183): gather the 18 interpolator
  coefficients, half-E kick, 6th-order Boris rotation, half-E kick,
  relativistic half-displacement, then the streak walk.
- :func:`streak_walk` / :func:`walk_segment` / :func:`resolve_crossing`
  (move_p.c:20-136): the streak-splitting cell walker, each segment
  depositing its 12 quadrant currents with the q*sdx*sdy*sdz/3 correction
  (advance_p.cxx:137-163) at the pre-crossing voxel.
- :func:`pack_species` / :func:`unpack_species` / :func:`advance_p_packed`:
  the packed ``(8, n)`` row layout of the merge re-sort's cycle
  (``vpic_tpu/particles/push.py:971-1129``).

This is the plain version of the hand-written CUDA kernel
(``push_cuda.py``, ``csrc/push_walk.cu``): the CPU tests run it, and the
kernel is compared with it on the card.  Every expression keeps the JAX
package's operation order, so on the card the kernel (built with
``-fmad=false``) reproduces it bit for bit.

Unlike the JAX package there is no fixed-capacity mover buffer: every lane
walks until it settles or reaches the segment cap of
``1 + 4*(n_walk-1) + 8`` segments (push.py:305 of the JAX package); a lane
still moving at the cap is counted into ``nm`` (advance.cxx:98-103).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from ..core.types import (Grid, IP, NEIGHBOR_REFLECT, PackedSpecies,
                          SpeciesState)
from . import deposit

# float32 constants, held as the Python floats torch casts back exactly
ONE_THIRD = float(np.float32(1.0 / 3.0))
TWO_FIFTEENTHS = float(np.float32(2.0 / 15.0))
BIG = float(np.float32(3.4e38))

# pcode values (per-particle boundary status)
PC_DONE = 0          # settled in a voxel
PC_EXHAUSTED = 1     # still moving at the segment cap
# negative: the neighbor-table boundary code that stopped the walk


def segment_cap(n_walk: int) -> int:
    """Segments a lane may walk in one push: segment 1, then
    :func:`streak_walk`'s ``4*n_iter + 8`` with ``n_iter = n_walk - 1``."""
    return 1 + 4 * (n_walk - 1) + 8


def push_params(sp: SpeciesState, g: Grid):
    """(qdt_2mc, cdt_dx, cdt_dy, cdt_dz) as float32 host scalars, rounded
    as the JAX package rounds them."""
    q_m = np.float32(sp.q_m)
    qdt_2mc = np.float32(np.float32(np.float32(0.5) * q_m) * np.float32(g.dt))
    qdt_2mc = np.float32(qdt_2mc / np.float32(g.cvac))
    cdt = tuple(np.float32(g.cvac * g.dt * r) for r in (g.rdx, g.rdy, g.rdz))
    return (float(qdt_2mc),) + tuple(float(c) for c in cdt)


def _rdiv(s: float, x):
    """s / x rounded once.  PyTorch evaluates ``scalar / tensor`` as
    ``reciprocal(tensor) * scalar``, two roundings."""
    return torch.full_like(x, s) / x


def interpolate_fields(ip, dx, dy, dz):
    """E (first-order in-plane expansion) and cB (linear) at the particle
    (advance_p.cxx:74-82) from the gathered (n, 18) coefficient rows."""
    c = lambda k: ip[:, IP[k]]
    ex = (c("ex") + dy * c("dexdy")) + dz * (c("dexdz") + dy * c("d2exdydz"))
    ey = (c("ey") + dz * c("deydz")) + dx * (c("deydx") + dz * c("d2eydzdx"))
    ez = (c("ez") + dx * c("dezdx")) + dy * (c("dezdy") + dx * c("d2ezdxdy"))
    cbx = c("cbx") + dx * c("dcbxdx")
    cby = c("cby") + dy * c("dcbydy")
    cbz = c("cbz") + dz * c("dcbzdz")
    return ex, ey, ez, cbx, cby, cbz


def boris_rotation(ux, uy, uz, cbx, cby, cbz, v0):
    """Boris rotation with v0 = (q dt'/2mc)/gamma (advance_p.cxx:91-102);
    v3 carries the tan(theta/2)/(theta/2) Taylor correction."""
    v1 = cbx * cbx + (cby * cby + cbz * cbz)
    v2 = (v0 * v0) * v1
    v3 = v0 * (1.0 + v2 * (ONE_THIRD + v2 * TWO_FIFTEENTHS))
    v4 = v3 / (1.0 + v1 * (v3 * v3))
    v4 = v4 + v4
    w0 = ux + v3 * (uy * cbz - uz * cby)
    w1 = uy + v3 * (uz * cbx - ux * cbz)
    w2 = uz + v3 * (ux * cby - uy * cbx)
    ux = ux + v4 * (w1 * cbz - w2 * cby)
    uy = uy + v4 * (w2 * cbx - w0 * cbz)
    uz = uz + v4 * (w0 * cby - w1 * cbx)
    return ux, uy, uz


def push_momentum(ip, dx, dy, dz, ux, uy, uz, qdt_2mc, cdt):
    """Boris push and normalized half-displacement (advance_p.cxx:74-116).
    Returns (ux, uy, uz, ddx, ddy, ddz)."""
    ex, ey, ez, cbx, cby, cbz = interpolate_fields(ip, dx, dy, dz)
    hax, hay, haz = qdt_2mc * ex, qdt_2mc * ey, qdt_2mc * ez
    ux = ux + hax
    uy = uy + hay
    uz = uz + haz
    v0 = _rdiv(qdt_2mc, torch.sqrt(1.0 + (ux * ux + (uy * uy + uz * uz))))
    ux, uy, uz = boris_rotation(ux, uy, uz, cbx, cby, cbz, v0)
    ux = ux + hax
    uy = uy + hay
    uz = uz + haz
    v0 = _rdiv(1.0, torch.sqrt(1.0 + (ux * ux + (uy * uy + uz * uz))))
    return (ux, uy, uz,
            (ux * cdt[0]) * v0, (uy * cdt[1]) * v0, (uz * cdt[2]) * v0)


def deposit12_cols(q, sdx, sdy, sdz, smx, smy, smz):
    """Quadrant currents of a streak with half-displacement (sdx,sdy,sdz)
    and midpoint (smx,smy,smz): ACCUMULATE_J of advance_p.cxx:140-158 for
    the three axis permutations; a tuple of 12 (n,) tensors."""
    v5 = q * sdx * sdy * sdz * ONE_THIRD
    sd = (sdx, sdy, sdz)
    sm = (smx, smy, smz)
    cols = []
    for X, Y, Z in ((0, 1, 2), (1, 2, 0), (2, 0, 1)):
        vX = q * sd[X]
        my, mz = sm[Y], sm[Z]
        cols += [vX * (1.0 - my) * (1.0 - mz) + v5,
                 vX * (1.0 + my) * (1.0 - mz) - v5,
                 vX * (1.0 - my) * (1.0 + mz) - v5,
                 vX * (1.0 + my) * (1.0 + mz) + v5]
    return tuple(cols)


def compact_indices(mask, k: int, max_np: int):
    """Stable indices of the first k true entries of ``mask``, padded with
    ``max_np`` (``vpic_tpu/particles/push.py:121``): an O(n) prefix sum
    and an O(k log n) search, with no host read.  Returns (sel, n_true,
    valid): (k,) int64 indices, the 0-d int32 count of true entries, and
    (k,) bool ``slot < n_true``."""
    k = min(k, mask.shape[0])
    # the j-th true entry is the first whose running count reaches j: a
    # binary search of the k ranks in the running count, so nothing of
    # length n is scattered
    count = torch.cumsum(mask.to(torch.int32), 0)
    rank = torch.arange(1, k + 1, dtype=torch.int32, device=mask.device)
    n_true = count[-1]
    valid = rank <= n_true
    return (torch.where(valid, torch.searchsorted(count, rank), max_np),
            n_true, valid)


class WalkState(NamedTuple):
    """Streak-walker state, one (n,) tensor per quantity."""
    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor
    vox: torch.Tensor       # int32
    ux: torch.Tensor
    uy: torch.Tensor
    uz: torch.Tensor
    rx: torch.Tensor        # remaining half-displacement
    ry: torch.Tensor
    rz: torch.Tensor
    q: torch.Tensor
    pcode: torch.Tensor     # int32
    active: torch.Tensor    # bool


def walk_segment(st: WalkState, neighbor, g: Grid):
    """One streak segment for every lane (the loop body of
    move_p.c:34-134).  Returns (state, deposit voxel, 12 contribution
    columns); inactive lanes contribute zeros at voxel 0."""
    pos = (st.x, st.y, st.z)
    rem = (st.rx, st.ry, st.rz)
    u = (st.ux, st.uy, st.uz)

    sdir = tuple(torch.where(r > 0, 1.0, -1.0) for r in rem)
    # clamp to >= 0: a lane 1 ulp outside its face (reflection/wrap
    # rounding) would otherwise walk backward forever; 0 makes it a
    # zero-length crossing that snaps the coordinate onto the face
    frac2 = tuple(torch.where(r == 0, BIG, torch.clamp((d - p) / r, min=0.0))
                  for r, d, p in zip(rem, sdir, pos))
    # sequential min with later-axis tie priority (move_p.c:59-62)
    v3 = torch.full_like(st.q, 2.0)
    stype = torch.full_like(st.vox, 3)
    for a in range(3):
        hit = frac2[a] < v3
        v3 = torch.where(hit, frac2[a], v3)
        stype = torch.where(hit, a, stype)
    v3 = v3 * 0.5

    sd = tuple(r * v3 for r in rem)
    sm = tuple(p + d for p, d in zip(pos, sd))
    q_eff = torch.where(st.active, st.q, 0.0)
    contrib = deposit12_cols(q_eff, *sd, *sm)
    dep_vox = torch.where(st.active, st.vox, 0)

    rem_new = tuple(r - d for r, d in zip(rem, sd))
    pos_new = tuple(p + 2.0 * d for p, d in zip(pos, sd))
    st = resolve_crossing(st, pos, rem, u, pos_new, rem_new, stype, sdir,
                          neighbor, g)
    return st, dep_vox, contrib


def resolve_crossing(st: WalkState, pos, rem, u, pos_new, rem_new,
                     stype, sdir, neighbor, g: Grid):
    """The boundary half of a segment (move_p.c:112-133): a crossing into
    a voxel flips the coordinate, a reflecting face flips momentum and
    displacement, any other code stops the lane with that code."""
    done = stype == 3
    hit_ax = tuple(stype == a for a in range(3))
    dir_hit = sum(torch.where(h, d, 0.0) for h, d in zip(hit_ax, sdir))
    face = stype + torch.where(dir_hit > 0, 3, 0)   # move_p.c:123
    safe_face = torch.where(done, 0, face)
    nb = neighbor.reshape(-1)[(6 * st.vox + safe_face).long()]

    crossed = ~done & (nb >= 0) & st.active
    reflected = ~done & (nb == NEIGHBOR_REFLECT) & st.active
    stopped = ~done & (nb < 0) & (nb != NEIGHBOR_REFLECT) & st.active

    out_pos, out_rem, out_u = [], [], []
    for a in range(3):
        h = hit_ax[a]
        pa = torch.where(crossed & h, -dir_hit,
                         torch.where((reflected | stopped) & h, dir_hit,
                                     pos_new[a]))
        ra = torch.where(reflected & h, -rem_new[a], rem_new[a])
        ua = torch.where(reflected & h, -u[a], u[a])
        out_pos.append(torch.where(st.active, pa, pos[a]))
        out_rem.append(torch.where(st.active, ra, rem[a]))
        out_u.append(torch.where(st.active, ua, u[a]))

    return WalkState(
        x=out_pos[0], y=out_pos[1], z=out_pos[2],
        vox=torch.where(crossed, nb, st.vox),
        ux=out_u[0], uy=out_u[1], uz=out_u[2],
        rx=out_rem[0], ry=out_rem[1], rz=out_rem[2],
        q=st.q, pcode=torch.where(stopped, nb, st.pcode),
        active=st.active & ~(done | stopped))


def streak_walk(st: WalkState, acc, neighbor, g: Grid, n_iter: int,
                deposit_fn=deposit.deposit_sorted_into):
    """Walk the active lanes for up to ``4*n_iter + 8`` segments, each
    depositing into ``acc`` through ``deposit_fn`` (as in
    :func:`advance_p_steps`); lanes still active after that get
    PC_EXHAUSTED.  Returns (state with every lane inactive, acc).  Only
    the lanes active at entry are gathered and walked."""
    idx = torch.nonzero(st.active).squeeze(1)
    sub = WalkState(*(t[idx] for t in st))
    for _ in range(4 * n_iter + 8):
        if not bool(sub.active.any()):
            break
        was_active = sub.active
        sub, dep_vox, contrib = walk_segment(sub, neighbor, g)
        acc, _ = deposit_fn(acc, dep_vox, contrib, was_active, g.nv)
    sub = sub._replace(
        pcode=torch.where(sub.active, PC_EXHAUSTED, sub.pcode),
        active=torch.zeros_like(sub.active))
    out = []
    for full, part in zip(st, sub):
        full = full.clone()
        full[idx] = part
        out.append(full)
    return WalkState(*out), acc


def pushed_walk_state(sp: SpeciesState, interp, g: Grid) -> WalkState:
    """The pushed momenta and the walk's starting state: every live lane
    active at its position, with its half-displacement to walk."""
    qdt_2mc, *cdt = push_params(sp, g)
    alive = sp.alive
    vox = torch.where(alive, sp.i, 0)
    ux, uy, uz, ddx, ddy, ddz = push_momentum(
        interp[vox.long()], sp.dx, sp.dy, sp.dz, sp.ux, sp.uy, sp.uz,
        qdt_2mc, cdt)
    return WalkState(x=sp.dx, y=sp.dy, z=sp.dz, vox=vox, ux=ux, uy=uy,
                     uz=uz, rx=ddx, ry=ddy, rz=ddz, q=sp.q,
                     pcode=torch.zeros_like(sp.pc), active=alive)


def advance_p(sp: SpeciesState, interp, acc, neighbor, g: Grid,
              n_walk: int = 4, count_pending: bool = True):
    """One push of a whole species; returns (species, acc).

    The plain version of both kernel paths of ``push_cuda.advance_p``,
    the fused push+walk kernel and the unfused path with the deposit
    kernel (``vpic_tpu/particles/push.py:506-549``): both compute the same
    sums, so the flags that choose between them there have no counterpart
    here.  ``count_pending``: see :func:`advance_p_steps`."""
    return advance_p_steps(sp, interp, acc, neighbor, g, n_walk,
                           deposit.deposit_sorted_into, streak_walk,
                           count_pending)


def advance_p_steps(sp: SpeciesState, interp, acc, neighbor, g: Grid,
                    n_walk: int, deposit_fn, walk_fn,
                    count_pending: bool = True):
    """The unfused push.  Segment 1 of the walk runs over every slot and
    ``deposit_fn(acc, vox, contrib, alive, nv) -> (acc, dropped)`` adds
    its currents; the lanes still moving continue in ``walk_fn`` (a
    :func:`streak_walk`) with ``n_iter = n_walk - 1``.  Dead slots
    (``slot >= np`` or ``i < 0``) keep their state.  ``nm`` adds any lane
    the deposit dropped and, with ``count_pending``, the lanes left
    pending (exhausted, or stopped by a boundary code).  Without it they
    are left to the boundary rounds that follow, which count what they
    cannot resolve (``vpic_tpu/particles/push.py:488-490, 612-615``)."""
    alive = sp.alive
    st = pushed_walk_state(sp, interp, g)
    st, dep_vox, contrib = walk_segment(st, neighbor, g)
    acc, dropped = deposit_fn(acc, dep_vox, contrib, alive, g.nv)
    st, acc = walk_fn(st, acc, neighbor, g, n_walk - 1)

    pend = st.pcode != PC_DONE
    keep = lambda new, old: torch.where(alive, new, old)
    nm = sp.nm + dropped
    if count_pending:
        nm = nm + torch.sum(alive & pend).to(torch.int32)
    sp = sp.replace(
        dx=keep(st.x, sp.dx), dy=keep(st.y, sp.dy), dz=keep(st.z, sp.dz),
        i=keep(st.vox, sp.i),
        ux=keep(st.ux, sp.ux), uy=keep(st.uy, sp.uy), uz=keep(st.uz, sp.uz),
        mdx=torch.where(pend, st.rx, 0.0), mdy=torch.where(pend, st.ry, 0.0),
        mdz=torch.where(pend, st.rz, 0.0), pc=st.pcode, nm=nm)
    return sp, acc


def advance_p_fixed(sp: SpeciesState, interp, acc, neighbor, g: Grid,
                    n_walk: int = 4, count_pending: bool = True):
    """:func:`advance_p` with the push kernel's fixed-point deposit
    (``deposit.deposit_fixed`` at the kernel's scale from ``sp.q``): the
    plain twin of ``push_cuda.advance_p``, whose accumulator it equals bit
    for bit on the card.  For the tests and ``chip_smoke.py``."""
    scale = deposit.fixed_scale(sp.q, segment_cap(n_walk), sp.max_np)
    dep = deposit.deposit_fixed(scale)
    fix = torch.zeros((g.nv, 12), dtype=torch.int64, device=acc.device)
    sp, fix = advance_p_steps(sp, interp, fix, neighbor, g, n_walk, dep,
                              functools.partial(streak_walk, deposit_fn=dep),
                              count_pending)
    return sp, deposit.unfix(acc, fix, scale)


def streak_walk_fixed(st: WalkState, acc, neighbor, g: Grid, n_iter: int):
    """:func:`streak_walk` with the kernel's fixed-point deposit: the plain
    twin of ``push_cuda.streak_walk`` (the walk_only entry)."""
    scale = deposit.fixed_scale(st.q, 4 * n_iter + 8, st.x.shape[0])
    fix = torch.zeros((g.nv, 12), dtype=torch.int64, device=acc.device)
    st, fix = streak_walk(st, fix, neighbor, g, n_iter,
                          deposit_fn=deposit.deposit_fixed(scale))
    return st, deposit.unfix(acc, fix, scale)


def _center(sp, interp, kick, rot, kick_first):
    ip = interp[sp.i.long()]
    ex, ey, ez, cbx, cby, cbz = interpolate_fields(ip, sp.dx, sp.dy, sp.dz)
    hax, hay, haz = kick * ex, kick * ey, kick * ez
    ux, uy, uz = sp.ux, sp.uy, sp.uz
    if kick_first:
        ux, uy, uz = ux + hax, uy + hay, uz + haz
    v0 = _rdiv(rot, torch.sqrt(1.0 + (ux * ux + (uy * uy + uz * uz))))
    ux, uy, uz = boris_rotation(ux, uy, uz, cbx, cby, cbz, v0)
    if not kick_first:
        ux, uy, uz = ux + hax, uy + hay, uz + haz
    return sp.replace(ux=ux, uy=uy, uz=uz)


def center_p(sp: SpeciesState, interp, g: Grid) -> SpeciesState:
    """u_{-1/2} -> u_0: half-E kick then half Boris rotation
    (center_p.cxx:13-70)."""
    qdt_2mc = push_params(sp, g)[0]
    return _center(sp, interp, qdt_2mc, float(np.float32(0.5 * qdt_2mc)),
                   kick_first=True)


def uncenter_p(sp: SpeciesState, interp, g: Grid) -> SpeciesState:
    """u_0 -> u_{-1/2}: backward half rotation then backward half kick
    (uncenter_p.cxx:14-70)."""
    qdt_2mc = push_params(sp, g)[0]
    return _center(sp, interp, -qdt_2mc, float(np.float32(-0.5 * qdt_2mc)),
                   kick_first=False)


def energy_p(sp: SpeciesState, interp, g: Grid):
    """Local kinetic energy sum q*|u+halfkick|^2/(sqrt(1+|u|^2)+1) in
    float64 (energy_p.cxx:31-46, 124-157); finish with
    :func:`finish_energy_p`."""
    qdt_2mc = push_params(sp, g)[0]
    ip = interp[sp.i.long()]
    ex, ey, ez, _, _, _ = interpolate_fields(ip, sp.dx, sp.dy, sp.dz)
    v0 = sp.ux + qdt_2mc * ex
    v1 = sp.uy + qdt_2mc * ey
    v2 = sp.uz + qdt_2mc * ez
    usq = v0 * v0 + v1 * v1 + v2 * v2
    ke = usq / (torch.sqrt(1.0 + usq) + 1.0)
    return torch.sum(torch.where(sp.alive, ke.to(torch.float64)
                                 * sp.q.to(torch.float64), 0.0))


def finish_energy_p(sp: SpeciesState, g: Grid, global_en):
    scale = np.float32(g.cvac * g.cvac) / np.float32(sp.q_m)
    return float(scale) * global_en


def pack_species(sp: SpeciesState, g: Grid) -> PackedSpecies:
    """SpeciesState -> PackedSpecies.  The species must be zombie-free
    (run ``aux.sort_p`` first); the first merge re-sort sees no snapshot
    (``key0[0] = -1``) and sorts in full."""
    if g.nv >= 2 ** 24:
        raise ValueError(f"nv = {g.nv}: row 7 holds voxels as float32 "
                         "integers, exact only below 2**24")
    alive = sp.alive
    rows = torch.stack([sp.dx, sp.dy, sp.dz, sp.ux, sp.uy, sp.uz,
                        torch.where(alive, sp.q, 0.0),
                        torch.where(alive, sp.i, 0).to(torch.float32)])
    dev = rows.device
    return PackedSpecies(
        name=sp.name, sid=sp.sid, max_np=sp.max_np,
        sort_interval=sp.sort_interval, q_m=sp.q_m, np=sp.np, nm=sp.nm,
        pk=rows,
        key0=torch.full((sp.max_np,), -1, dtype=torch.int32, device=dev),
        ctot=torch.zeros((g.nv + 3,), dtype=torch.int32, device=dev))


def unpack_species(psp: PackedSpecies, g: Grid) -> SpeciesState:
    """PackedSpecies -> SpeciesState, mover columns and tags cleared (a
    packed cycle has no boundary rounds: its pending lanes were dropped
    and counted in ``nm``)."""
    p = psp.pk
    in_range = torch.arange(psp.max_np, dtype=torch.int32,
                            device=p.device) < psp.np
    zf = torch.zeros_like(p[0])
    zi = torch.zeros((psp.max_np,), dtype=torch.int32, device=p.device)
    return SpeciesState(
        name=psp.name, sid=psp.sid, max_np=psp.max_np,
        sort_interval=psp.sort_interval, q_m=psp.q_m, np=psp.np, nm=psp.nm,
        dx=p[0], dy=p[1], dz=p[2],
        i=torch.where(in_range, (p[7] + 0.5).to(torch.int32), 0),
        ux=p[3], uy=p[4], uz=p[5], q=p[6],
        mdx=zf, mdy=zf, mdz=zf, pc=zi, tag=zi)


def advance_p_packed(psp: PackedSpecies, interp, acc, neighbor, g: Grid,
                     n_walk: int = 4):
    """:func:`advance_p` on the rows of a PackedSpecies; pending lanes are
    dropped and counted in ``nm``.  The plain version of
    ``push_cuda.advance_p_packed``."""
    sp, acc = advance_p(unpack_species(psp, g), interp, acc, neighbor, g,
                        n_walk=n_walk)
    pk = torch.stack([sp.dx, sp.dy, sp.dz, sp.ux, sp.uy, sp.uz, psp.pk[6],
                      sp.i.to(torch.float32)])
    return psp.replace(pk=pk, nm=sp.nm), acc
