"""Boundary rounds: absorption, custom handlers, migration between shards
and the continuation of unfinished streak walks
(``vpic_tpu/particles/boundary.py``; the reference's guard-list drain,
boundary_p.c:77-505).

Each species carries per-lane boundary codes (``pc``).  A round compacts
every pending lane (``pc != 0``) into one buffer of fixed capacity
``max_inj`` (the particle_injector_t analogue, species_advance.h:48-55),
deposits absorbed lanes into rhob, runs the custom handlers, sends the
lanes that left through a face between shards to the neighbor shard (one
payload of 12 words per lane per face of a sharded axis, at most
``mig_cap`` lanes; the rest keep their code and go in a later round), walks the lanes left
``PC_EXHAUSTED`` together with the lanes received (the push kernel's
``walk_only`` entry on the card, ``push.streak_walk`` on the CPU),
scatters the buffer back and appends the received lanes at ``np``.
Dead lanes are tombstoned with ``i = -1`` and reclaimed by the next
``aux.sort_p``.  Nothing reads the host: a round costs the same whether
or not anything is pending, as in the JAX package.
"""

from __future__ import annotations

import torch

from ..core.types import (FACE_AXIS, FieldState, Grid, NEIGHBOR_ABSORB,
                          NEIGHBOR_MIGRATE_BASE, SpeciesState)
from . import push_cuda
from .aux import accumulate_rhob
from .push import PC_EXHAUSTED, WalkState, compact_indices

# the buffer's columns, and the species column each comes from; no
# handler reads the tags and a round leaves them as they are
_COLUMNS = dict(dx="dx", dy="dy", dz="dz", vox="i", ux="ux", uy="uy",
                uz="uz", q="q", mdx="mdx", mdy="mdy", mdz="mdz", pc="pc")
# the species columns that the rounds, the emitters and the injector write
# (and the tags, where lanes arrive from another shard or the injector)
WRITTEN = tuple(_COLUMNS.values())
# a migration payload's rows; tag and vox ride as float32 bit patterns
_PAYLOAD = ("dx", "dy", "dz", "ux", "uy", "uz", "q", "mdx", "mdy", "mdz",
            "tag", "vox")


def scatter_into(col, idx, valid, vals):
    """``col[idx] = vals`` in place, for the slots ``idx`` of
    :func:`scatter_index`: the lanes past the ``valid`` prefix write the
    value that lands in their slot anyway (lane 0's, or ``col[0]`` when no
    lane is valid), so the result does not depend on the order of the
    writes."""
    vals = vals.to(col.dtype)
    first = torch.where(valid[:1], vals[:1], col[:1])
    col.index_put_((idx,), torch.where(valid, vals, first))


def scatter_index(sel, valid):
    """The slots of :func:`scatter_into`: ``sel`` on the valid prefix,
    lane 0's slot (or 0 when no lane is valid) after it."""
    return torch.where(valid, sel, torch.where(valid[:1], sel[:1], 0))


def owned(sp: SpeciesState, given: SpeciesState,
          columns=WRITTEN) -> SpeciesState:
    """``sp`` with a copy of each of ``columns`` that is still the tensor
    of ``given`` (the species as the step received it) or shares its
    memory with another of them, so that writing them in place leaves the
    caller's state untouched and each column its own."""
    seen, copies = set(), {}
    for c in columns:
        col = getattr(sp, c)
        if col is getattr(given, c) or col.data_ptr() in seen:
            col = copies[c] = col.clone()
        seen.add(col.data_ptr())
    return sp.replace(**copies)


def claim_block(sp: SpeciesState, wanted):
    """The static block of ``K = len(wanted)`` slots at ``np`` that an
    emitter or an injector writes in place with :func:`scatter_into`.
    Returns (idx, fits, ok, sp): the slots, which lanes have one below
    ``max_np``, which wanted lanes fit, and ``sp`` with ``np`` grown to
    its highest fitting wanted lane (a step that wants nothing does not
    grow it) and the wanted lanes that do not fit counted in ``nm``, as
    dropped (the JAX package drops them without a count)."""
    lane = torch.arange(wanted.shape[0], dtype=torch.int32,
                        device=wanted.device)
    slot = sp.np + lane
    fits = slot < sp.max_np
    ok = wanted & fits
    top = torch.max(torch.where(ok, lane + 1, 0))
    lost = torch.sum(wanted & ~fits).to(torch.int32)
    return (scatter_index(slot.long(), fits), fits, ok,
            sp.replace(np=sp.np + top, nm=sp.nm + lost))


def pending_buffer(sp: SpeciesState, max_inj: int, tags: bool = False):
    """Compact every pending lane (alive, ``pc != 0``) of ``sp`` into one
    buffer of ``min(max_inj, max_np)`` lanes.  Returns (sel, valid, b):
    the species slot of each buffer lane, which lanes hold one, and the
    buffer's columns (``_COLUMNS``, and ``tag`` where ``tags``; empty
    lanes carry q = 0, pc = 0)."""
    sel, _, valid = compact_indices(sp.alive & (sp.pc != 0),
                                    min(max_inj, sp.max_np), sp.max_np)
    safe = torch.where(valid, sel, 0)
    cols = dict(_COLUMNS, tag="tag") if tags else _COLUMNS
    b = {k: getattr(sp, c)[safe] for k, c in cols.items()}
    b["q"] = torch.where(valid, b["q"], 0.0)
    b["pc"] = torch.where(valid, b["pc"], 0)
    return sel, valid, b


def resolve_buffer(b, valid, f: FieldState, g: Grid, sid: int, handlers=(),
                   bstate=(), key=None, step=None):
    """Steps 1 and 1b of a round: the absorbed lanes deposit their charge
    into rhob and die; each custom handler takes the lanes its code
    addresses (with its own key under ``key``).  Returns (b, live, f,
    bstate)."""
    absorbed = b["pc"] == NEIGHBOR_ABSORB
    if NEIGHBOR_ABSORB in g.pbc:
        # (no lane can carry the code where no face absorbs: the deposit
        # would add zeros)
        f = accumulate_rhob(f, g, b["vox"], b["q"], b["dx"], b["dy"],
                            b["dz"], absorbed)
    live = valid & ~absorbed
    if handlers:
        from ..boundary.models import decode_handler
        from ..core import random as rnd
        hid, hface = decode_handler(b["pc"])
        bstate = list(bstate)
        keys = rnd.split(key, len(handlers))
        for hi, handler in enumerate(handlers):
            hmask = live & (b["pc"] <= -9) & (hid == hi)
            b, f, bstate[hi], killed = handler.apply(
                keys[hi], b, hmask, hface, f, g, sid, bstate[hi],
                step=step)
            live = live & ~killed
        bstate = tuple(bstate)
    return b, live, f, bstate


def buffer_walk_state(b, live):
    """Step 3's input: the live lanes left ``PC_EXHAUSTED`` walk on from
    their remaining displacement.  Returns (walk state, walkable)."""
    walkable = live & (b["pc"] == PC_EXHAUSTED)
    st = WalkState(
        x=b["dx"], y=b["dy"], z=b["dz"], vox=b["vox"],
        ux=b["ux"], uy=b["uy"], uz=b["uz"],
        rx=b["mdx"], ry=b["mdy"], rz=b["mdz"],
        q=torch.where(walkable, b["q"], 0.0),
        pcode=torch.zeros_like(b["pc"]), active=walkable)
    return st, walkable


def migration_faces(g: Grid) -> tuple:
    """The faces through which a lane can leave for another shard: both
    faces of every sharded axis (the neighbor table gives migrate codes
    nowhere else)."""
    shards = (g.gpx, g.gpy, g.gpz)
    return tuple(f for f in range(6) if shards[FACE_AXIS[f]] > 1)


def remap_voxel_through_face(g: Grid, vox, face):
    """The voxel on the destination shard of a lane that left through
    ``face`` (an int, or a tensor of faces): the same transverse cell, the
    axis coordinate at the entering edge (cell 1 after a high face, cell
    n after a low one; every shard has the same local dims)
    (``vpic_tpu/particles/boundary.py:_remap_voxel_through_face``)."""
    face = torch.as_tensor(face, device=vox.device)
    axis = face % 3
    pick = lambda x, y, z: torch.where(axis == 0, x,
                                       torch.where(axis == 1, y, z))
    stride = pick(1, g.nxg, g.nxg * g.nyg)
    c = (vox // stride) % pick(g.nxg, g.nyg, g.nzg)
    return (vox + (torch.where(face >= 3, 1, pick(g.nx, g.ny, g.nz)) - c)
            * stride).to(vox.dtype)


_SLOTS: dict = {}


def _face_slots(faces, device):
    """(6,) int64: each face's payload slot among ``faces``, len(faces)
    for the others; and arange(len(faces)); made once per device."""
    key = (faces, torch.device(device))
    if key not in _SLOTS:
        slot = [faces.index(f) if f in faces else len(faces)
                for f in range(6)]
        _SLOTS[key] = (torch.tensor(slot, device=device),
                       torch.arange(len(faces), device=device))
    return _SLOTS[key]


def migration_payloads(b, live, g: Grid, kcap: int):
    """Step 2 of a round: per face of a sharded axis, the (kcap, 12)
    float32 payload of the first ``kcap`` live lanes whose code says they
    left through it (columns ``_PAYLOAD``: the position mirrored on the
    face's axis, leaving at +1 enters at -1, and the destination voxel;
    rows past the face's lanes hold zeros and voxel -1, so that nothing
    unset reaches a dead slot), and which buffer lanes went
    (the others keep their code and are retried in the next round).  All
    faces at once: one table of payloads, written by one row scatter."""
    faces = migration_faces(g)
    slot_of, slots = _face_slots(faces, live.device)
    face = NEIGHBOR_MIGRATE_BASE - b["pc"]
    mig = live & (face >= 0) & (face < 6)
    fs = slot_of[face.clamp(0, 5).long()]
    # each lane's rank among the lanes that leave through its face: a
    # running count along the lanes of each face's row (the inner axis,
    # which the card scans fast)
    mine = mig[None, :] & (fs[None, :] == slots[:, None])
    rank = torch.cumsum(mine.to(torch.int32), 1, dtype=torch.int32).gather(
        0, fs.clamp(max=len(faces) - 1)[None, :])[0] - 1
    sent = mig & (rank < kcap)
    dest = torch.where(sent, fs * kcap + rank, len(faces) * kcap)
    axis = face % 3
    pos = [torch.where(axis == a, -b[k], b[k])
           for a, k in enumerate(("dx", "dy", "dz"))]
    vox = remap_voxel_through_face(g, b["vox"], face)
    rows = torch.stack(pos + [b[k] for k in _PAYLOAD[3:10]]
                       + [b["tag"].view(torch.float32),
                          vox.view(torch.float32)], 1)
    table = torch.zeros((len(faces) * kcap + 1, len(_PAYLOAD)),
                        dtype=torch.float32, device=live.device)
    table[:, 11] = torch.tensor(-1, dtype=torch.int32).view(torch.float32)
    table.index_copy_(0, dest, rows)
    return {f: table[k * kcap:(k + 1) * kcap]
            for k, f in enumerate(faces)}, sent


def received_lanes(recv: dict):
    """Step 5's input: the lanes of every received payload (faces in
    order), compacted to a prefix.  Returns (columns, valid)."""
    rows = torch.cat([recv[f] for f in sorted(recv) if recv[f] is not None])
    k = rows.shape[0]
    sel, _, valid = compact_indices(rows[:, 11].view(torch.int32) >= 0, k, k)
    rows = rows[torch.where(valid, sel, 0)]
    cols = {name: rows[:, r] for r, name in enumerate(_PAYLOAD)}
    cols["tag"] = cols["tag"].view(torch.int32)
    cols["vox"] = cols["vox"].view(torch.int32)
    return cols, valid


def process_boundary(sp: SpeciesState, f: FieldState, acc, neighbor,
                     g: Grid, pcomm, max_inj: int, n_walk: int = 4,
                     handlers=(), bstate=(), key=None, step=None,
                     mig_cap=None):
    """One boundary round for one species: compact, absorb, handle,
    migrate (``pcomm``: the shard's ``ShardComm``; every shard runs the
    round), walk the buffer and the received lanes in one call
    (``push_cuda.streak_walk``: the kernel's walk_only entry on the card),
    scatter back, append the received lanes.  Returns (sp, f, acc,
    bstate).  The buffer is scattered into ``sp``'s own columns in place:
    the caller owns them (see :func:`owned`); the JAX package's version
    copies each column.  Received lanes past ``max_np`` are dropped and
    counted in ``nm`` (the JAX package drops them without a count)."""
    sel, valid, b = pending_buffer(sp, max_inj, tags=pcomm is not None)
    b, live, f, bstate = resolve_buffer(b, valid, f, g, sp.sid, handlers,
                                        bstate, key, step)
    recv = None
    if pcomm is not None and migration_faces(g):
        n = valid.shape[0]
        kcap = n if mig_cap is None else min(mig_cap, n)
        payloads, sent = migration_payloads(b, live, g, kcap)
        recv = pcomm.exchange(payloads)
        live = live & ~sent
    st, walkable = buffer_walk_state(b, live)
    nb = walkable.shape[0]
    if recv is not None:
        r, rvalid = received_lanes(recv)
        ridx, rfits, rok, sp = claim_block(sp, rvalid)
        st_r = WalkState(
            x=r["dx"], y=r["dy"], z=r["dz"],
            vox=torch.where(rok, r["vox"], 0), ux=r["ux"], uy=r["uy"],
            uz=r["uz"], rx=r["mdx"], ry=r["mdy"], rz=r["mdz"],
            q=torch.where(rok, r["q"], 0.0),
            pcode=torch.zeros_like(r["vox"]), active=rok)
        st = WalkState(*(torch.cat([a, c]) for a, c in zip(st, st_r)))
    st, acc = push_cuda.streak_walk(st, acc, neighbor, g, n_walk)
    if recv is not None:
        st, st_r = (WalkState(*(t[:nb] for t in st)),
                    WalkState(*(t[nb:] for t in st)))
        pend = st_r.pcode != 0
        res = dict(
            dx=st_r.x, dy=st_r.y, dz=st_r.z,
            i=torch.where(rok, st_r.vox, -1),
            ux=st_r.ux, uy=st_r.uy, uz=st_r.uz,
            q=torch.where(rok, r["q"], 0.0),
            mdx=torch.where(pend, st_r.rx, 0.0),
            mdy=torch.where(pend, st_r.ry, 0.0),
            mdz=torch.where(pend, st_r.rz, 0.0),
            pc=torch.where(rok, st_r.pcode, 0), tag=r["tag"])
        for c, v in res.items():
            scatter_into(getattr(sp, c), ridx, rfits, v)

    mix = lambda walked, kept: torch.where(walkable, walked, kept)
    pc = torch.where(walkable, st.pcode, torch.where(live, b["pc"], 0))
    pend = pc != 0
    res = dict(
        dx=mix(st.x, b["dx"]), dy=mix(st.y, b["dy"]), dz=mix(st.z, b["dz"]),
        # dead buffer lanes (absorbed, killed or migrated) are tombstoned
        vox=torch.where(live, mix(st.vox, b["vox"]), -1),
        ux=mix(st.ux, b["ux"]), uy=mix(st.uy, b["uy"]),
        uz=mix(st.uz, b["uz"]),
        q=torch.where(live, b["q"], 0.0),
        mdx=mix(torch.where(pend, st.rx, 0.0), b["mdx"]),
        mdy=mix(torch.where(pend, st.ry, 0.0), b["mdy"]),
        mdz=mix(torch.where(pend, st.rz, 0.0), b["mdz"]),
        pc=pc)

    # scatter the buffer back
    idx = scatter_index(sel, valid)
    for k, v in res.items():
        scatter_into(getattr(sp, _COLUMNS[k]), idx, valid, v)
    return sp, f, acc, bstate


def finish_boundary(sp: SpeciesState) -> SpeciesState:
    """After the rounds: count the lanes still pending as dropped movers
    (cumulative, the reference's "Ignoring %i unprocessed movers",
    advance.cxx:98-103) and clear the mover columns."""
    leftover = sp.alive & (sp.pc != 0)
    z = torch.zeros_like(sp.mdx)
    return sp.replace(nm=sp.nm + torch.sum(leftover).to(torch.int32),
                      pc=torch.zeros_like(sp.pc), mdx=z, mdy=z, mdz=z)
