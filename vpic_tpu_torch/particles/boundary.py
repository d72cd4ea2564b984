"""Boundary rounds: absorption, custom handlers and the continuation of
unfinished streak walks (``vpic_tpu/particles/boundary.py``; the
reference's guard-list drain, boundary_p.c:77-505).

Each species carries per-lane boundary codes (``pc``).  A round compacts
every pending lane (``pc != 0``) into one buffer of fixed capacity
``max_inj`` (the particle_injector_t analogue, species_advance.h:48-55),
deposits absorbed lanes into rhob, runs the custom handlers, walks the
lanes left ``PC_EXHAUSTED`` (the push kernel's ``walk_only`` entry on the
card, ``push.streak_walk`` on the CPU) and scatters the buffer back.
Dead lanes are tombstoned with ``i = -1`` and reclaimed by the next
``aux.sort_p``.  Nothing reads the host: a round costs the same whether
or not anything is pending, as in the JAX package.

Migration between devices (the JAX package's steps 2 and 5) belongs to
the multi-device configuration, which the port does not have.
"""

from __future__ import annotations

import torch

from ..core.types import FieldState, Grid, NEIGHBOR_ABSORB, SpeciesState
from . import push_cuda
from .aux import accumulate_rhob
from .push import PC_EXHAUSTED, WalkState, compact_indices

# the buffer's columns, and the species column each comes from; no
# handler reads the tags and a round leaves them as they are
_COLUMNS = dict(dx="dx", dy="dy", dz="dz", vox="i", ux="ux", uy="uy",
                uz="uz", q="q", mdx="mdx", mdy="mdy", mdz="mdz", pc="pc")
# the species columns that the rounds, the emitters and the injector write
WRITTEN = tuple(_COLUMNS.values())


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


def pending_buffer(sp: SpeciesState, max_inj: int):
    """Compact every pending lane (alive, ``pc != 0``) of ``sp`` into one
    buffer of ``min(max_inj, max_np)`` lanes.  Returns (sel, valid, b):
    the species slot of each buffer lane, which lanes hold one, and the
    buffer's columns (``_COLUMNS``; empty lanes carry q = 0, pc = 0)."""
    sel, _, valid = compact_indices(sp.alive & (sp.pc != 0),
                                    min(max_inj, sp.max_np), sp.max_np)
    safe = torch.where(valid, sel, 0)
    b = {k: getattr(sp, c)[safe] for k, c in _COLUMNS.items()}
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
    f = accumulate_rhob(f, g, b["vox"], b["q"], b["dx"], b["dy"], b["dz"],
                        absorbed)
    live = valid & ~absorbed
    if handlers:
        from ..boundary.models import decode_handler
        from ..core import random as rnd
        hid, hface = decode_handler(b["pc"])
        bstate = list(bstate)
        for hi, handler in enumerate(handlers):
            hmask = live & (b["pc"] <= -9) & (hid == hi)
            b, f, bstate[hi], killed = handler.apply(
                rnd.fold(key, hi), b, hmask, hface, f, g, sid, bstate[hi],
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


def process_boundary(sp: SpeciesState, f: FieldState, acc, neighbor,
                     g: Grid, pcomm, max_inj: int, n_walk: int = 4,
                     handlers=(), bstate=(), key=None, step=None):
    """One boundary round for one species: compact, absorb, handle, walk
    (``push_cuda.streak_walk``: the kernel's walk_only entry on the card),
    scatter back.  Returns (sp, f, acc, bstate).  The buffer is scattered
    into ``sp``'s own columns in place: the caller owns them (see
    :func:`owned`); the JAX package's version copies each column."""
    if pcomm is not None:
        raise NotImplementedError("migration between devices is not "
                                  "ported")
    sel, valid, b = pending_buffer(sp, max_inj)
    b, live, f, bstate = resolve_buffer(b, valid, f, g, sp.sid, handlers,
                                        bstate, key, step)
    st, walkable = buffer_walk_state(b, live)
    st, acc = push_cuda.streak_walk(st, acc, neighbor, g, n_walk)

    mix = lambda walked, kept: torch.where(walkable, walked, kept)
    pc = torch.where(walkable, st.pcode, torch.where(live, b["pc"], 0))
    pend = pc != 0
    res = dict(
        dx=mix(st.x, b["dx"]), dy=mix(st.y, b["dy"]), dz=mix(st.z, b["dz"]),
        # dead buffer lanes (absorbed or killed) are tombstoned
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
