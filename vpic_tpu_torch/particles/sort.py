"""The merge re-sort of a packed species, plain PyTorch
(``vpic_tpu/particles/sort_pallas.py:merge_sort_packed``, provisioned as
``vpic_tpu/particles/aux.py:sort_p_packed_merge``).

Between two sorts only the lanes whose voxel changed (the movers,
``key != key0``) break the order; the rest (the residual) is still
sorted.  The re-sort sorts the movers, builds per-key cumulative tables
from the carried ``ctot`` (``ctot[v]`` = # lanes with ``key0 < v``), and
merges: with ties residual first,

- a residual lane of residual rank r and key v goes to ``r + cum_mov[v]``;
- the mover of sorted rank m and key v goes to ``m + cum_res[v + 1]``.

Those destinations form a permutation of the lanes.  The work is split
into the passes that the CUDA kernels of ``sort_cuda.py`` run, and each
function here is the plain version that a kernel equals bit for bit:

1. :func:`mark` reads row 7 and ``key0`` once: per tile of :data:`TILE`
   lanes the residual lanes before it, the first ``m_cap`` movers' lanes
   and old and new keys in lane order (the slots past the movers hold
   :data:`SENTINEL`), and the counts that decide the path
   (:func:`fast_path`);
2. :func:`merge_plan` sorts the ``m_cap`` slots by key, the sentinels
   last; :func:`full_order` sorts all the lanes by key, for the full sort;
3. :func:`assemble` builds the per-key tables (:func:`tables`) and, where
   the decision is fast, writes every lane to its merge destination, with
   row 7 and the next ``key0`` (the key for live slots, 0 and ``nvk`` for
   the dead tail); where it is slow, :func:`gather` writes the block in
   the full sort's order instead (:func:`full_gather`), into the same
   buffers.

The fast path needs a snapshot (``key0[0] >= 0``), at most ``m_cap``
movers (the JAX package's provisioning, :func:`mover_capacity`) and
consistent tables.  The JAX package tests ``cum_tot[nvk + 2] == n``; when
every lane's key and ``key0`` lie in ``[0, nvk]``, the movers' counts
below ``nvk + 2`` are all of them, so ``cum_tot[nvk + 2] == ctot[nvk +
2]``.  The test here is that equality plus the range, which :func:`mark`
counts: a key out of range, where the JAX package would assemble and flag
an anomaly, takes the full sort.  Otherwise the block is sorted in full.

The decision is a 0-d device tensor, never read by the host: the JAX
package takes it inside ``lax.cond`` (``sort_pallas.py:347, 355``), and
so does the port (``engine/cond.cond``): in a CUDA graph the merge and
the full sort are the bodies of two conditional nodes, and a replay runs
only the one the decision names; eager, and on the CPU, both run and the
decision selects.  Every size is fixed by ``(n, nvk, m_cap)``: the
movers' slots are ``m_cap`` wide whatever their count, as the JAX package
gathers them (``sort_pallas.py:233``).

The JAX package's per-block merge-path partition and its window tests
(``span_ok`` on the block key span W, ``fit_ok`` on the residual window)
exist only to size the TPU kernel's VMEM windows: the assembly here writes
each lane straight to its destination, so neither is ported, and the
sparse, wide-span decks where they made the JAX package fall back take the
fast path here.  The result is the same sorted block.

Dead lanes (``>= np``) carry the dead key ``nvk``, are residual and land
in the tail.  Sorts are stable (the mover sort keeps lane order within a
key), so the result is deterministic.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

# lanes per tile of the mark and assembly passes (csrc/merge_assemble.cu
# kTile: 256 threads x 4 chunks x 4 lanes)
TILE = 4096
# the lane, key and old key of a mover slot past the movers: above every
# key, so such slots sort last and no table counts them
SENTINEL = 2 ** 31 - 1


class Marks(NamedTuple):
    """What :func:`mark` gives, on the block's device."""
    res_base: torch.Tensor  # (tiles,) int32 residual lanes before each tile
    res_key: torch.Tensor   # (tiles,) int32 key of its first residual, or -1
    mov_lane: torch.Tensor  # (m_cap,) int32 movers' lanes, in lane order
    mov_key: torch.Tensor   # (m_cap,) int32 their keys
    mov_old: torch.Tensor   # (m_cap,) int32 their key0 (sorted, as key0 is)
    info: torch.Tensor      # (4,) int32 [n_m, keys out of range,
    #                          key0[0] >= 0, ctot[nvk + 2] == n]


class MergePlan(NamedTuple):
    """The mover slots sorted by key (``sort_pallas.py:223-240``)."""
    order: torch.Tensor     # (m_cap,) int64 the slots, sorted
    key_ms: torch.Tensor    # (m_cap,) int32 their keys, sorted


class FullOrder(NamedTuple):
    """The full sort's stable order of all the lanes by key
    (``sort_pallas.py:337-345``)."""
    order: torch.Tensor     # (n,) int64 the lanes, sorted
    key_s: torch.Tensor     # (n,) int32 their keys, sorted


class Assembled(NamedTuple):
    """What :func:`assemble` gives."""
    pk: torch.Tensor        # (8, n) sorted rows
    key0: torch.Tensor      # (n,) int32 the next key0
    cum_res: torch.Tensor   # (nvk+3,) int32 # residual lanes with key < v
    cum_mov: torch.Tensor   # (nvk+3,) int32 # movers with key < v
    cum_tot: torch.Tensor   # (nvk+3,) int32 the next ctot, where fast
    anomaly: torch.Tensor   # 0-d int32


class MergeResult(NamedTuple):
    pk: torch.Tensor        # (8, n) sorted rows
    key0: torch.Tensor      # (n,) int32 carry for the next sort
    ctot: torch.Tensor      # (nvk+3,) int32 carry for the next sort
    anomaly: torch.Tensor   # 0-d int32, 0 in any valid run
    fast: torch.Tensor      # 0-d bool: the merge was kept (else the full
    #                         sort)


def mover_capacity(n: int, steps_since_sort: int) -> int:
    """The mover buffer of ``aux.py:242-251``: ``n * min(0.5, 0.03 +
    0.02 k)``, at least 16384, at most n, in whole 128-lane rows.  (The
    JAX package's third term ``B + 128`` is at most 640, below the 16384
    floor, so it never decides.)"""
    frac = min(0.5, 0.03 + 0.02 * steps_since_sort)
    m_cap = int(min(n, max(16384, n * frac)))
    return min(n, -(-m_cap // 128) * 128)


def _in_range(n, np_, device):
    return torch.arange(n, dtype=torch.int32, device=device) < np_


def lane_keys(pk, np_, nvk: int):
    """Each lane's key: row 7 rounded for live lanes, ``nvk`` for dead."""
    return torch.where(_in_range(pk.shape[1], np_, pk.device),
                       (pk[7] + 0.5).to(torch.int32), nvk)


def _by_tile(flags):
    """The (n,) flags as int32, padded with 0 to (tiles, TILE)."""
    n = flags.shape[0]
    f = torch.zeros(-(-n // TILE) * TILE, dtype=torch.int32,
                    device=flags.device)
    f[:n] = flags
    return f.view(-1, TILE)


def mark(pk, np_, key0, ctot, nvk: int, m_cap: int) -> Marks:
    """The mark pass: keys and movers from row 7 and ``key0``; per tile
    the residual lanes before it; the first ``m_cap`` movers' lanes and
    keys in lane order, each in the slot of its rank among the movers (a
    prefix sum over the move flags), :data:`SENTINEL` in the slots past
    them; the counts of :class:`Marks`."""
    n = pk.shape[1]
    dev = pk.device
    key = lane_keys(pk, np_, nvk)
    movers = key != key0
    res = _by_tile(~movers)
    res_tile = torch.sum(res, 1, dtype=torch.int32)
    res_base = torch.cumsum(res_tile, 0, dtype=torch.int32) - res_tile
    # the first residual lane of each tile (argmax takes the first maximum)
    first = (torch.argmax(res, 1)
             + torch.arange(res.shape[0], device=dev) * TILE).clamp(max=n - 1)
    res_key = torch.where(res_tile > 0, key[first], -1)
    rank = torch.cumsum(movers, 0, dtype=torch.int32)
    n_m = torch.sum(movers, dtype=torch.int32)
    # a mover's slot is its rank among the movers; slot m_cap takes the
    # lanes that are not written (residual, or past the first m_cap)
    slot = torch.where(movers & (rank <= m_cap), rank - 1, m_cap).long()

    def slots(vals):
        out = torch.full((m_cap + 1,), SENTINEL, dtype=torch.int32,
                         device=dev)
        return out.scatter_(0, slot, vals)[:m_cap]

    lanes = torch.arange(n, dtype=torch.int32, device=dev)
    out_of_range = torch.sum((key < 0) | (key > nvk) | (key0 < 0)
                             | (key0 > nvk), dtype=torch.int32)
    info = torch.stack([n_m, out_of_range, (key0[0] >= 0).to(torch.int32),
                        (ctot[nvk + 2] == n).to(torch.int32)])
    return Marks(res_base=res_base, res_key=res_key,
                 mov_lane=slots(lanes), mov_key=slots(key),
                 mov_old=slots(key0), info=info)


def fast_path(info, m_cap: int):
    """The decision from :attr:`Marks.info`, as a 0-d bool on its device
    (the host reads nothing): a snapshot, consistent tables, every key in
    range and at most ``m_cap`` movers."""
    return ((info[2] != 0) & (info[3] != 0) & (info[1] == 0)
            & (info[0] <= m_cap))


def tables(key_ms, mov_old, ctot):
    """(cum_res, cum_mov, cum_tot) (``sort_pallas.py:242-251``) from the
    counts of the movers' new keys (``key_ms``, sorted) and old keys
    (``mov_old``, sorted, as key0 is) below each key.  Over all the mover
    slots: the sentinels past the movers lie above every key and count
    nowhere."""
    v = torch.arange(ctot.shape[0], dtype=torch.int32, device=ctot.device)
    cum_mov = torch.searchsorted(key_ms, v, out_int32=True)
    cum_res = ctot - torch.searchsorted(mov_old, v, out_int32=True)
    return cum_res, cum_mov, cum_res + cum_mov


def merge_plan(marks: Marks) -> MergePlan:
    """The mover slots' stable sort by key: one ``torch.sort`` of all
    ``m_cap`` slots (the JAX package sorts its ``m_cap`` slots with
    ``lax.sort`` outside its kernel too).  The sentinels sort last and the
    sort is stable, so the first ``n_m`` entries are the movers'."""
    key_ms, order = torch.sort(marks.mov_key, stable=True)
    return MergePlan(order=order, key_ms=key_ms)


def full_order(pk, np_, nvk: int) -> FullOrder:
    """The full sort's order: a stable sort of all the lanes' keys."""
    key_s, order = torch.sort(lane_keys(pk, np_, nvk), stable=True)
    return FullOrder(order=order, key_s=key_s)


class Destinations(NamedTuple):
    """Where :func:`assemble` writes each residual lane, then each sorted
    mover slot: n + m_cap entries."""
    dest: torch.Tensor      # int64 destination, n where not written
    src: torch.Tensor       # int64 source lane
    key: torch.Tensor       # int32 key
    bad: torch.Tensor       # 0-d int32 lanes not written (anomalies)


def destinations(pk, np_, key0, marks: Marks, plan: MergePlan, cum_res,
                 cum_mov, nvk: int) -> Destinations:
    """The residual lane of tile rank r (plus the tile's prefix) and key
    v goes to ``r + cum_mov[v]``; the mover of sorted rank m and key v to
    ``m + cum_res[v + 1]``.  A lane whose key lies outside the tables or
    whose destination lies outside [0, n) is not written and is counted;
    the mover entries (lanes that moved) of the residual half and the
    slots past the movers are n."""
    n = pk.shape[1]
    dev = pk.device
    key = lane_keys(pk, np_, nvk)
    res = key == key0
    k_ok = (key >= 0) & (key <= nvk)
    f = _by_tile(res)
    rank = (torch.cumsum(f, 1, dtype=torch.int32) - f).view(-1)[:n]
    tile = torch.arange(n, device=dev) // TILE
    d_res = (marks.res_base[tile] + rank
             + cum_mov[torch.where(k_ok, key, 0).long()])
    ok_r = res & k_ok & (d_res >= 0) & (d_res < n)

    m_cap = plan.key_ms.shape[0]
    m = torch.arange(m_cap, dtype=torch.int32, device=dev)
    moved = m < marks.info[0]
    km_ok = (plan.key_ms >= 0) & (plan.key_ms <= nvk)
    d_mov = m + cum_res[torch.where(km_ok, plan.key_ms + 1, 0).long()]
    ok_m = km_ok & (d_mov >= 0) & (d_mov < n)
    bad = (torch.sum(res & ~ok_r, dtype=torch.int32)
           + torch.sum(moved & ~ok_m, dtype=torch.int32))
    ok_m = moved & ok_m
    lane = torch.where(moved, marks.mov_lane[plan.order], 0)
    return Destinations(
        dest=torch.cat([torch.where(ok_r, d_res, n),
                        torch.where(ok_m, d_mov, n)]).long(),
        src=torch.cat([torch.arange(n, device=dev), lane.long()]),
        key=torch.cat([key, plan.key_ms]), bad=bad)


def full_gather(pk, np_, full: FullOrder, nvk: int):
    """The full sort's block (``sort_pallas.py:337-358``): the rows in
    ``full``'s order, row 7 the sorted key for live lanes below ``nvk``
    and 0 elsewhere; and its ``key0``."""
    out = pk[:, full.order]
    in_range = _in_range(pk.shape[1], np_, pk.device)
    out[7] = torch.where(in_range & (full.key_s < nvk), full.key_s,
                         0).to(torch.float32)
    return out, torch.where(in_range, (out[7] + 0.5).to(torch.int32), nvk)


def block_buffers(pk, key0):
    """The re-sort's one output buffer set: ``(8, n)`` rows and ``(n,)``
    key0, which the merge (:func:`assemble`) and the full sort's gather
    (:func:`gather`) each write only where the decision is theirs."""
    return torch.empty_like(pk), torch.empty_like(key0)


def assemble(pk, np_, key0, ctot, marks: Marks, plan: MergePlan,
             nvk: int, m_cap: int, out=None) -> Assembled:
    """The tables, then, where :func:`fast_path` holds, the merge written
    into ``out`` (:func:`block_buffers`, made where None): every lane to
    its destination; row 7 the key for live slots, 0 past ``np``; ``key0``
    the key, ``nvk`` past ``np``; and the anomaly count
    (``sort_pallas.py:155-167``: the lanes not written, plus 1 if any was;
    the lanes written are then not n), 0 where the decision is slow.
    ``out`` keeps what it held where the decision is slow; slots no lane
    reaches are unspecified (the kernel leaves them unwritten, and it also
    counts a lane whose destination falls outside its tile's output range;
    no lane does where the tables are consistent)."""
    n = pk.shape[1]
    cum_res, cum_mov, cum_tot = tables(plan.key_ms, marks.mov_old, ctot)
    d = destinations(pk, np_, key0, marks, plan, cum_res, cum_mov, nvk)
    live = d.dest < np_
    merged = torch.zeros((8, n + 1), dtype=torch.float32, device=pk.device)
    merged[:7].index_copy_(1, d.dest, pk[:7, d.src])
    merged[7].index_copy_(0, d.dest,
                          torch.where(live, d.key, 0).to(torch.float32))
    key_new = torch.full((n + 1,), nvk, dtype=torch.int32, device=pk.device)
    key_new.index_copy_(0, d.dest, torch.where(live, d.key, nvk))
    fast = fast_path(marks.info, m_cap)
    out_pk, out_key0 = block_buffers(pk, key0) if out is None else out
    out_pk.copy_(torch.where(fast, merged[:, :n], out_pk))
    out_key0.copy_(torch.where(fast, key_new[:n], out_key0))
    anomaly = d.bad + (d.bad > 0).to(torch.int32)
    return Assembled(pk=out_pk, key0=out_key0, cum_res=cum_res,
                     cum_mov=cum_mov, cum_tot=cum_tot,
                     anomaly=torch.where(fast, anomaly, 0))


def gather(pk, np_, full: FullOrder, nvk: int, info, m_cap: int, out=None):
    """The full sort's branch: where :func:`fast_path` fails,
    :func:`full_gather`'s block written into ``out``
    (:func:`block_buffers`, made where None), which keeps what it held
    where the decision is fast.  Returns (rows, key0, anomaly 0)."""
    rows, k0 = full_gather(pk, np_, full, nvk)
    slow = ~fast_path(info, m_cap)
    out_pk, out_key0 = block_buffers(pk, k0) if out is None else out
    out_pk.copy_(torch.where(slow, rows, out_pk))
    out_key0.copy_(torch.where(slow, k0, out_key0))
    return (out_pk, out_key0,
            torch.zeros((), dtype=torch.int32, device=pk.device))


def merge_sort_packed(pk, np_, key0, ctot, nvk: int, m_cap: int,
                      mark_fn=mark, assemble_fn=assemble, gather_fn=gather):
    """Re-sort a packed block by its voxel row.

    ``pk`` (8, n) float32 rows ``[dx dy dz ux uy uz q vox]`` (dead tail
    rows zero), ``np_`` the live count (0-d int32), ``key0`` (n,) int32
    and ``ctot`` (nvk+3,) int32 the carry of the previous sort.  Returns
    a :class:`MergeResult`.  No host read: the mark pass runs, and the
    decision (:func:`fast_path`) picks on the device, through
    ``engine/cond.cond`` (the JAX package's ``lax.cond``,
    ``sort_pallas.py:347, 355``), between the merge (the movers' sort,
    the tables and the assembly; ``ctot`` the tables' ``cum_tot``) and
    the full sort (its order and :func:`gather`; ``ctot`` the counts of
    the new ``key0``, ``sort_pallas.py:353-357``).  Both write the block
    into one buffer set, each only where the decision is its own, so
    nothing is copied between them.  In a CUDA graph each is a
    conditional node's body, and a replay runs the one the decision
    names."""
    from ..engine.cond import cond

    marks = mark_fn(pk, np_, key0, ctot, nvk, m_cap)
    fast = fast_path(marks.info, m_cap)
    out = block_buffers(pk, key0)

    def merge():
        a = assemble_fn(pk, np_, key0, ctot, marks, merge_plan(marks), nvk,
                        m_cap, out)
        return a.pk, a.key0, a.cum_tot, a.anomaly

    def full():
        rows, k0, anomaly = gather_fn(pk, np_, full_order(pk, np_, nvk), nvk,
                                      marks.info, m_cap, out)
        v = torch.arange(nvk + 3, dtype=torch.int32, device=pk.device)
        return rows, k0, torch.searchsorted(k0, v, out_int32=True), anomaly

    return MergeResult(*cond(fast, merge, full), fast)
