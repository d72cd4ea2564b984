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
   lanes the residual lanes before it, the movers' lanes and old and new
   keys in lane order (the first ``m_cap``), and the counts that decide
   the path (:func:`fast_path`, the sort's one host read);
2. :func:`merge_plan` sorts the movers' keys;
3. :func:`assemble` builds the per-key tables (:func:`tables`) and writes
   every lane to its destination, with row 7 and the next ``key0`` (the
   key for live slots, 0 and ``nvk`` for the dead tail).

The fast path needs a snapshot (``key0[0] >= 0``), at most ``m_cap``
movers (the JAX package's provisioning, :func:`mover_capacity`) and
consistent tables.  The JAX package tests ``cum_tot[nvk + 2] == n``; when
every lane's key and ``key0`` lie in ``[0, nvk]``, the movers' counts
below ``nvk + 2`` are all of them, so ``cum_tot[nvk + 2] == ctot[nvk +
2]``.  The test here is that equality plus the range, which :func:`mark`
counts: a key out of range, where the JAX package would assemble and flag
an anomaly, takes the full sort.  Otherwise the block is sorted in full.

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
    """The movers sorted by key (``sort_pallas.py:223-240``)."""
    order: torch.Tensor     # (n_m,) int64 the movers' mark slots, sorted
    key_ms: torch.Tensor    # (n_m,) int32 their keys, sorted


class Assembled(NamedTuple):
    """What :func:`assemble` gives."""
    pk: torch.Tensor        # (8, n) sorted rows
    key0: torch.Tensor      # (n,) int32 the next key0
    cum_res: torch.Tensor   # (nvk+3,) int32 # residual lanes with key < v
    cum_mov: torch.Tensor   # (nvk+3,) int32 # movers with key < v
    cum_tot: torch.Tensor   # (nvk+3,) int32 the next ctot
    anomaly: torch.Tensor   # 0-d int32


class MergeResult(NamedTuple):
    pk: torch.Tensor        # (8, n) sorted rows
    key0: torch.Tensor      # (n,) int32 carry for the next sort
    ctot: torch.Tensor      # (nvk+3,) int32 carry for the next sort
    anomaly: torch.Tensor   # 0-d int32, 0 in any valid run
    fast: bool              # the merge ran (else the full sort)


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
    keys in lane order (the slots past them are unspecified); the counts
    of :class:`Marks`."""
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
    lanes = torch.nonzero(movers).view(-1)[:m_cap]
    n_m = torch.sum(movers, dtype=torch.int32)

    def slots(vals):
        out = torch.zeros((m_cap,), dtype=torch.int32, device=dev)
        out[:lanes.shape[0]] = vals
        return out

    out_of_range = torch.sum((key < 0) | (key > nvk) | (key0 < 0)
                             | (key0 > nvk), dtype=torch.int32)
    info = torch.stack([n_m, out_of_range, (key0[0] >= 0).to(torch.int32),
                        (ctot[nvk + 2] == n).to(torch.int32)])
    return Marks(res_base=res_base, res_key=res_key,
                 mov_lane=slots(lanes.to(torch.int32)),
                 mov_key=slots(key[lanes]), mov_old=slots(key0[lanes]),
                 info=info)


def fast_path(info, m_cap: int):
    """(fast, n_m) from :attr:`Marks.info`: the sort's one host read."""
    n_m, out_of_range, snapshot, ctot_ok = info.tolist()
    return (bool(snapshot and ctot_ok and not out_of_range
                 and n_m <= m_cap), n_m)


def tables(key_ms, mov_old, ctot):
    """(cum_res, cum_mov, cum_tot) (``sort_pallas.py:242-251``) from the
    counts of the movers' new keys (``key_ms``, sorted) and old keys
    (``mov_old``, sorted, as key0 is) below each key."""
    v = torch.arange(ctot.shape[0], dtype=torch.int32, device=ctot.device)
    cum_mov = torch.searchsorted(key_ms, v, out_int32=True)
    cum_res = ctot - torch.searchsorted(mov_old, v, out_int32=True)
    return cum_res, cum_mov, cum_res + cum_mov


def merge_plan(marks: Marks, n_m: int) -> MergePlan:
    """The movers' stable sort by key: one ``torch.sort`` (the JAX package
    sorts its movers with ``lax.sort`` outside its kernel too)."""
    key_ms, order = torch.sort(marks.mov_key[:n_m], stable=True)
    return MergePlan(order=order, key_ms=key_ms)


class Destinations(NamedTuple):
    """Where :func:`assemble` writes each residual lane, then each sorted
    mover: n + n_m entries."""
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
    the mover entries (lanes that moved) of the residual half are n."""
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

    n_m = plan.key_ms.shape[0]
    km_ok = (plan.key_ms >= 0) & (plan.key_ms <= nvk)
    d_mov = (torch.arange(n_m, dtype=torch.int32, device=dev)
             + cum_res[torch.where(km_ok, plan.key_ms + 1, 0).long()])
    ok_m = km_ok & (d_mov >= 0) & (d_mov < n)
    bad = (torch.sum(res & ~ok_r, dtype=torch.int32)
           + torch.sum(~ok_m, dtype=torch.int32))
    return Destinations(
        dest=torch.cat([torch.where(ok_r, d_res, n),
                        torch.where(ok_m, d_mov, n)]).long(),
        src=torch.cat([torch.arange(n, device=dev),
                       marks.mov_lane[plan.order].long()]),
        key=torch.cat([key, plan.key_ms]), bad=bad)


def assemble(pk, np_, key0, ctot, marks: Marks, plan: MergePlan,
             nvk: int) -> Assembled:
    """The tables, then the merged ``(8, n)`` block, the next ``key0``
    (the key for live slots, ``nvk`` past ``np``; row 7 likewise, 0 past
    ``np``) and the anomaly count (``sort_pallas.py:155-167``): the lanes
    not written, plus 1 if any was (the lanes written are then not n).
    Slots no lane reaches are unspecified; the kernel leaves them
    unwritten, and it also counts a lane whose destination falls outside
    its tile's output range (no lane does where the tables are
    consistent)."""
    n = pk.shape[1]
    cum_res, cum_mov, cum_tot = tables(plan.key_ms,
                                       marks.mov_old[:plan.key_ms.shape[0]],
                                       ctot)
    d = destinations(pk, np_, key0, marks, plan, cum_res, cum_mov, nvk)
    live = d.dest < np_
    out = torch.zeros((8, n + 1), dtype=torch.float32, device=pk.device)
    out[:7].index_copy_(1, d.dest, pk[:7, d.src])
    out[7].index_copy_(0, d.dest,
                       torch.where(live, d.key, 0).to(torch.float32))
    key_new = torch.full((n + 1,), nvk, dtype=torch.int32, device=pk.device)
    key_new.index_copy_(0, d.dest, torch.where(live, d.key, nvk))
    return Assembled(pk=out[:, :n].contiguous(),
                     key0=key_new[:n].contiguous(), cum_res=cum_res,
                     cum_mov=cum_mov, cum_tot=cum_tot,
                     anomaly=d.bad + (d.bad > 0).to(torch.int32))


def full_sort(pk, np_, nvk: int):
    """The fallback (``sort_pallas.py:337-358``): a stable sort of the
    whole block by key; row 7 of the dead tail becomes 0.  Returns the
    block, its ``key0`` and its ``ctot``."""
    key = lane_keys(pk, np_, nvk)
    key_s, order = torch.sort(key, stable=True)
    out = pk[:, order]
    in_range = _in_range(pk.shape[1], np_, pk.device)
    out[7] = torch.where(in_range & (key_s < nvk), key_s, 0).to(torch.float32)
    key_new = torch.where(in_range, (out[7] + 0.5).to(torch.int32), nvk)
    v = torch.arange(nvk + 3, dtype=torch.int32, device=pk.device)
    return out, key_new, torch.searchsorted(key_new, v, out_int32=True)


def merge_sort_packed(pk, np_, key0, ctot, nvk: int, m_cap: int,
                      mark_fn=mark, assemble_fn=assemble):
    """Re-sort a packed block by its voxel row.

    ``pk`` (8, n) float32 rows ``[dx dy dz ux uy uz q vox]`` (dead tail
    rows zero), ``np_`` the live count (0-d int32), ``key0`` (n,) int32
    and ``ctot`` (nvk+3,) int32 the carry of the previous sort.  Returns
    a :class:`MergeResult`.  One host read per sort (:func:`fast_path`),
    after the mark pass: a sort that falls back pays for that pass only."""
    marks = mark_fn(pk, np_, key0, ctot, nvk, m_cap)
    fast, n_m = fast_path(marks.info, m_cap)
    if fast:
        a = assemble_fn(pk, np_, key0, ctot, marks, merge_plan(marks, n_m),
                        nvk)
        return MergeResult(a.pk, a.key0, a.cum_tot, a.anomaly, True)
    out, key_new, ctot_new = full_sort(pk, np_, nvk)
    return MergeResult(out, key_new, ctot_new,
                       torch.zeros((), dtype=torch.int32, device=pk.device),
                       False)
