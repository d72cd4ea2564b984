"""The tile and cluster plan of the two tensor-core probes of
``csrc/probes.cu`` (gather3d and deposit2d): the grid, the cluster, each
block's shared-memory layout, the bulk copies that fill it and the share
of the split-K sum that each block of a cluster finishes.

Both probes are one product C = A B with B read from ``oh`` (R, W, L):

  gather3d   C (M, R*L) = win (M, W) . B,   B[w, r*L + l] = oh[r,w,l]
  deposit2d  C (M, W)   = c (M, R*L) . B,   B[r*L + l, w] = oh[r,w,l]

A block computes every row of C (M <= 32, one or two 16-row tiles) for
``bn`` columns over one split of the depth, and keeps that float32
partial in its own shared memory.  The splits of one column tile form a
cluster (grid z, at most 8 blocks); after the cluster barrier block q sums
its share of the tile over the partials of blocks 0, 1, ... in that
order, read through distributed shared memory, and writes C.

  gather3d   block (l tile, r, w split): bn = 64 columns of one r; the
             depth W in ``splits`` runs of ``depth`` (a multiple of 16);
             A slab: M runs of the split's w, B slab: one run of the
             tile's l per w.
  deposit2d  block (w tile, 0, r): bn = 32 columns; depth = L, one r per
             split; A slab: M runs of L, B slab: oh[r, w0:w0+32, :], one
             contiguous run.

The kernels take the integers of :meth:`MmaPlan.args` (their launcher
refuses a plan whose ``bn``, cluster, tiles, share or shared memory
differ from what the kernel was built for) and compute each block's
copies and cleared runs from ``blockIdx`` in the same way as
:meth:`MmaPlan.blocks`, which lists what each block copies, clears,
covers and writes.  The CPU tests check this model of the kernels; the
card's tests check the kernels against their plain versions.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np

SMEM_LIMIT = 232_448          # shared memory a block may use on the H100
MAX_CLUSTER = 8               # the portable cluster size
MAX_ROWS = 32                 # rows of C: two 16-row tiles
BN = {"gather3d": 64, "deposit2d": 32}
BAR_BYTES = 16                # the mbarrier, padded to the copies' alignment
PAD = 4                       # floats added to a slab row against bank conflicts


class Block(NamedTuple):
    index: tuple          # blockIdx (x, y, z); z is the split and the rank
    rows: range           # rows of C
    cols: np.ndarray      # the tile's columns of C, -1 past the edge
    depth: np.ndarray     # the split's depth indices of the product
    copies: list          # (operand "a" or "oh", first float, floats, smem byte)
    zeros: list           # (smem byte, bytes) cleared by the block's threads
    share: range          # the tile elements whose sum this block writes


@dataclass(frozen=True)
class MmaPlan:
    kind: str             # "gather3d" or "deposit2d"
    m: int                # rows of C: gather3d's A, deposit2d's K
    r: int
    w: int
    lane: int
    grid: tuple           # (x, y, z); z = splits = the cluster
    mt: int               # 16-row tiles of C
    depth: int            # depth of one split
    lda: int              # row stride of the A slab, floats
    ldb: int              # row stride of the B slab, floats
    a_off: int            # byte offsets of the A slab, B slab and partial
    b_off: int
    p_off: int
    smem: int             # dynamic shared memory of a block, bytes

    @property
    def bn(self) -> int:
        return BN[self.kind]

    @property
    def splits(self) -> int:
        return self.grid[2]

    @property
    def blocks_total(self) -> int:
        return self.grid[0] * self.grid[1] * self.grid[2]

    @property
    def tile(self) -> int:
        """Elements of a block's partial."""
        return self.mt * 16 * self.bn

    @property
    def chunk(self) -> int:
        """Elements of the tile whose sum one block of a cluster writes."""
        return -(-self.tile // self.splits)

    def args(self) -> tuple:
        """The integers the C launcher takes after the shape."""
        return (*self.grid, self.bn, self.mt, self.depth, self.lda, self.ldb,
                self.a_off, self.b_off, self.p_off, self.chunk, self.smem)

    def share(self, rank: int) -> range:
        return range(min(self.tile, rank * self.chunk),
                     min(self.tile, (rank + 1) * self.chunk))

    def blocks(self):
        """Every block of the grid, as the kernel handles it."""
        for z in range(self.grid[2]):
            for y in range(self.grid[1]):
                for x in range(self.grid[0]):
                    yield (self._gather_block(x, y, z)
                           if self.kind == "gather3d"
                           else self._deposit_block(x, z))

    def _rows_past_m(self):
        """The A slab's rows past M, over the depth the products read."""
        return [(self.a_off + a * self.lda * 4, self.depth * 4)
                for a in range(self.m, self.mt * 16)]

    def _gather_block(self, x, y, z):
        m, w, lane, bn, depth = self.m, self.w, self.lane, self.bn, self.depth
        l0, r, w0 = x * bn, y, z * depth
        nl, dw = min(bn, lane - l0), min(depth, w - w0)
        copies = [("a", a * w + w0, dw, self.a_off + a * self.lda * 4)
                  for a in range(m)]
        copies += [("oh", (r * w + w0 + k) * lane + l0, nl,
                    self.b_off + k * self.ldb * 4) for k in range(dw)]
        zeros = []
        if dw < depth:
            zeros += [(self.a_off + (a * self.lda + dw) * 4, (depth - dw) * 4)
                      for a in range(m)]
        zeros += self._rows_past_m()
        if nl < bn:
            zeros += [(self.b_off + (k * self.ldb + nl) * 4, (bn - nl) * 4)
                      for k in range(dw)]
        zeros += [(self.b_off + k * self.ldb * 4, bn * 4)
                  for k in range(dw, depth)]
        cols = np.full(bn, -1)
        cols[:nl] = r * lane + l0 + np.arange(nl)
        return Block((x, y, z), range(m), cols, np.arange(w0, w0 + dw),
                     copies, zeros, self.share(z))

    def _deposit_block(self, x, z):
        m, w, lane, bn = self.m, self.w, self.lane, self.bn
        w0, r = x * bn, z
        nw = min(bn, w - w0)
        copies = [("oh", (r * w + w0) * lane, nw * lane, self.b_off)]
        copies += [("a", (a * self.r + r) * lane, lane,
                    self.a_off + a * self.lda * 4) for a in range(m)]
        zeros = self._rows_past_m()
        if nw < bn:
            zeros.append((self.b_off + nw * lane * 4, (bn - nw) * lane * 4))
        cols = np.full(bn, -1)
        cols[:nw] = w0 + np.arange(nw)
        return Block((x, 0, z), range(m), cols,
                     r * lane + np.arange(lane), copies, zeros,
                     self.share(z))


def _layout(kind, m, r, w, lane, grid, depth, lda, ldb, b_rows):
    mt = -(-m // 16)
    a_off = BAR_BYTES
    b_off = a_off + mt * 16 * lda * 4
    p_off = b_off + b_rows * ldb * 4
    smem = p_off + mt * 16 * BN[kind] * 4
    if smem > SMEM_LIMIT:
        raise ValueError(f"{kind}: shape ({m}, {r}, {w}, {lane}) needs "
                         f"{smem} bytes of shared memory a block, above "
                         f"{SMEM_LIMIT}")
    return MmaPlan(kind, m, r, w, lane, grid, mt, depth, lda, ldb, a_off,
                   b_off, p_off, smem)


def _check_rows(kind, m):
    if not 1 <= m <= MAX_ROWS:
        raise ValueError(f"{kind} takes 1 to {MAX_ROWS} rows of output, "
                         f"got {m}")


@functools.lru_cache(maxsize=64)
def gather3d_plan(a: int, r: int, w: int, lane: int) -> MmaPlan:
    """The plan of gather3d on win (a, w) and oh (r, w, lane).  It takes
    1 <= a <= 32, w and lane multiples of 4 (each copied row a multiple of
    16 bytes), and a depth split over at most 8 blocks that fits shared
    memory (w up to 4352 at 32 rows); else it raises ValueError."""
    _check_rows("gather3d", a)
    if r < 1 or w < 4 or lane < 4 or w % 4 or lane % 4:
        raise ValueError(f"gather3d takes r >= 1 and w, lane positive "
                         f"multiples of 4, got r {r}, w {w}, lane {lane}")
    per_split = -(-w // min(MAX_CLUSTER, -(-w // 64)))
    depth = -(-per_split // 16) * 16
    splits = -(-w // depth)
    bn = BN["gather3d"]
    return _layout("gather3d", a, r, w, lane, (-(-lane // bn), r, splits),
                   depth, depth + PAD, bn + PAD, depth)


@functools.lru_cache(maxsize=64)
def deposit2d_plan(k: int, r: int, w: int, lane: int) -> MmaPlan:
    """The plan of deposit2d on c (k, r, lane) and oh (r, w, lane).  It
    takes 1 <= k <= 32, 1 <= r <= 8 (one split of the cluster per r), w
    >= 1 and lane a multiple of 16 (one MMA step) whose slabs fit shared
    memory (lane up to 880 at 32 rows); else it raises ValueError."""
    _check_rows("deposit2d", k)
    if not 1 <= r <= MAX_CLUSTER or w < 1 or lane < 16 or lane % 16:
        raise ValueError(f"deposit2d takes 1 <= r <= {MAX_CLUSTER}, w >= 1 "
                         f"and lane a positive multiple of 16, got r {r}, "
                         f"w {w}, lane {lane}")
    bn = BN["deposit2d"]
    return _layout("deposit2d", k, r, w, lane, (-(-w // bn), 1, r), lane,
                   lane + PAD, lane, bn)
