"""Current deposit of per-lane contributions at voxels, plain PyTorch
(the contract of ``vpic_tpu/particles/deposit_pallas.py``).

- :func:`deposit_sorted_into` adds 12 contribution columns of the valid
  lanes into the ``(nv, 12)`` accumulator at their voxels.
- :func:`deposit_dense_sorted` is the same into a zero accumulator from an
  ``(n, 12)`` contribution array.
- :func:`fixed_scale`, :func:`deposit_fixed` and :func:`unfix` are the
  int64 fixed-point deposit of the push kernel (``csrc/push_walk.cu``):
  each contribution rounded to an integer at scale 2^S, the integers
  summed, the sum converted back once.  They are the kernel's plain twin,
  equal to it bit for bit on the card whatever the lane order; the tests
  and ``chip_smoke.py`` use them, the step does not.

This is the plain version of the hand-written CUDA kernel
(``deposit_cuda.py``, ``csrc/deposit_sorted.cu``).  The JAX package's
``(12, nv_pad)`` transposed accumulator, its 512-voxel block windows and
its ``max_overflow`` cap exist for the TPU's VMEM: here no lane is ever
dropped and lanes may come in any order (voxel-sorted order is only the
kernel's fast case).  The second result, the JAX package's count of
dropped lanes, is always 0 here.
"""

from __future__ import annotations

import torch


def deposit_sorted_into(acc, vox, contrib_cols, valid, nv: int):
    """Returns ``(acc + sum of the valid lanes' contributions at vox, 0)``;
    ``contrib_cols`` is a tuple of 12 ``(n,)`` columns."""
    cols = torch.stack([torch.where(valid, c, 0.0) for c in contrib_cols],
                       dim=-1)
    idx = torch.where(valid, vox, 0).long()
    dropped = torch.zeros((), dtype=torch.int32, device=acc.device)
    return acc.index_add(0, idx, cols), dropped


def deposit_dense_sorted(vox, contrib, nv: int):
    """The deposit of ``contrib`` (n, 12) at ``vox`` into zeros (nv, 12)."""
    acc = torch.zeros((nv, 12), dtype=torch.float32, device=contrib.device)
    valid = torch.ones(vox.shape, dtype=torch.bool, device=vox.device)
    acc, _ = deposit_sorted_into(acc, vox, contrib.unbind(1), valid, nv)
    return acc


def fixed_scale(q, seg_cap: int, n: int):
    """2^S as a float64 scalar on ``q``'s device, S = floor(62 -
    log2(5 * max|q| * seg_cap * n)) clamped to [-200, 200]: every
    contribution is below 5 max|q| in magnitude, so every voxel's
    fixed-point sum over n lanes and seg_cap segments stays within
    2^62 (strictly below unless that bound is a power of two) and fits an
    int64.  The plain version of ``push_walk.cu``'s ``fixed_scale_kernel``,
    which repeats these double operations."""
    bound = 5.0 * q.abs().max().to(torch.float64) * float(seg_cap * n)
    s = torch.floor(62.0 - torch.log2(bound)).clamp(-200.0, 200.0)
    return torch.exp2(s)


def deposit_fixed(scale):
    """A deposit function of :func:`deposit_sorted_into`'s signature that
    adds the valid lanes' contributions, each rounded half to even to an
    integer at ``scale`` (as ``__double2ll_rn``), into an int64 ``(nv, 12)``
    accumulator.  Integer sums do not depend on order."""
    def fn(fix, vox, contrib_cols, valid, nv: int):
        words = torch.stack([torch.round(c.to(torch.float64) * scale)
                             .to(torch.int64) for c in contrib_cols], dim=-1)
        words = torch.where(valid[:, None], words, 0)
        idx = torch.where(valid, vox, 0).long()
        dropped = torch.zeros((), dtype=torch.int32, device=fix.device)
        return fix.index_add(0, idx, words), dropped
    return fn


def unfix(acc, fix, scale):
    """acc + fix / scale in float32, as ``push_walk.cu``'s ``acc_unfix``."""
    return acc + (fix.to(torch.float64) / scale).to(torch.float32)
