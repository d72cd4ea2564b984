"""The five probes of ``tools/probe_batched.py`` on the card: each a
hand-written kernel of ``csrc/probes.cu``, with its plain PyTorch version
and the tool's exact inputs.

    python -m vpic_tpu_torch.tools.probe_batched [probe ...] [--device cpu]

Probes (W = 512, R = 8, LANE = 128; every operand float32 unless said):
  gather3d   out[a,r,l] = sum_w bf16(win[a,w]) bf16(oh[r,w,l]):
             (32, W) x (R, W, LANE) -> (32, R, LANE), on the tensor cores
  deposit2d  out[k,w] = sum_{r,l} bf16(c[k,r,l]) bf16(oh[r,w,l]):
             (12, R, LANE) x (R, W, LANE) -> (12, W), on the tensor cores
  stack8     out[a,s,l] = bf16(win[a, loc[s,l]]), 0 where loc is outside
             [0, W): (32, W), int32 (R, LANE) -> (32, R, LANE), a gather
  onehot3d   out[r,w,l] = float(loc[r,l] == w): int32 (R, LANE) ->
             (R, W, LANE)
  io4d       per block i: a = 2 ps[i,0] + ps[i,1]; out[i,0] = a > 0 ? a :
             ps[i,2]; out[i,1:8] = ps[i,0:7]; out[i,8:16] = 0:
             (4, 7, R, LANE) -> (4, 16, R, LANE)

``oh`` is the tool's one-hot ``oh[r,w,l] = (w == l + r)``.  Each wrapper
runs the plain version for CPU tensors and launches its kernel for CUDA
tensors (a failed launch raises; there is no other fallback).  Each
wrapper computes its kernel's launch plan on every device: gather3d and
deposit2d refuse the shapes their plan (``mma_plan.py``) does not take;
stack8, onehot3d and io4d take any shape, on 16-byte or 4-byte accesses
by the alignment of their operands (``stack8_plan``, ``onehot3d_plan``,
``io4d_plan``), and stack8 and onehot3d refuse 2^31 elements or more.
``launches`` counts the kernels' launches.  On the card each probe prints
the tool's line and its kernel's time through the wrapper (CUDA events)
beside its bound; a failed probe raises and the command exits non-zero.
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import NamedTuple

import numpy as np
import torch

from ..particles.push_cuda import check_tensor, cuda_device
from .mma_plan import deposit2d_plan, gather3d_plan
from .probes_cuda import (BF16_TENSOR_OPS_PER_S, bound, card_line, cuda_ms,
                          launch, resolve_device)

W = 512
R = 8
LANE = 128

# the launch constants of csrc/probes.cu: io4d_kernel's threads per block
# (kIoBlock); stack8_kernel's threads per block, outputs per block, row
# offset and shared memory limit (kStackThreads, kStackPerBlock,
# kStackRowOff, kStackSmemMax); onehot3d_kernel's threads per block and
# rows per thread (kOnehotBlock, kOnehotRows)
IO4D_BLOCK = 128
STACK8_THREADS, STACK8_PER_BLOCK = 64, 256
STACK8_ROW_OFF, STACK8_SMEM_MAX = 16, 48 * 1024
ONEHOT3D_BLOCK, ONEHOT3D_ROWS = 256, 4

launches = {"gather3d": 0, "deposit2d": 0, "stack8": 0, "onehot3d": 0,
            "io4d": 0}

F32, I32 = torch.float32, torch.int32


def _bf16(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to bf16 (to nearest even) and back to float32."""
    return t.to(torch.bfloat16).to(F32)


def _dims(name, t, ndim):
    if t.dim() != ndim:
        raise ValueError(f"{name} has {t.dim()} dimensions, expected {ndim}")
    return tuple(t.shape)


# -- plain versions -----------------------------------------------------------

def gather3d_plain(win, oh):
    a, w = win.shape
    r, _, lane = oh.shape
    b = _bf16(oh).permute(1, 0, 2).reshape(w, r * lane)
    return (_bf16(win) @ b).reshape(a, r, lane)


def deposit2d_plain(c, oh):
    k, r, lane = c.shape
    w = oh.shape[1]
    b = _bf16(oh).permute(0, 2, 1).reshape(r * lane, w)
    return _bf16(c).reshape(k, r * lane) @ b


def stack8_plain(win, loc):
    w = win.shape[1]
    valid = (loc >= 0) & (loc < w)
    return torch.where(valid, _bf16(win)[:, loc.clamp(0, w - 1).long()],
                       0.0)


def onehot3d_plain(loc, w=W):
    iota = torch.arange(w, dtype=loc.dtype, device=loc.device)
    return (loc[:, None, :] == iota[None, :, None]).to(F32)


def io4d_plain(ps):
    b, _, r, lane = ps.shape
    a = ps[:, 0] * 2.0 + ps[:, 1]
    head = torch.where(a > 0, a, ps[:, 2])
    zeros = torch.zeros((b, 8, r, lane), dtype=F32, device=ps.device)
    return torch.cat([head[:, None], ps, zeros], dim=1)


# -- wrappers -----------------------------------------------------------------

def _check_aligned(*named):
    """The bulk copies start at 16-byte boundaries of each operand."""
    for name, t in named:
        if t.data_ptr() % 16:
            raise ValueError(f"{name} does not start on a 16-byte boundary")


def gather3d(win, oh):
    """Takes the shapes of ``mma_plan.gather3d_plan``: win (a, w), oh (r,
    w, lane) with 1 <= a <= 32, w and lane multiples of 4 and w up to
    4352 at 32 rows; any other shape raises ValueError, on every
    device."""
    a, w = _dims("win", win, 2)
    r, _, lane = _dims("oh", oh, 3)
    plan = gather3d_plan(a, r, w, lane)
    if win.device.type == "cpu":
        return gather3d_plain(win, oh)
    device = cuda_device(win)
    check_tensor("win", win, F32, (a, w), device)
    check_tensor("oh", oh, F32, (r, w, lane), device)
    _check_aligned(("win", win), ("oh", oh))
    out = torch.empty((a, r, lane), dtype=F32, device=device)
    launch("vpic_probe_gather3d", launches, "gather3d", device,
           win, oh, out, a, r, w, lane, *plan.args())
    return out


def deposit2d(c, oh):
    """Takes the shapes of ``mma_plan.deposit2d_plan``: c (k, r, lane), oh
    (r, w, lane) with 1 <= k <= 32, 1 <= r <= 8 and lane a multiple of 16
    (up to 880 at 32 rows); any other shape raises ValueError, on every
    device."""
    k, r, lane = _dims("c", c, 3)
    w = _dims("oh", oh, 3)[1]
    plan = deposit2d_plan(k, r, w, lane)
    if c.device.type == "cpu":
        return deposit2d_plain(c, oh)
    device = cuda_device(c)
    check_tensor("c", c, F32, (k, r, lane), device)
    check_tensor("oh", oh, F32, (r, w, lane), device)
    _check_aligned(("c", c), ("oh", oh))
    out = torch.empty((k, w), dtype=F32, device=device)
    launch("vpic_probe_deposit2d", launches, "deposit2d", device,
           c, oh, out, k, r, w, lane, *plan.args())
    return out


class Stack8Plan(NamedTuple):
    """The launch of ``stack8_kernel`` on win (a, w), loc (s, lane) -> out
    (a, s, lane): block b takes ``STACK8_PER_BLOCK`` consecutive outputs
    of row b // chunks of out (flattened over (s, lane)), chunk b %
    chunks, in ``blocks`` = a * chunks blocks of ``STACK8_THREADS``; each
    thread four of them, as one 16-byte access (``width`` 4) or four
    single floats ``STACK8_THREADS`` apart (1).  ``stage`` 1: the block
    copies its row of win into ``smem`` bytes of shared memory (after a
    16-byte slot for the mbarrier) and gathers from there; 0: the threads
    read win directly."""
    stage: int
    width: int
    chunks: int
    blocks: int
    smem: int


def _check_elements(name, *shapes):
    for shape in shapes:
        if int(np.prod(shape, dtype=np.int64)) >= 2 ** 31:
            raise ValueError(f"{name}: {shape} holds 2^31 elements or more; "
                             "the kernel indexes in 32 bits")


def stack8_plan(a: int, w: int, s: int, lane: int, win_aligned: bool,
                loc_aligned: bool) -> Stack8Plan:
    """The row through shared memory where w is a multiple of 4, win
    starts on a 16-byte boundary (``win_aligned``) and the row fits
    ``STACK8_SMEM_MAX``; 16-byte accesses of loc and out where s * lane
    is a multiple of 4 and loc starts on a 16-byte boundary
    (``loc_aligned``; out is the wrapper's own).  Refuses (ValueError)
    2^31 elements or more."""
    _check_elements("stack8", (a, w), (a, s, lane))
    smem = STACK8_ROW_OFF + 4 * w
    stage = win_aligned and w % 4 == 0 and smem <= STACK8_SMEM_MAX
    width = 4 if loc_aligned and (s * lane) % 4 == 0 else 1
    chunks = -(-s * lane // STACK8_PER_BLOCK)
    return Stack8Plan(int(stage), width, chunks, a * chunks,
                      smem if stage else 0)


def stack8(win, loc):
    """Takes any (a, w) float32 window and (s, lane) int32 positions with
    fewer than 2^31 elements in win and in out, on every device."""
    a, w = _dims("win", win, 2)
    s, lane = _dims("loc", loc, 2)
    plan = stack8_plan(a, w, s, lane, win.data_ptr() % 16 == 0,
                       loc.data_ptr() % 16 == 0)
    if win.device.type == "cpu":
        return stack8_plain(win, loc)
    device = cuda_device(win)
    check_tensor("win", win, F32, (a, w), device)
    check_tensor("loc", loc, I32, (s, lane), device)
    out = torch.empty((a, s, lane), dtype=F32, device=device)
    launch("vpic_probe_stack8", launches, "stack8", device,
           win, loc, out, a, w, s, lane, *plan)
    return out


class Onehot3dPlan(NamedTuple):
    """The launch of ``onehot3d_kernel`` on loc (r, lane) -> out (r, w,
    lane): a column is ``width`` consecutive l (4: one 16-byte load of loc
    and 16-byte stores); thread t is column t % c (c = lane / width) of
    phase t // c % phases of row r = t // c // phases, and writes rows
    phase, phase + phases, ... (``ONEHOT3D_ROWS`` at most) of its column,
    in ``blocks`` blocks of ``ONEHOT3D_BLOCK`` threads."""
    width: int
    phases: int
    blocks: int


def onehot3d_plan(r: int, w: int, lane: int, aligned: bool) -> Onehot3dPlan:
    """16-byte accesses where lane is a multiple of 4 and loc and out
    start on 16-byte boundaries (``aligned``), else one float a column.
    Refuses (ValueError) w < 1 and 2^31 elements or more."""
    if w < 1:
        raise ValueError(f"onehot3d takes w >= 1, got {w}")
    _check_elements("onehot3d", (r, w, lane))
    width = 4 if aligned and lane % 4 == 0 else 1
    phases = -(-w // ONEHOT3D_ROWS)
    return Onehot3dPlan(width, phases,
                        -(-r * (lane // width) * phases // ONEHOT3D_BLOCK))


def onehot3d(loc, w=W):
    """Takes any (r, lane) int32 positions and w >= 1 with fewer than 2^31
    elements in out, through the same plan on every device."""
    r, lane = _dims("loc", loc, 2)
    plan = onehot3d_plan(r, w, lane, loc.data_ptr() % 16 == 0)
    if loc.device.type == "cpu":
        return onehot3d_plain(loc, w)
    device = cuda_device(loc)
    check_tensor("loc", loc, I32, (r, lane), device)
    out = torch.empty((r, w, lane), dtype=F32, device=device)
    launch("vpic_probe_onehot3d", launches, "onehot3d", device,
           loc, out, r, w, lane, *plan)
    return out


class Io4dPlan(NamedTuple):
    """The launch of ``io4d_kernel`` on (b, 7, p) -> (b, 16, p): each
    thread moves ``width`` consecutive floats (4: one 16-byte access) of
    one output plane, thread t on columns [width * (t % c), width * (t % c
    + 1)) of plane t // c % 16 of block t // c // 16, c = p / width, in
    ``blocks`` blocks of ``IO4D_BLOCK`` threads."""
    width: int
    blocks: int


def io4d_plan(b: int, p: int, aligned: bool) -> Io4dPlan:
    """16-byte accesses where p is a multiple of 4 and ps and out start on
    16-byte boundaries (``aligned``), else one float per thread."""
    width = 4 if aligned and p % 4 == 0 else 1
    return Io4dPlan(width, -(-b * 16 * (p // width) // IO4D_BLOCK))


def io4d(ps):
    if ps.device.type == "cpu":
        return io4d_plain(ps)
    device = cuda_device(ps)
    b, _, r, lane = _dims("ps", ps, 4)
    check_tensor("ps", ps, F32, (b, 7, r, lane), device)
    out = torch.empty((b, 16, r, lane), dtype=F32, device=device)
    aligned = (ps.data_ptr() | out.data_ptr()) % 16 == 0
    launch("vpic_probe_io4d", launches, "io4d", device, ps, out, b, r * lane,
           *io4d_plan(b, r * lane, aligned))
    return out


# -- the tool's inputs ----------------------------------------------------------

def one_hot_window(device):
    """The tool's (R, W, LANE) one-hot ``oh[r,w,l] = (w == l + r)``."""
    w = np.arange(W)[None, :, None]
    lr = np.arange(LANE)[None, None, :] + np.arange(R)[:, None, None]
    return torch.as_tensor((w == lr).astype(np.float32), device=device)


def tool_loc(device):
    """The tool's int32 (R, LANE) lane positions, ``loc[s,l] = l``."""
    return torch.as_tensor(np.tile(np.arange(LANE, dtype=np.int32)[None, :],
                                   (R, 1)), device=device)


def _normal(seed, shape, device):
    x = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    return torch.as_tensor(x, device=device)


def tool_inputs(name, device):
    """The arguments the tool's probe ``name`` builds, from its seeds."""
    if name == "gather3d":
        return _normal(0, (32, W), device), one_hot_window(device)
    if name == "deposit2d":
        return _normal(1, (12, R, LANE), device), one_hot_window(device)
    if name == "stack8":
        return _normal(0, (32, W), device), tool_loc(device)
    if name == "onehot3d":
        return (tool_loc(device),)
    if name == "io4d":
        return (_normal(2, (4, 7, R, LANE), device),)
    raise KeyError(f"unknown probe {name!r}; the probes are {list(PROBES)}")


PROBES = {"gather3d": gather3d, "deposit2d": deposit2d, "stack8": stack8,
          "onehot3d": onehot3d, "io4d": io4d}
PLAIN = {"gather3d": gather3d_plain, "deposit2d": deposit2d_plain,
         "stack8": stack8_plain, "onehot3d": onehot3d_plain,
         "io4d": io4d_plain}
# the kernel each wrapper launches, as the profiler names it
KERNEL_NAMES = {"gather3d": "gather3d_kernel",
                "deposit2d": "deposit2d_kernel",
                "stack8": "stack8_kernel", "onehot3d": "onehot3d_kernel",
                "io4d": "io4d_kernel"}


def probe_bound(name, args, out):
    """(ms, "bytes" or "operations") of probe ``name`` on ``args``: its
    inputs read once and its output written once over the card's memory
    rate, or its products over the bf16 tensor-core rate."""
    ops, rate = 0.0, BF16_TENSOR_OPS_PER_S
    if name == "gather3d":
        ops = 2.0 * out.numel() * args[0].shape[1]
    elif name == "deposit2d":
        ops = 2.0 * out.numel() * args[0].shape[1] * args[0].shape[2]
    nbytes = sum(t.numel() * t.element_size() for t in (*args, out))
    return bound(nbytes, ops, rate)


def run(name, device, timed=False):
    """Run probe ``name`` on the tool's inputs; print the tool's line and,
    with ``timed``, the kernel's time through its wrapper beside its
    bound.  Returns (output, wrapper ms or None)."""
    t0 = time.perf_counter()
    args = tool_inputs(name, device)
    out = PROBES[name](*args)
    s = float(out.sum())
    print(f"{name:12s} OK   compile+run {time.perf_counter() - t0:6.1f}s "
          f"sum={s:.3f}", flush=True)
    if not timed:
        return out, None
    ms = cuda_ms(lambda: PROBES[name](*args), 20)
    bound_ms, bound_by = probe_bound(name, args, out)
    print(f"{'':12s} kernel through its wrapper {ms:.4f} ms (CUDA events, "
          f"20 calls); bound {bound_ms:.6f} ms ({bound_by})", flush=True)
    return out, ms


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("probes", nargs="*", metavar="probe",
                    help=f"any of {list(PROBES)} (default: all)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: cuda; cpu runs the plain "
                    "versions)")
    args = ap.parse_args(argv)
    unknown = sorted(set(args.probes) - set(PROBES))
    if unknown:
        ap.error(f"unknown probes {unknown}; the probes are {list(PROBES)}")
    device = resolve_device(args.device)
    on_card = device.type == "cuda"
    if on_card:
        print(card_line(device), flush=True)
    for name in args.probes or list(PROBES):
        run(name, device, timed=on_card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
