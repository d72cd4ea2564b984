"""The elementwise-chain probe of ``tools/vpu_layout_probe.py`` on the
card: the kernel ``vpic_probe_vpu_chain`` of ``csrc/probes.cu``, its
plain PyTorch version, and the tool's seven shapes.

    python -m vpic_tpu_torch.tools.vpu_layout_probe [--device cpu]

On the (rows, n) window of an (max(rows, 8), n) float32 block the chain
runs ``reps`` times (1024 in the tool)::

    acc = acc * 1.0000001 + 1
    acc = where(acc > 2, acc - 1, acc)

each operation rounded to float32 on its own; the rows past ``rows`` are
zeros.  On the TPU the question was whether a (1, n) row wastes seven of
eight sublanes; each shape holds about 2^17 elements.  On the card it
prints, per shape, the tool's line (ms, Gop/s counted as the tool counts
them: 3 per element and rep) with the kernel's time through its wrapper
(CUDA events over 20 calls) and its bound; ``--device cpu`` runs the plain
version once per shape and prints its host time.
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import NamedTuple

import torch

from ..particles.push_cuda import check_tensor, cuda_device
from .probes_cuda import bound, card_line, cuda_ms, launch, resolve_device

REPS = 1024
ROWS = (1, 2, 3, 4, 8, 16, 64)
TOTAL = 1 << 17
# float32 operations per element and rep that the bound counts: multiply,
# add, compare, subtract, select (the kernel issues four instructions per
# rep, the select folded into the subtract: csrc/probes.cu)
OPS_PER_REP = 5

# threads per block of the kernel (csrc/probes.cu: kChainBlock)
CHAIN_BLOCK = 256

launches = {"vpu_chain": 0}


def block_shape(rows: int, total: int = TOTAL) -> tuple:
    """The tool's (max(rows, 8), n) block, n = total / rows rounded up to a
    multiple of 128."""
    n = (total // rows + 127) // 128 * 128
    return max(rows, 8), n


def chain_plain(x: torch.Tensor, rows: int, reps: int = REPS):
    """The chain on ``x[:rows]``, each operation rounded on its own; the
    other rows of the result are zeros."""
    f32 = dict(dtype=torch.float32, device=x.device)
    c, one, two = (torch.tensor(v, **f32) for v in (1.0000001, 1.0, 2.0))
    acc = x[:rows]
    for _ in range(reps):
        acc = acc * c + one
        acc = torch.where(acc > two, acc - one, acc)
    out = torch.zeros_like(x)
    out[:rows] = acc
    return out


class ChainPlan(NamedTuple):
    """The launch of ``vpu_chain_kernel`` on a row-major (out_rows, n)
    block whose output starts on a 16-byte boundary: ``blocks`` blocks of
    ``CHAIN_BLOCK`` threads; thread g takes floats g and g + ``pairs`` of
    the window (the first ``window`` = rows * n floats, pairs =
    ceil(window / 2)) through the chain, after writing zero float g of
    the ``head`` floats after the window, zero float4 g, g + T, ... of the
    ``vec4`` float4 from the next 16-byte boundary (T the grid's threads)
    and zero float g of the ``tail`` floats after those."""
    window: int
    pairs: int
    blocks: int
    head: int
    vec4: int
    tail: int


def chain_plan(rows: int, n: int, out_rows: int) -> ChainPlan:
    window, end = rows * n, out_rows * n
    aligned = min(end, -(-window // 4) * 4)
    last = max(aligned, end // 4 * 4)
    pairs = -(-window // 2)
    return ChainPlan(window, pairs, -(-pairs // CHAIN_BLOCK),
                     aligned - window, (last - aligned) // 4, end - last)


def chain(x: torch.Tensor, rows: int, reps: int = REPS):
    """Kernel version of :func:`chain_plain` (the plain version for a CPU
    tensor)."""
    if x.device.type == "cpu":
        return chain_plain(x, rows, reps)
    device = cuda_device(x)
    if x.dim() != 2 or not 0 < rows <= x.shape[0] or reps < 0:
        raise ValueError(f"chain takes a 2D block of at least rows = {rows} "
                         f"rows and reps >= 0, got {tuple(x.shape)} and "
                         f"{reps}")
    check_tensor("x", x, torch.float32, x.shape, device)
    out = torch.empty_like(x)
    launch("vpic_probe_vpu_chain", launches, "vpu_chain", device,
           x, out, rows, x.shape[1], x.shape[0], reps,
           *chain_plan(rows, x.shape[1], x.shape[0]))
    return out


def chain_bound(rows: int, x: torch.Tensor, reps: int = REPS):
    """(ms, "bytes" or "operations"): the window read once, the block
    written once, five float32 operations per element and rep."""
    n = x.shape[1]
    return bound(4 * (rows * n + x.numel()), OPS_PER_REP * reps * rows * n)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: cuda; cpu runs the plain "
                    "version)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    on_card = device.type == "cuda"
    if on_card:
        print(card_line(device), flush=True)
    for rows in ROWS:
        shape = block_shape(rows)
        n = shape[1]
        x = torch.ones(shape, dtype=torch.float32, device=device)
        if on_card:
            ms = cuda_ms(lambda: chain(x, rows), 20)
        else:
            t0 = time.perf_counter()
            chain(x, rows)
            ms = (time.perf_counter() - t0) * 1e3
        gops = rows * n * REPS * 3 / (ms * 1e-3) / 1e9
        line = f"({rows:5d},{n:7d})  {ms:8.3f} ms   {gops:8.1f} Gop/s"
        if on_card:
            bound_ms, bound_by = chain_bound(rows, x)
            line += f"   bound {bound_ms:.4f} ms ({bound_by})"
        else:
            line += "   (plain version, host clock)"
        print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
