"""Scaling table of the port, its counterpart of ``tools/scaling_bench.py``:
the bench deck (``decks/bench_deck.build``) at the JAX tool's seven
particle counts and grid sizes, one CSV row per configuration (ms/step,
pushes/s, and the speedup over the reference's 7.8M/s CPU headline).

    python -m vpic_tpu_torch.tools.scaling_bench [steps] [--device cpu]

``SCALE_ONLY`` selects the configurations whose ``nx`` or ``nx x ny x
nz`` it names (``SCALE_ONLY=512``, ``SCALE_ONLY=64x64x64``).  Each deck
runs one sort period of warm-up (``drift_compare.sort_period``: 8 steps
at the bench cadence; where the deck runs as CUDA graphs this captures
the graph), then ``nst`` steps op by op (``Simulation.advance_eager``)
and ``nst`` steps through ``Simulation.advance``, each window timed,
``nst`` the steps rounded down to whole sort periods (at least one); a
timed window ends in ``torch.cuda.synchronize`` on the card.  The CSV's
step is the second window's; the row also keeps the first's
(``eager_ms_per_step``).  One deck is held at a time.  Standard output is the CSV table; on the card the card's
name and power limit go to standard error first.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

from ..decks import bench_deck
from .drift_compare import _sync, sort_period
from .evidence import live_count
from .probes_cuda import card_line, resolve_device

CONFIGS = [
    # (npart_total, nx, ny, nz)
    (1_000_000, 128, 128, 1),
    (4_000_000, 128, 128, 1),
    (8_000_000, 128, 128, 1),
    (8_000_000, 256, 256, 1),
    (16_000_000, 256, 256, 1),
    (8_000_000, 512, 512, 1),
    (8_000_000, 64, 64, 64),
]
HEADER = "npart,nx,ny,nz,ms_per_step,pushes_per_s,vs_ref_cpu"
REF_CPU_PUSHES_PER_S = 7.8e6     # the reference's CPU headline


def selected(configs, only):
    """The configurations that ``SCALE_ONLY``'s value ``only`` names (all
    where it is empty or None)."""
    return [c for c in configs
            if not only or only in (str(c[1]), f"{c[1]}x{c[2]}x{c[3]}")]


def csv_row(row) -> str:
    return (f"{row['npart']},{row['nx']},{row['ny']},{row['nz']},"
            f"{row['ms_per_step']:.1f},{row['pushes_per_s']:.3e},"
            f"{row['vs_ref_cpu']:.2f}")


def sweep(configs, steps=10, device="cuda"):
    """For each (npart_total, nx, ny, nz) of ``configs`` build the bench
    deck, warm it up and time it; yields (row, sim): the row's CSV columns
    and ``eager_ms_per_step``, ``graphed``, ``build_s``, ``period`` and
    ``nst``, and the deck after its timed windows.  The deck is dropped before the next is built; a caller that
    keeps ``sim`` past its turn holds two decks."""
    device = resolve_device(device)
    for npart, nx, ny, nz in configs:
        t0 = time.perf_counter()
        sim = bench_deck.build(nx=nx, ny=ny, nz=nz, npart=npart // 2,
                               device=device)
        _sync(device)
        build_s = time.perf_counter() - t0
        period = sort_period(sim)
        sim.advance(period)
        _sync(device)
        nst = max(period, (steps // period) * period)
        t0 = time.perf_counter()
        sim.advance_eager(nst)
        _sync(device)
        eager_dt = time.perf_counter() - t0
        # copies the eager steps' state into the graphs' buffers before
        # the timed window (nothing where the deck steps eagerly)
        sim.advance(0)
        _sync(device)
        t0 = time.perf_counter()
        sim.advance(nst)
        _sync(device)
        dt = time.perf_counter() - t0
        total = live_count(sim)
        pps = total * nst / dt
        row = dict(npart=total, nx=nx, ny=ny, nz=nz,
                   ms_per_step=dt / nst * 1e3, pushes_per_s=pps,
                   vs_ref_cpu=pps / REF_CPU_PUSHES_PER_S,
                   eager_ms_per_step=eager_dt / nst * 1e3,
                   graphed=sim.graphed, build_s=build_s, period=period,
                   nst=nst)
        yield row, sim
        del sim


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("steps", nargs="?", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    if device.type == "cuda":
        print(card_line(device), file=sys.stderr, flush=True)
    print(HEADER, flush=True)
    configs = selected(CONFIGS, os.environ.get("SCALE_ONLY"))
    for row, sim in sweep(configs, args.steps, device):
        del sim
        print(csv_row(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
