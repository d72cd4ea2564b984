"""Physics evidence of a run of the bench deck, the port's counterpart of
``tools/evidence.py``: run the deck N steps and record the energy drift,
whether the particle count is conserved, the cumulative dropped movers
and the field and per-species checksums, so that a change of speed cannot
hide a change of physics.

    python -m vpic_tpu_torch.tools.evidence [steps] [npart_total] [nx]
        [--device cpu] [--out PATH]

The deck is ``decks/bench_deck.build(nx, nx, 1, npart_total // 2)`` in
``bench.py``'s knob environment: ``BENCH_RESORT`` (default 2),
``BENCH_ION_MULT`` (4) and ``BENCH_NWALK`` (the walk's segment count;
default the step's own).  ``steps`` is rounded down to a whole sort
period of the port's cadence, at least one (``drift_compare.sort_period``:
8 steps at the bench cadence, where every species sorts again).  The JAX
tool rounds to ``resort_interval * _cycle_mult``, 2 steps unless the TPU's
packed cycle is on; a step count that is a multiple of 8 rounds alike in
both.  The record keeps the JAX tool's keys; ``knobs`` has no
``fix_cap``, as the port has no fix-up buffer.  ``backend`` is the torch
device type and ``device`` the card's name (``cpu`` on the CPU); on the
card ``card`` adds its name and power limit, and ``wall_s`` ends in
``torch.cuda.synchronize``.

The record is printed, then ``EVIDENCE OK`` where |drift| < 1e-4, the
particle count is conserved and no mover was dropped, else
``EVIDENCE SUSPECT`` (exit status 1).  It is appended as a JSON line to
``--out`` where one is given, and written nowhere else.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

from ..decks import bench_deck
from .drift_compare import _sync, sort_period
from .probes_cuda import card_line, resolve_device

DRIFT_BAR = 1e-4


def knobs_from_env() -> dict:
    """bench.py's knob environment, as the JAX tool records it."""
    n_walk = os.environ.get("BENCH_NWALK")
    return dict(resort=int(os.environ.get("BENCH_RESORT", 2)),
                ion_mult=int(os.environ.get("BENCH_ION_MULT", 4)),
                n_walk=int(n_walk) if n_walk else None,
                env={k: v for k, v in os.environ.items()
                     if k.startswith("VPIC_TPU_")})


def live_count(sim) -> int:
    return sum(int(sp.np) for st in sim.states for sp in st.species)


def evidence(steps=24, npart=1_000_000, nx=128, device="cuda") -> dict:
    """The evidence record of ``steps`` steps (rounded to the sort period)
    of the bench deck at nx^2 with ``npart`` particles in all."""
    device = resolve_device(device)
    knobs = knobs_from_env()
    sim = bench_deck.build(nx=nx, ny=nx, nz=1, npart=npart // 2,
                           device=device, resort_interval=knobs["resort"],
                           ion_sort_mult=knobs["ion_mult"],
                           n_walk=knobs["n_walk"])
    period = sort_period(sim)
    steps = max(period, (steps // period) * period)

    tot0 = float(sum(sim.energies().values()))
    np0 = live_count(sim)
    _sync(device)
    t0 = time.perf_counter()
    sim.advance_steps(steps)
    _sync(device)
    wall = time.perf_counter() - t0
    tot1 = float(sum(sim.energies().values()))

    rec = dict(
        ts=time.time(),
        backend=device.type,
        device=(torch.cuda.get_device_name(device)
                if device.type == "cuda" else "cpu"),
        deck=f"{nx}x{nx} npart={npart}",
        steps=steps,
        knobs=knobs,
        wall_s=round(wall, 3),
        energy0=tot0,
        energy1=tot1,
        drift=(tot1 - tot0) / tot0 if tot0 else None,
        np_conserved=(np0 == live_count(sim)),
        dropped_movers=sim.mover_counts(),
        field_sha1=sim.checksum_fields(),
        species_sha1={h["name"]: sim.checksum_species(h["name"])
                      for h in sim._species},
    )
    if device.type == "cuda":
        rec["card"] = card_line(device)
    return rec


def is_ok(rec) -> bool:
    """The JAX tool's rule: |drift| < 1e-4, the count conserved, no
    dropped mover."""
    return (rec["np_conserved"] and rec["drift"] is not None
            and abs(rec["drift"]) < DRIFT_BAR
            and not any(rec["dropped_movers"].values()))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("steps", nargs="?", type=int, default=24)
    ap.add_argument("npart", nargs="?", type=int, default=1_000_000,
                    help="particles in all, half per species")
    ap.add_argument("nx", nargs="?", type=int, default=128)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: cuda)")
    ap.add_argument("--out", default=None,
                    help="append the record as a JSON line to this file")
    args = ap.parse_args(argv)
    rec = evidence(args.steps, args.npart, args.nx, args.device)
    if args.out:
        with open(args.out, "a") as fh:
            fh.write(json.dumps(rec) + "\n")
    print(json.dumps(rec, indent=1), flush=True)
    ok = is_ok(rec)
    print("EVIDENCE " + ("OK" if ok else "SUSPECT"), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
