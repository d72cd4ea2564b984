"""Deck runner CLI of the port (``vpic_tpu/cli/run.py``; the reference's
``mpirun -np N ./deck.op [restart file] [modfile]`` flow,
src/main.cxx:24-122).

Usage:
    python -m vpic_tpu_torch.cli.run DECK.py [--device cuda|cpu]
                               [--restart CKPT] [--modfile F.json]
                               [--num-step N] [--quota HOURS]
                               [--status-interval N]
                               [--checkpoint-dir D] [--checkpoint-interval N]

The deck module defines ``deck(device) -> Simulation`` (grid, species,
fields and particles configured; ``finalize()`` may be called by the deck
or is called here) and may define ``diagnostics(sim)``, called after every
step.  ``--device`` (default ``cuda``) is passed to the deck: the run is
on the card unless ``--device cpu`` is asked for, and raises where there
is no card.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import sys
import time
from pathlib import Path


def log(msg):
    print(f"[vpic_tpu_torch] {msg}", flush=True)


def load_deck(path):
    spec = importlib.util.spec_from_file_location("deck", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules["deck"] = mod
    spec.loader.exec_module(mod)
    return mod


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("deck")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the run (default: cuda)")
    ap.add_argument("--restart", default=None,
                    help="checkpoint path to resume from")
    ap.add_argument("--modfile", default=None,
                    help="JSON runtime overrides (modify_runparams)")
    ap.add_argument("--num-step", type=int, default=None)
    ap.add_argument("--quota", type=float, default=None,
                    help="wall-clock quota in hours (defensive checkpoint)")
    ap.add_argument("--status-interval", type=int, default=100)
    ap.add_argument("--checkpoint-dir", default="restart")
    ap.add_argument("--checkpoint-interval", type=int, default=0)
    args = ap.parse_args(argv)

    from ..io.checkpoint import RotatingCheckpointer

    mod = load_deck(args.deck)
    sim = mod.deck(device=args.device)
    if sim.state is None:
        sim.finalize()

    if args.restart:
        sim.restore(args.restart)
        log(f"restored from {args.restart} at step {sim.step_count}")

    if args.modfile:
        overrides = json.loads(Path(args.modfile).read_text())
        sim.modify_runparams(**overrides)
        log(f"applied runtime overrides: {overrides}")
    if args.num_step is not None:
        sim.num_step = args.num_step

    diagnostics = getattr(mod, "diagnostics", None)
    ckpt = RotatingCheckpointer(args.checkpoint_dir, args.quota)

    t0 = time.time()
    steps_done = 0
    while sim.num_step <= 0 or sim.step_count < sim.num_step:
        sim.advance(1)
        steps_done += 1
        if diagnostics is not None:
            diagnostics(sim)
        if (args.status_interval > 0
                and sim.step_count % args.status_interval == 0):
            el = time.time() - t0
            total = sum(int(s.np) for s in sim.state.species) or 1
            log(f"step {sim.step_count}/{sim.num_step} ({el:.1f}s, "
                f"{total * steps_done / el:.3e} pushes/s)")
            sim.warn_dropped_movers(log=log)
        if (args.checkpoint_interval > 0
                and sim.step_count % args.checkpoint_interval == 0):
            sim.checkpoint(ckpt.slot(),
                           extra=dict(step_count=sim.step_count))
            ckpt.rtoggle ^= 1
        if ckpt.over_quota():
            # quota-triggered final checkpoint and a clean exit
            # (turbulence.cxx:1225-1247)
            slot = ckpt.slot()
            sim.checkpoint(slot, extra=dict(step_count=sim.step_count))
            log(f"quota reached; checkpointed to {slot}")
            return 0

    log(f"done: {sim.step_count} steps in {time.time() - t0:.1f}s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
