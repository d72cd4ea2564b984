"""Readings that set a cell's limits: for each seed, one run of the cell
(set-up, a window, the compared units) and the numbers of
``picbench/compare.py`` for the program and for the control, the plain
reference computed in bfloat16 (the float type below the configuration's
float32) in the program's place.  With ``--spread k`` the window is cut
into k pieces with one more compared unit after each, so that the
reference checks steps all through a window's length of replays.  The
benchmark's own runs never run it.

    python3 picbench/control.py --workload <cell> --seeds 1,2,3
        [--seconds 2] [--spread 0]

One JSON line per seed on standard output."""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from picbench import judge, run, state  # noqa: E402

CONTROL = "bfloat16"


def readings(name, seed, seconds, device="cuda", overrides=None,
             spread=0) -> dict:
    import torch
    cell = run.Cell(name, seed, seconds, device, overrides)
    cell.setup()
    box = judge.config_module(cell.cfg["name"]).box(cell.cfg)
    ref = judge.reference(cell.cfg)
    q_m = {s["name"]: s["q_m"] for s in cell.cfg["species"]}
    pairs = []
    for _ in range(spread):
        cell.window(seconds / spread)
        before = state.snapshot(cell.sim)
        cell.advance(cell.unit)
        pairs.append((before, state.summary(cell.sim, box, q_m, ref)))
    if not spread:
        cell.window(seconds)
    snaps = cell.compared_units()
    cell.release()
    t = time.perf_counter()
    program = judge.readings(cell.cfg, seed, cell.start, snaps, cell.device,
                             pairs=pairs)
    control = judge.readings(cell.cfg, seed, cell.start, snaps, cell.device,
                             control=getattr(torch, CONTROL), pairs=pairs)
    out = dict(workload=name, seed=seed, program=program, control=control,
               units=[a["step"] for a, _ in pairs] + [a["step"]
                                                       for a in snaps[:-1]],
               judge_s=time.perf_counter() - t)
    del cell
    if device == "cuda":
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--spread", type=int, default=0)
    args = ap.parse_args(argv)
    run.set_caches()
    for seed in (int(s) for s in args.seeds.split(",")):
        print(json.dumps(readings(args.workload, seed, args.seconds,
                                  spread=args.spread)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
