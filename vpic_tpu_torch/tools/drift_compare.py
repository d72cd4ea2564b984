"""Same-deck energy-drift comparison of the port against the float64 NumPy
reference transcription (``tests/ref/ref_impl.py``): it separates the
float32 drift of the port's step from bugs, as ``tools/drift_compare.py``
does for the JAX package (``BASELINE.md``'s drift bar is 1e-6).

    python -m vpic_tpu_torch.tools.drift_compare [steps] [npart_total] [nx]
        [--device cpu] [--out PATH]

The bench deck (``decks/bench_deck.py``: two species, a force-free sheet,
periodic vacuum) is built once; its post-finalize state (the fields with
their ghosts and the live particles) is mirrored into float64 arrays and
stepped with the reference's kernels in the composition of the port's
step for a closed periodic vacuum deck with cleaning off: push, current
unload, periodic fold of the shared planes, half B, E, half B.  Energies
on both sides are measured by the same functional (``Simulation.energies``
of a fresh port deck holding the mirrored state), so the numbers compare
directly:

  drift_fw   the port's float32 relative total-energy drift over the steps
  drift_ref  the float64 reference's drift on the same deck
  field_rms  relative RMS difference of each E and cB component after the
             steps (ghosts included)

``steps`` is rounded down to a whole sort period of the port's cadence
(at least one period); ``BENCH_RESORT`` and ``BENCH_ION_MULT`` set the
deck's resort interval and the ions' multiple of it.  The reference costs
about 30 us per particle and step on the host.  The record is printed as
one JSON line (with the card's name and power limit on the card) and
appended to ``--out`` where one is given.  A run that drops movers prints
``DRIFT SUSPECT`` and exits 1.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
from pathlib import Path

import numpy as np
import torch

from ..core.types import FIELD_COMPONENTS
from ..decks import bench_deck
from ..engine.step import step_sort_flags
from .probes_cuda import card_line, resolve_device

ROOT = Path(__file__).resolve().parents[2]
EB = ("ex", "ey", "ez", "cbx", "cby", "cbz")
PARTICLE_COLUMNS = ("dx", "dy", "dz", "ux", "uy", "uz", "q")


def reference():
    """The float64 reference ``tests/ref/ref_impl.py`` (NumPy only) of the
    repository checkout this package lies in."""
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    try:
        from tests.ref import ref_impl
    except ImportError as e:
        raise RuntimeError(
            f"drift_compare needs the float64 reference "
            f"tests/ref/ref_impl.py of the repository checkout at {ROOT}, "
            f"which could not be imported: {e}") from e
    return ref_impl


def reference_grid(sim):
    g = sim.grid
    return reference().G(g.nx, g.ny, g.nz, lx=float(g.gx1 - g.gx0),
                         ly=float(g.gy1 - g.gy0), lz=float(g.gz1 - g.gz0),
                         dt=float(g.dt), cvac=float(g.cvac),
                         eps0=float(g.eps0))


def fold_jf(fr, rg):
    """Periodic shared-plane current merge (the one-shard analogue of
    synchronize_jf, remote.c:416-506): each jf component is summed over
    its two transverse axes' shared node planes (1 and n+1)."""
    def fold(a, axis, n):
        sl_lo = [slice(None)] * 3
        sl_hi = [slice(None)] * 3
        sl_lo[axis] = 1
        sl_hi[axis] = n + 1
        tot = a[tuple(sl_lo)] + a[tuple(sl_hi)]
        a[tuple(sl_lo)] = tot
        a[tuple(sl_hi)] = tot

    dims = {0: rg.nz, 1: rg.ny, 2: rg.nx}   # array axes are [z, y, x]
    # jfx: transverse y, z ; jfy: z, x ; jfz: x, y
    for comp, axes in (("jfx", (1, 0)), ("jfy", (0, 2)), ("jfz", (2, 1))):
        for ax in axes:
            fold(fr[comp], ax, dims[ax])


def mirror(sim):
    """(fields, particles) of ``sim``'s state as float64 NumPy: every field
    component with its ghosts, and per species (q_m, columns) of its live
    lanes, the voxel as int64."""
    st = sim.state
    fr = {k: getattr(st.field, k).cpu().numpy().astype(np.float64)
          for k in FIELD_COMPONENTS}
    parts = []
    for sp in st.species:
        n = int(sp.np)
        cols = {k: getattr(sp, k)[:n].cpu().numpy().astype(np.float64)
                for k in PARTICLE_COLUMNS}
        cols["i"] = sp.i[:n].cpu().numpy().astype(np.int64)
        parts.append((float(sp.q_m), cols))
    return fr, parts


def reference_run(fr, parts, rg, steps):
    """Step the mirrored state ``steps`` times in place with the reference
    kernels: push, jf, fold, b/2, e, b/2."""
    R = reference()
    for _ in range(steps):
        ip = R.load_interpolator(fr, rg)
        acc = np.zeros((rg.nv, 12))
        for q_m, p in parts:
            R.advance_p(p, q_m, ip, acc, rg)
        for k in ("jfx", "jfy", "jfz"):
            fr[k][...] = 0.0
        R.unload_accumulator(fr, acc, rg)
        fold_jf(fr, rg)
        R.advance_b(fr, rg, 0.5)
        R.advance_e_vacuum(fr, rg)
        R.advance_b(fr, rg, 0.5)


def energies_of(fr, parts, sim):
    """The energies of a mirrored state, measured by the port: ``sim`` (a
    fresh deck of the same build) takes the fields, the particles and the
    reference's interpolator of the state, rounded to float32."""
    st = sim.state
    dev = st.field.ex.device

    def f32(v):
        return torch.as_tensor(np.asarray(v), dtype=torch.float32,
                               device=dev)

    field = st.field.replace(**{k: f32(fr[k]) for k in EB})
    species = []
    for sp, (_, p) in zip(st.species, parts):
        n = len(p["i"])
        pad = np.zeros(sp.max_np - n)
        cols = {k: f32(np.concatenate([p[k], pad])) for k in PARTICLE_COLUMNS}
        cols["i"] = torch.as_tensor(np.concatenate([p["i"], pad]).astype(
            np.int32), device=dev)
        species.append(sp.replace(
            np=torch.tensor(n, dtype=torch.int32, device=dev), **cols))
    sim.state = dataclasses.replace(
        st, field=field, species=tuple(species),
        interpolator=f32(reference().load_interpolator(fr,
                                                       reference_grid(sim))))
    return sim.energies()


def sort_period(sim) -> int:
    """The steps of one cycle of the port's sort cadence: the first step
    after 0 on which every species sorts again."""
    intervals = [sp.sort_interval for sp in sim.state.species]
    p = 1
    while not all(step_sort_flags(p, sim.grid, sim.opts, intervals)):
        p += 1
    return p


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def compare(steps=24, npart=16_000, nx=16, device="cuda", resort=2,
            ion_mult=4):
    """The drift record of the port against the float64 reference on the
    bench deck at nx^2 with ``npart`` particles in all, over ``steps``
    rounded to the sort period."""
    device = resolve_device(device)
    reference()

    def build():
        return bench_deck.build(nx=nx, ny=nx, nz=1, npart=npart // 2,
                                device=device, resort_interval=resort,
                                ion_sort_mult=ion_mult)

    sim = build()
    period = sort_period(sim)
    steps = max(period, (steps // period) * period)
    rg = reference_grid(sim)
    fr, parts = mirror(sim)

    tot0 = float(sum(sim.energies().values()))
    _sync(device)
    t0 = time.perf_counter()
    sim.advance(steps)
    _sync(device)
    wall_fw = time.perf_counter() - t0
    drift_fw = (float(sum(sim.energies().values())) - tot0) / tot0
    movers = sim.mover_counts()

    t0 = time.perf_counter()
    reference_run(fr, parts, rg, steps)
    wall_ref = time.perf_counter() - t0
    drift_ref = (float(sum(energies_of(fr, parts, build()).values()))
                 - tot0) / tot0

    rms = {}
    for k in EB:
        a = getattr(sim.state.field, k).cpu().numpy().astype(np.float64)
        b = fr[k]
        scale = max(np.sqrt(np.mean(b * b)), 1e-30)
        rms[k] = float(np.sqrt(np.mean((a - b) ** 2)) / scale)
    return dict(
        ts=time.time(), kind="drift_compare", backend=device.type,
        deck=f"{nx}x{nx} npart={npart}", steps=steps,
        knobs=dict(resort=resort, ion_mult=ion_mult),
        drift_fw=drift_fw, drift_ref=drift_ref,
        drift_excess=drift_fw - drift_ref,
        field_rms=rms, dropped_movers=movers,
        wall_fw=round(wall_fw, 3), wall_ref=round(wall_ref, 3))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("steps", nargs="?", type=int, default=24)
    ap.add_argument("npart", nargs="?", type=int, default=16_000,
                    help="particles in all, half per species")
    ap.add_argument("nx", nargs="?", type=int, default=16)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: cuda)")
    ap.add_argument("--out", default=None,
                    help="append the record as a JSON line to this file")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    rec = compare(args.steps, args.npart, args.nx, device,
                  resort=int(os.environ.get("BENCH_RESORT", 2)),
                  ion_mult=int(os.environ.get("BENCH_ION_MULT", 4)))
    if device.type == "cuda":
        rec["card"] = card_line(device)
    line = json.dumps(rec)
    print(line, flush=True)
    if args.out:
        with open(args.out, "a") as fh:
            fh.write(line + "\n")
    if any(rec["dropped_movers"].values()):
        print("DRIFT SUSPECT: dropped movers nonzero",
              rec["dropped_movers"])
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
