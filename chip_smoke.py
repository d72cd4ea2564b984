#!/usr/bin/env python3
"""Smoke test of vpic_tpu_torch on one NVIDIA GPU: the port's main path,
the bench deck at full size, through the hand-written CUDA push kernel.

    python3 chip_smoke.py

Phases (each raises on failure; the script then exits non-zero and prints
no result line):

1. device   - the card's name and power limit (nvidia-smi);
2. build    - build the CUDA kernel from vpic_tpu_torch/csrc into
              vpic_tpu_torch/_build;
3. kernel   - the kernel against its plain PyTorch version on the card, on
              a small 3D grid (periodic, reflecting and absorbing faces, hot
              and cold lanes) and at the bench shape (128^2, 2M particles
              per species), for the push and the walk_only entry: voxels,
              pcode and particle floats bitwise equal, the accumulator
              within 1e-6 * sum|contributions| per voxel; timed against the
              plain version;
4. determinism - two kernel runs from one state are bitwise equal;
5. slice    - a 16^2 deck agrees with the plain path on the CPU; then the
              128^2, 2 x 2M deck runs 8 warm-up steps and three timed
              windows of 16 steps (two whole sort super-cycles each) with
              finite energies, bounded energy drift, no dropped movers and
              one kernel launch per species per step; the median pushes/s;
              then a torch.profiler trace of 8 more steps splits the busy
              device time between sort, push and field and gives the
              device's idle share.

The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}.  Without a CUDA device the script exits 2.
"""

import json
import os
import subprocess
import sys
import time

SLICE = dict(nx=128, ny=128, nz=1, npart=2_000_000)
WARM_STEPS, STEPS, WINDOWS, TRACE_STEPS = 8, 16, 3, 8
DRIFT_LIMIT = 1e-5     # |relative total-energy change| over STEPS


def log(msg):
    print(msg, flush=True)


def card_line():
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps):
    """Mean device time of fn() in ms over reps runs, CUDA events."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def abs_deposit(st, neighbor, g, seg_cap):
    """sum|contribution| per accumulator word of a walk from WalkState
    ``st``: the scale of the accumulator tolerance."""
    import torch
    from vpic_tpu_torch.particles import push
    acc = torch.zeros((g.nv, 12), dtype=torch.float64, device=st.x.device)
    for _ in range(seg_cap):
        if not bool(st.active.any()):
            break
        was = st.active
        st, dep_vox, contrib = push.walk_segment(st, neighbor, g)
        c = torch.stack(contrib, dim=-1).abs().to(torch.float64)
        acc.index_add_(0, dep_vox[was].long(), c[was])
    return acc


def compare(label, kernel_out, plain_out, kacc, pacc, absacc, floats, ints):
    """Bitwise particle state, accumulator within 1e-6*sum|c|; returns the
    accumulator's max abs error."""
    import torch
    for name in ints:
        a, b = getattr(kernel_out, name), getattr(plain_out, name)
        if not torch.equal(a, b):
            bad = int((a != b).sum())
            raise AssertionError(f"{label}: {name} differs in {bad} lanes")
    for name in floats:
        a, b = getattr(kernel_out, name), getattr(plain_out, name)
        same = (a.view(torch.int32) == b.view(torch.int32)) | (
            (a == 0) & (b == 0))
        if not bool(same.all()):
            bad = int((~same).sum())
            ulp = int((a.view(torch.int32).long()
                       - b.view(torch.int32).long()).abs().max())
            raise AssertionError(f"{label}: {name} differs in {bad} lanes "
                                 f"(max {ulp} ulp)")
    err = (kacc.to(torch.float64) - pacc.to(torch.float64)).abs()
    limit = 1e-6 * absacc + 1e-30
    if not bool((err <= limit).all()):
        worst = float((err / limit).max())
        raise AssertionError(f"{label}: acc beyond 1e-6*sum|c| "
                             f"(worst {worst:.3g}x the limit)")
    return float(err.max())


def random_species(g, n, max_np, hot, seed, device):
    import numpy as np
    import torch
    from vpic_tpu_torch.core.types import SpeciesState
    rng = np.random.default_rng(seed)
    vox = np.asarray(g.voxel(rng.integers(1, g.nx + 1, n),
                             rng.integers(1, g.ny + 1, n),
                             rng.integers(1, g.nz + 1, n)), np.int32)
    order = np.argsort(vox, kind="stable")
    ut = 3.0 if hot else 0.2

    def col(a, dtype=np.float32):
        full = np.zeros(max_np, dtype)
        full[:n] = a[order]
        return torch.as_tensor(full, device=device)

    return SpeciesState.create("e", 0, -1.0, max_np, device=device).replace(
        np=torch.tensor(n, dtype=torch.int32, device=device),
        i=col(vox, np.int32),
        **{k: col(rng.uniform(-1, 1, n)) for k in ("dx", "dy", "dz")},
        **{k: col(rng.normal(0, ut, n)) for k in ("ux", "uy", "uz")},
        q=col(rng.uniform(0.5, 1.5, n)))


def walk_state_from(sp, seed, scale):
    """Mid-walk lanes: half of the live lanes active, with remaining
    displacements uniform in [-scale, scale]."""
    import torch
    from vpic_tpu_torch.particles import push
    gen = torch.Generator(device=sp.dx.device).manual_seed(seed)
    n = sp.max_np
    rem = [(torch.rand(n, generator=gen, device=sp.dx.device) * 2 - 1)
           * scale for _ in range(3)]
    active = sp.alive & (torch.rand(n, generator=gen,
                                    device=sp.dx.device) < 0.5)
    return push.WalkState(x=sp.dx, y=sp.dy, z=sp.dz, vox=sp.i, ux=sp.ux,
                          uy=sp.uy, uz=sp.uz, rx=rem[0], ry=rem[1],
                          rz=rem[2], q=sp.q,
                          pcode=torch.zeros_like(sp.pc), active=active)


PUSH_FLOATS = ("dx", "dy", "dz", "ux", "uy", "uz", "mdx", "mdy", "mdz")
WALK_FLOATS = ("x", "y", "z", "ux", "uy", "uz", "rx", "ry", "rz")


def check_push(label, sp, interp, nb, g, n_walk):
    import torch
    from vpic_tpu_torch.particles import push, push_cuda
    acc0 = torch.zeros((g.nv, 12), dtype=torch.float32, device=sp.dx.device)
    ko, kacc = push_cuda.advance_p(sp, interp, acc0, nb, g, n_walk=n_walk)
    po, pacc = push.advance_p(sp, interp, acc0, nb, g, n_walk=n_walk)
    absacc = abs_deposit(push.pushed_walk_state(sp, interp, g), nb, g,
                         1 + 4 * (n_walk - 1) + 8)
    err = compare(label, ko, po, kacc, pacc, absacc, PUSH_FLOATS,
                  ("i", "pc"))
    if not torch.equal(ko.nm, po.nm):
        raise AssertionError(f"{label}: nm {int(ko.nm)} != {int(po.nm)}")
    moved = int((ko.i != sp.i).sum())
    log(f"  {label}: push ok (lanes {int(sp.np)}, changed voxel {moved}, "
        f"pending {int((ko.pc != 0).sum())}, acc max abs err {err:.3g})")
    return err, ko, kacc


def check_walk(label, st, nb, g, n_iter):
    import torch
    from vpic_tpu_torch.particles import push, push_cuda
    acc0 = torch.zeros((g.nv, 12), dtype=torch.float32, device=st.x.device)
    ko, kacc = push_cuda.streak_walk(st, acc0, nb, g, n_iter)
    po, pacc = push.streak_walk(st, acc0, nb, g, n_iter)
    absacc = abs_deposit(st, nb, g, 4 * n_iter + 8)
    err = compare(label, ko, po, kacc, pacc, absacc, WALK_FLOATS,
                  ("vox", "pcode", "active"))
    log(f"  {label}: walk_only ok (active {int(st.active.sum())}, "
        f"acc max abs err {err:.3g})")
    return err


def small_grid_case(pbc_name, hot, device):
    """A 6x5x4 grid with random interpolator rows and 3000 sorted lanes
    (4096 slots); faces periodic, reflecting, or reflecting in -x with an
    absorbing -y face."""
    import numpy as np
    import torch
    from vpic_tpu_torch.core.types import (Grid, NEIGHBOR_ABSORB,
                                           NEIGHBOR_REFLECT, PERIODIC_FIELDS)
    from vpic_tpu_torch.grid.partition import make_grid_arrays
    P, R, A = PERIODIC_FIELDS, NEIGHBOR_REFLECT, NEIGHBOR_ABSORB
    pbc = {"periodic": (P,) * 6, "reflect": (R,) * 6,
           "reflect+absorb": (R, A, P, P, P, P)}[pbc_name]
    g = Grid(nx=6, ny=5, nz=4, dt=0.04, pbc=pbc)
    nb = make_grid_arrays(g, device=device).neighbor
    rng = np.random.default_rng(7)
    interp = torch.as_tensor(
        (0.1 * rng.normal(size=(g.nv, 18))).astype(np.float32),
        device=device)
    return g, nb, interp, random_species(g, 3000, 4096, hot, 11, device)


SMALL_FACES = ("periodic", "reflect", "reflect+absorb")


def phase_kernel_small(device):
    for name in SMALL_FACES:
        for hot in (False, True):
            g, nb, interp, sp = small_grid_case(name, hot, device)
            label = f"3D 6x5x4 {name} {'hot' if hot else 'cold'}"
            check_push(label, sp, interp, nb, g, n_walk=4)
            check_walk(label, walk_state_from(sp, 5, 1.5 if hot else 0.3),
                       nb, g, 2)


def phase_kernel_slice(sim):
    """The bench shape: both species of the 128^2 deck after finalize,
    voxel-sorted as the step sorts them before its first push."""
    import torch
    from vpic_tpu_torch.engine.step import walk_segments
    from vpic_tpu_torch.particles import aux, push, push_cuda
    st, g = sim.state, sim.grid
    nb = st.grid_arrays.neighbor
    n_walk = walk_segments(g, sim.opts)
    errs = []
    species = [aux.sort_p(sp) for sp in st.species]
    for sp in species:
        label = f"128^2 {sp.name}"
        err, ko, kacc = check_push(label, sp, st.interpolator, nb, g, n_walk)
        errs.append(err)
        errs.append(check_walk(label, walk_state_from(sp, 3, 0.6), nb, g,
                               n_walk - 1))
        # determinism: a second run from the same state, bitwise
        acc0 = torch.zeros_like(kacc)
        ko2, kacc2 = push_cuda.advance_p(sp, st.interpolator, acc0, nb, g,
                                         n_walk=n_walk)
        for name in PUSH_FLOATS + ("i", "pc", "nm"):
            if not torch.equal(getattr(ko, name), getattr(ko2, name)):
                raise AssertionError(f"{label}: rerun differs in {name}")
        if not torch.equal(kacc, kacc2):
            raise AssertionError(f"{label}: rerun acc differs")
        log(f"  {label}: two kernel runs bitwise equal")

    # timing at the bench shape, sorted electrons: plain, kernel, kernel,
    # plain
    sp = species[0]
    acc0 = torch.zeros((g.nv, 12), dtype=torch.float32, device=sp.dx.device)
    run_k = lambda: push_cuda.advance_p(sp, st.interpolator, acc0, nb, g,
                                        n_walk=n_walk)
    run_p = lambda: push.advance_p(sp, st.interpolator, acc0, nb, g,
                                   n_walk=n_walk)
    p1, k1, k2, p2 = (cuda_ms(run_p, 5), cuda_ms(run_k, 20),
                      cuda_ms(run_k, 20), cuda_ms(run_p, 5))
    log(f"  timing, 128^2 sorted electrons ({int(sp.np)} lanes): kernel "
        f"{k1:.4f} / {k2:.4f} ms, plain {p1:.4f} / {p2:.4f} ms")
    return max(errs), min(k1, k2), min(p1, p2)


def phase_small_deck(device):
    """A 16^2 deck on the card (kernel) against the same deck on the CPU
    (plain path, which the CPU tests hold to the JAX package)."""
    from vpic_tpu_torch.decks import bench_deck
    deck = dict(nx=16, ny=16, nz=1, npart=4096)
    gpu = bench_deck.build(**deck, device=device)
    cpu = bench_deck.build(**deck, device="cpu")
    gpu.advance(8)
    cpu.advance(8)
    eg, ec = gpu.energies(), cpu.energies()
    for k in ec:
        if abs(eg[k] - ec[k]) > 1e-6 * abs(ec[k]) + 1e-12:
            raise AssertionError(f"16^2 deck: energy {k} {eg[k]!r} vs "
                                 f"CPU {ec[k]!r}")
    log(f"  16^2 deck, 8 steps: card energies match the CPU plain path "
        f"to 1e-6 relative ({len(ec)} energies)")


def phase_slice(sim):
    """The main path: advance the 128^2 deck through the Simulation API,
    WINDOWS timed windows of STEPS steps, each from a sort super-cycle
    boundary; returns (kernel launches, median pushes/s, median step s)."""
    import math
    import statistics
    import torch
    from vpic_tpu_torch.particles import push_cuda
    sim.advance(WARM_STEPS)
    torch.cuda.synchronize()
    nsp = len(sim.state.species)
    n_total = sum(int(sp.np) for sp in sim.state.species)
    push_cuda.reset_launch_counts()
    step_s = []
    for w in range(WINDOWS):
        if sim.step_count % (sim.opts.resort_interval * 4):
            raise AssertionError("a timed window must start on a "
                                 "super-cycle")
        e0, nm0 = sim.energies(), sim.mover_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sim.advance(STEPS)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        e1, nm1 = sim.energies(), sim.mover_counts()
        if not all(math.isfinite(v) for v in list(e0.values())
                   + list(e1.values())):
            raise AssertionError(f"non-finite energies {e1}")
        drops = {k: nm1[k] - nm0[k] for k in nm1}
        if any(drops.values()):
            raise AssertionError(f"dropped movers {drops}")
        tot0, tot1 = sum(e0.values()), sum(e1.values())
        drift = (tot1 - tot0) / tot0
        if not abs(drift) < DRIFT_LIMIT:
            raise AssertionError(f"energy drift {drift:.3e} over {STEPS} "
                                 "steps")
        step_s.append(dt / STEPS)
        log(f"  window {w + 1}/{WINDOWS}: {STEPS} steps in {dt:.4f} s, "
            f"{dt / STEPS * 1e3:.4f} ms/step, "
            f"{n_total * STEPS / dt:.6e} pushes/s, dropped movers {drops}, "
            f"energy drift {drift:.3e}")
    launches = push_cuda.launches["push"]
    if launches != WINDOWS * STEPS * nsp:
        raise AssertionError(f"kernel launches {launches} != steps x "
                             f"species = {WINDOWS * STEPS * nsp}")
    med = statistics.median(step_s)
    log(f"  {n_total} particles, {WINDOWS * STEPS} steps: median "
        f"{med * 1e3:.4f} ms/step (min {min(step_s) * 1e3:.4f}, max "
        f"{max(step_s) * 1e3:.4f}), kernel launches {launches}")
    return launches, n_total / med, med


def _busy_us(intervals):
    """Length of the union of (start, end) intervals."""
    busy, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy


def _step_parts(events, dev):
    """The step part (a name of PHASES, or None) of each device op in
    ``dev``: the scope whose host interval holds the op's launch call,
    the runtime event with the op's correlation id.  (The kernels this
    package launches through ctypes are not linked to a scope by the
    profiler's own tree, but their launch calls are in the trace.)  Also
    returns how many ops had a launch call in the trace."""
    from torch.autograd import DeviceType
    from vpic_tpu_torch.engine.step import PHASES
    scopes = [(e.time_range.start, e.time_range.end, e.name)
              for e in events if e.device_type == DeviceType.CPU
              and e.name in PHASES]
    launch = {e.id: e.time_range.start for e in events
              if e.device_type == DeviceType.CPU
              and e.name.startswith(("cuda", "cuLaunch"))}
    parts = [next((n for s, f, n in scopes if s <= launch[e.id] <= f), None)
             if e.id in launch else None for e in dev]
    return parts, sum(e.id in launch for e in dev)


def phase_trace(sim, step_s):
    """A torch.profiler trace of TRACE_STEPS main-path steps (one sort
    super-cycle): per step, the device busy time (union of kernel and copy
    intervals), the device operations, the busy device time of each step
    part and of the busiest kernels; the idle share under the profiler,
    and the one derived from the busy time and the unprofiled step time
    ``step_s``."""
    import collections
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from vpic_tpu_torch.engine.step import PHASES
    if sim.step_count % (sim.opts.resort_interval * 4):
        raise AssertionError("traced window must start on a super-cycle")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sim.advance(TRACE_STEPS)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = prof.events()
    dev = [e for e in events if e.device_type == DeviceType.CUDA
           and not e.is_user_annotation and e.name not in PHASES]
    if not dev:
        raise AssertionError("the profiler recorded no device operation")
    span = lambda e: (e.time_range.start, e.time_range.end)
    busy = _busy_us([span(e) for e in dev])
    parts, placed = _step_parts(events, dev)
    part_busy = {k: _busy_us([span(e) for e, p in zip(dev, parts) if p == k])
                 for k in (*PHASES, None)}
    by_kernel = collections.Counter()
    for e in dev:
        by_kernel[e.name] += e.time_range.elapsed_us()
    per = lambda us: us / TRACE_STEPS / 1e3
    log(f"  trace, {TRACE_STEPS} steps under torch.profiler: device busy "
        f"{per(busy):.4f} ms/step, device ops {len(dev) / TRACE_STEPS:.1f}"
        f"/step ({placed} of {len(dev)} with their launch call), wall "
        f"{per(wall_us):.4f} ms/step, idle share {1 - busy / wall_us:.4f}")
    log(f"  derived idle share without the profiler: 1 - busy / step = "
        f"1 - {per(busy):.4f} / {step_s * 1e3:.4f} = "
        f"{1 - per(busy) / (step_s * 1e3):.4f}")
    log("  busy device ms/step by step part: " + ", ".join(
        f"{k} {per(part_busy[k]):.4f}" for k in PHASES)
        + f", outside the parts {per(part_busy[None]):.4f}")
    log("  busiest kernels, device ms/step: " + "; ".join(
        f"{name[:60]} {per(us):.4f}"
        for name, us in by_kernel.most_common(6)))
    if not all(part_busy[k] > 0 for k in PHASES):
        raise AssertionError(f"the trace attributes no device time to a "
                             f"step part: {part_busy}")


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from vpic_tpu_torch.decks import bench_deck
    from vpic_tpu_torch.particles import push_cuda

    device = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    card = card_line()
    log(f"[1/5] device: {kind} (count {count}); torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    log(card)

    t0 = time.perf_counter()
    push_cuda.build()
    log(f"[2/5] build: {time.perf_counter() - t0:.3f} s -> "
        f"{push_cuda.library_path().relative_to(push_cuda.PKG_DIR.parent)}")
    for line in push_cuda.library_path().with_suffix(".log").read_text() \
            .splitlines():
        if "registers" in line or "spill" in line:
            log("  ptxas: " + line.strip())

    log("[3/5] kernel vs plain, small 3D grid")
    phase_kernel_small(device)
    t0 = time.perf_counter()
    sim = bench_deck.build(**SLICE, device=device)
    torch.cuda.synchronize()
    log(f"[3/5] kernel vs plain, 128^2 deck (built in "
        f"{time.perf_counter() - t0:.2f} s)")
    max_err, k_ms, p_ms = phase_kernel_slice(sim)
    log("[4/5] determinism: checked above, per species")

    log("[5/5] slice")
    phase_small_deck(device)
    launches, rate, step_s = phase_slice(sim)
    phase_trace(sim, step_s)
    log(f"pushes/s: {rate:.6e} ({card}; 128^2, {SLICE['npart']} particles "
        f"per species, median of {WINDOWS} windows of {STEPS} steps, step "
        f"{step_s * 1e3:.4f} ms)")
    print(json.dumps({"kernels": [{
        "name": "push_walk", "route": "cuda",
        "source": "vpic_tpu_torch/csrc/push_walk.cu",
        "replaces": "vpic_tpu/particles/push_pallas.py:465",
        "launches": launches, "max_abs_err": max_err, "ms": k_ms,
        "plain_ms": p_ms}]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
