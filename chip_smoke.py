#!/usr/bin/env python3
"""Smoke test of vpic_tpu_torch on one NVIDIA GPU: the port's three push
paths on the bench deck at full size, through its hand-written CUDA
kernels (push+walk, sorted deposit, and the merge re-sort's mark, tables
and assembly; the probe kernels of the tools path), the production
turbulence deck and the reconnection
decks (trecon, sigma, turbulence_fan) at full size through the port's
CLI, with their diagnostics, tracer trajectories, readers and restarts,
open particle boundaries (absorbing and custom walls, emitters,
in-step injection) and the collisions deck, materials (conductive,
dielectric and magnetic regions through the field solver, dumps and
checkpoints), several shards in one process on the card (halo
exchanges, shared-face merges and particle migration), the tools path
(the probe kernels and the drift comparison against the float64
reference), and the harness tools (evidence, the scaling sweep at its
seven sizes, the per-op profile), the step as CUDA graphs against
the step op by op, and the open decks (random draws by the threefry
kernel on the card) as CUDA graphs.

    python3 chip_smoke.py

Phases (each raises on failure; the script then exits non-zero and prints
no result line):

1. device   - the card's name and power limit (nvidia-smi);
2. build    - build the CUDA kernels from vpic_tpu_torch/csrc into
              vpic_tpu_torch/_build and print ptxas's registers, shared
              memory and spills per kernel;
3. kernel   - the push+walk kernel against its plain PyTorch version on
              the card, on a small 3D grid (periodic, reflecting and
              absorbing faces, hot and cold lanes) and at the bench shape
              (both voxel-sorted 128^2 species, 2M particles each), for the
              push entry, the walk_only entry and the packed push: voxels,
              pcode and particle floats bitwise equal, the accumulator
              bitwise equal to the plain fixed-point twin at the same scale
              and within 1e-6 * sum|contributions| per voxel of the plain
              float version; on the sorted electrons the walk's (lane,
              segment) pairs and the deposit atomics one per pair and word
              against one per (warp, voxel) group and word; the wrapper
              (CUDA events) and the kernel alone (torch.profiler) timed
              against the plain version and the bound;
4. determinism - two kernel runs from one state are bitwise equal (each
              check of phase 3 runs the kernel twice);
5. slice    - a 16^2 deck agrees with the plain path on the CPU; then the
              128^2, 2 x 2M deck runs 8 warm-up steps and three timed
              windows of 16 steps (two whole sort super-cycles each) with
              finite energies, bounded energy drift, no dropped movers and
              one kernel launch per species per step; the median pushes/s;
              then a torch.profiler trace of 8 more steps splits the busy
              device time between sort, push and field and gives the
              device's idle share;
6. deposit  - the deposit kernel against its plain version on the card:
              segment-1 currents of both sorted 128^2 species and the cases
              of tests/test_deposit_pallas.py (two sorted, one unsorted),
              the accumulator within 1e-6 * sum|contributions| per word
              of the plain version summed in float64 (the float32 one's
              distance logged), bitwise the fixed-point twin, two runs
              bitwise equal; the wrapper and its kernels alone
              timed against the plain version, one index_add_ and the
              bound;
7. merge    - the merge re-sort's kernels against the plain passes of
              particles/sort.py: the seven kernel cases of
              tests/test_sort_pallas.py and the bench shape (2 125 824
              lanes, 5% movers, 50 700 keys), the mark kernel's outputs
              (the sentinels past the movers included), the tables
              bitwise equal on fast and slow blocks and every output row
              on fast ones (the tables and assembly kernels read the
              mover count and the decision from the mark pass's words on
              the card; slow, the assembly writes only the anomaly: the
              full sort is the decision's other branch), key0/ctot equal,
              no anomaly, the fast path where expected, two runs bitwise
              equal; the wrappers and the kernels alone timed against the
              plain passes and the bounds, the assembly against one
              index_copy_ of the same permutation, the eager re-sort
              (device ops, and no host read, per call, and those of a
              re-sort that falls back) against a full sort_p_packed, the
              full sort's order that an eager re-sort also computes, and
              the re-sort captured alone into a CUDA graph, its decision
              as conditional nodes (engine/cond.py), on a kept merge and
              on a fallback: bitwise the eager re-sort, the replay timed
              by CUDA events, its busy ms, ops and host reads (0) from a
              trace, its nodes by type;
8. path A   - the unfused push (fused_push=False): a 16^2 deck against
              the CPU plain path, then a fresh 128^2 deck for 8 warm-up
              and three timed windows of 16 steps: finite energies,
              bounded drift, no dropped movers, energies equal to the
              default path's at the same step to 1e-6, one deposit and one
              walk_only launch per species per step; a profiler trace of 8
              more steps;
9. path B   - the packed cycle with the merge re-sort (merge_sort=True),
              graphed: a 16^2 deck for 16 steps (every sort after a
              species' first merges; a mark launch per sort, a tables and
              an assembly launch per merge kept, which a replay runs in
              the merge's conditional body; energies match the CPU plain
              path); then two fresh
              128^2 decks timed as in phase 8, each with one push launch
              per species per step and its fast and slow sort counts per
              species: the deck's own cadence (electrons sort every 2
              steps, ions every 8; slow expected: their movers exceed the
              reference's mover buffer) and every species sorted every
              step (bench_deck's resort_interval=1, ion_sort_mult=1), where
              the ions' movers fit their buffer and the merge kernels run
              at full size; a trace of each, with the every-step deck's
              step.sort busy ms and device ops per step (the traces'
              steps op by op);
10. determinism - the charge deposit as a float32 index_add_ run twice on
              the 128^2 electrons (the finding: the sums differ), then two
              bench decks built from one seed: checksum_fields equal at
              finalize and after 4 steps (the repair: fixed-point
              deposits), the digests printed;
11. turbulence - vpic_tpu_torch/decks/turbulence.py at its full size
              (64x32x32, 16 per cell, six species, PEC z walls with
              reflected particles, two q = 0 tracer species): the
              fixed-point rho and hydro deposits of every species repeat
              bitwise and stay within 1e-6 * sum|c| of float64; the push
              kernel against its plain version and twin on each species
              (the accumulator within 1e-6 * sum|c| plus each
              contribution's fixed-point rounding of the float version),
              the tracers' accumulator zero at the 2^200 scale, the
              kernel on eT timed against its bound; the CLI in a process
              of its own for 100 steps with standard_diagnostics (energies
              every 10 steps, fields and hydro every 50, particles 100,
              restart 50, tracers 50, spectra 100), then again from its
              step-50 restart: every step-100 dump byte for byte the first
              run's, finite energies, the total within 2e-2 over the first
              10 steps, each species' dropped movers; the deck at 8^3 on
              the card and on the CPU, energies to 1e-6; then in process
              three timed 16-step windows with the launch counts (one
              push launch per species per step and nothing else), a
              trace split by step part, and one call of each diagnostic;
12. reconnection - vpic_tpu_torch/decks/trecon.py (2D x-z 256x128, 64
              per cell, 1024 tagged tracers), sigma.py (the same grid
              with PEC z walls reflecting particles, the 0.6c boosted
              load, two tracer species) and turbulence_fan.py (3D 32^3,
              16 per cell, a pair plasma with initial E fields) at their
              full sizes: the push kernel against its plain version and
              twin on every species (the quantum allowance of phase 11
              only where the float bar cannot be met, the species named),
              the kernel on the electrons timed against its bound; 25
              steps from finalize with finite energies, the total within
              5e-3 (twice the JAX package's own change at the tests' size
              where that is larger) and each species' dropped movers; three
              timed 16-step windows with the launch counts and a trace;
              the readers on the deck's dumps against the state on the
              card and the native particle read against numpy; on trecon
              the trajectories collected every step, written in both
              layouts (and as H5Part where h5py is installed), read back
              and round-tripped through a checkpoint, one
              collect_trajectories call timed; the CLI in
              a process of its own for 50 steps with the deck's dumps on,
              then again from its step-25 checkpoint: every step-50 dump
              and the step-50 energies byte for byte the first run's;
13. open      - the open box of tests/test_boundary_emit.py:drifting_box
              at 256^2, 64 per cell (4 194 304 electrons in 5 242 880
              slots, ut 0.3, drift 0.5 along x, absorbing x faces, y and z
              periodic): first each variant's 16^2 box on the card and on
              the CPU (energies to 1e-6 and equal counts: both draw the
              JAX package's threefry stream); then at full size the
              variants absorb,
              tally (AbsorbTally), reflux (MaxwellianReflux), link
              (LinkBoundary), emitter (ex = -0.1 and a ChildLangmuir
              emitter on the low x face) and injector (a
              user_particle_injection hook refilling the low x cells
              through make_injector with rhob updated), each 25 steps from
              finalize, then three timed 16-step windows with the launch
              counts (one push and num_comm_round walk_only launches per
              step), finite energies and no dropped movers (phase 19
              traces each variant, graphed and op by op); absorbed = tally =
              n0 - alive, the reflux walls lose nothing, the link ring
              counts every hit; the push entry with count_pending=False on
              lanes stopped with NEIGHBOR_ABSORB (absorb) and handler codes
              (tally), and one round's walk_only launch on the reflux
              round's buffer, against their plain versions and twins
              (the quantum allowance where a float word cannot meet the
              bar), both timed against their bounds; absorb again on
              fused_push=False (energies equal the fused run's to 1e-6,
              and a trace split by step part with its host reads);
              the reflux and emitter boxes 10 steps, a checkpoint and 10
              more, against a second build (equal checksum_fields)
              restored and run 10 steps: every array bitwise equal; the
              collisions deck at its defaults and at 256^2 (the hook alone
              keeps sum |u|^2 to 1e-6, the anisotropy falls over 56
              graphed steps; phase 19 times it) and through the CLI for
              50 steps;
14. materials - the material box (the bench deck's plasma, 2D 256^2, 32
              per cell, 2 097 152 electrons and as many ions, with
              tests/test_materials_diag.py:wave_box's fields, copper on
              x > 0.75 and a dielectric of eps (2, 3, 4), mu 1.5 on
              0.25 < y < 0.5): its 32^2 version (8 per cell) on the card
              and on the CPU for 16 steps (ids and coefficient table
              bitwise equal, energies to 1e-6); at full size 25 steps
              with finite energies and no dropped mover, a checkpoint at
              step 10 restored into a second build and run to step 25
              (every array bitwise equal), the rms div E error after the
              interval clean no larger than before it, dump_fields read
              back with the eight id planes equal to the state's; the
              push kernel on both species against its plain version and
              twin (the quantum allowance only where the float bar cannot
              be met, the species named), the electrons timed against the
              bound; three timed 16-step windows (one push launch per
              species per step) and a trace, and the same of the deck
              built with one vacuum material; the particle-free wave box
              at 256^2 for 320 steps, vacuum against copper on x > 0.5:
              the copper run's E energy below 0.75 of vacuum's;
15. shards   - several shards in one process on the one card
              (engine/distributed.py): the bench deck at 128^2 with
              2 x 2 097 152 particles on 2 x 2 shards of 64^2 (capacity
              1.25) beside its one-shard run and a second four-shard run
              from the same seed: the push kernel on every shard's
              species (stopped lanes left to the rounds) and its walk_only
              entry on each shard's first round (the lanes received from
              the neighbor shards) against the plain version and twin;
              25 steps, then the fields over the global box to rtol 2e-4 /
              atol 2e-5 and the energies to 1e-4 of the one-shard run
              (tests/multi_device/test_shard.py's bars), alive counts
              exact, no dropped mover and so no migration overflow left
              after the rounds, the migrated lanes per step, the two
              four-shard runs' checksums equal; three timed 16-step
              windows of each deck with the launch counts (per shard one
              push and three walk_only launches per species per step)
              and the host seconds each shard waits for the others' turns,
              a trace of each; 4 unfused steps on the shards (the deposit
              kernel, held to its plain version on every shard's inputs
              of the first of them) held to the one-shard deck's unfused
              steps from the same step at the same bars, alive counts
              exact; then the turbulence deck at its default size with
              TURB_PZ=2 (its PEC z walls on the outer faces of the two
              shards) through the CLI for 100 steps with its diagnostics
              and again from its step-50 restart: per-rank dumps, every
              step-100 dump of both ranks byte for byte, the hydro dumps'
              shared node plane equal on both ranks, no dropped mover;
16. tools    - the tools' entry points (vpic_tpu_torch.tools:
              probe_batched.main and vpu_layout_probe.main, their launch
              counts zeroed before and read after); each probe kernel of
              csrc/probes.cu at its tool's shapes bitwise its plain
              version and a rerun (the chain at 1024 reps on the tool's
              seven shapes, on ones and on uniform [0, 3)); gather3d and
              deposit2d on random operands within K * 2^-24 * sum|terms|
              of the plain bf16-in, float32-sum version and bitwise
              across a rerun, at the tools' shapes and at two ragged
              shapes of their plan (tools/mma_plan.py: short splits and
              column tiles, 5 to 20 rows); each kernel timed through its
              wrapper (CUDA events) and alone (profiler) against its
              plain version, its bound and, for gather3d, deposit2d and
              stack8, one PyTorch call (torch.einsum on prepared bf16
              operands, an index of the prepared bf16 window), gather3d
              and deposit2d alone over einsum of the same call logged;
              drift_compare.compare at 16^2 with
              16 000 particles over 24 steps and at 128^2 with 65 536
              over 8 (the float64 host reference stepping the same
              deck): |drift_excess| <= 1e-6, every field RMS <= 1e-5 or
              twice the JAX package's own at that size, no dropped
              mover;
17. harness  - the harness tools of vpic_tpu_torch/tools through their
              functions: evidence.main at its defaults (24 steps, 1M
              particles, 128^2) twice on fresh decks, EVIDENCE OK both
              times with equal field and species checksums;
              scaling_bench.sweep over its seven configurations (1M-16M
              particles, 128^2 to 512^2 and 64^3), each deck with one push
              launch per species and step, no dropped mover, finite
              energies and its particle count, two more timed windows and
              a trace split by step part; on the 64^3 deck (4M per
              species, the quantum allowance) and the 256^2 deck with 8M
              per species (8.5M slots; the float bar, the allowance only
              where it cannot be met) the push kernel against its plain
              version and twin and timed against its bound;
              profile_step.main at its defaults (2M, 128^2, 5 steps): sort,
              push and field each with busy device time and
              push_walk_kernel among the listed ops;
18. graphs   - the step as CUDA graphs (engine/graphs.py): the bench deck
              at 128^2 with 2 x 2M and at 256^2 with 2 x 8M, turbulence
              and trecon at full size, each built twice from one seed and
              stepped through advance (graphed: the cleans, the Marder
              passes and path B's fast-or-full decision conditional nodes
              decided on the card) and advance_eager (op by op, the
              host's decisions), and path B at 128^2 at the deck's cadence
              and with every species sorted every step: after 48 steps
              (bench, path B), 56 (turbulence, across its clean at step
              50) and 32 (trecon, across step 25) the same
              checksum_fields, species checksums, energies, dropped movers
              (0), kernel launches (path B's tables and assembly per merge
              kept graphed, per sort op by op) and fast and slow sorts,
              bit for bit; the bench deck's and path
              B's 48 steps six super-cycle replays of one capture (48
              replays of one step graph when path B sorts every step) and
              no eager step; path B's last 8 steps of the window under
              torch.cuda.set_sync_debug_mode("error") graphed and op by
              op, and no host read in its graphed trace; per deck and
              path the wall step over three 16-step windows graphed and
              one op by op, busy device ms, ops, host reads and idle share
              from a trace, the peak memory and each capture's seconds
              and nodes by type;
19. open graphs - the threefry kernel (csrc/threefry.cu) at the 256^2
              collisions deck's 5 242 880 lanes: split and uniform bitwise
              its plain twin on the card and on the CPU, normal within
              NORMAL_ULPS of both, two runs bitwise equal, each output
              timed alone against its bound (bytes written over 3.35 TB/s,
              the hash's int32 operations over INT32_OPS_PER_S); then the
              six open variants at 256^2 and the collisions deck at 32^2
              and 256^2, each built twice from one seed and stepped through
              advance (graphed) and advance_eager: after 32 steps the same
              checksums, energies, random state, books and kernel launches
              (threefry's included) bit for bit, and the same checksums,
              random state and books after the timed windows and the
              trace (about 88 steps), no dropped mover, the
              books balanced (tally = gone, ring = gone, reflux loses
              nothing), no host read in the 8-step trace of the graphed
              step; per deck and path the step (three windows graphed,
              one op by op), busy ms, ops, idle share, peak memory and
              each capture's seconds;
20. shard graphs - the bench deck on 2 x 2 shards and turbulence on 2 z
              shards, each built twice from one seed, graphed (decided
              on the card: turbulence one capture, its cleans, sync and
              Marder passes conditional nodes around both shards' parts)
              and op by op: after 8 and 16 steps, and again after a window
              and the trace (turbulence past its clean at step 50), the
              same checksums over every shard, energies, random state,
              launches, no dropped mover, no host read and no rendezvous
              wait per graphed step; turbulence's clean-step replays
              timed with CUDA events beside plain ones;
              dryrun_multichip(4);
21. on card  - the step decides on the card (engine/cond.py): the
              conditional nodes' route with torch.__version__ and
              torch.version.cuda; vpic_tpu_torch.entry.entry()'s step
              captured once and replayed 16 steps bitwise
              Simulation.advance(16) of the same deck, its graph's nodes
              by type; path B at 128^2 at its cadence and sorting every
              step graphed bitwise op by op across a checkpoint and
              restore; each graphed deck's captures and conditional nodes
              (turbulence: one capture, its cleans conditional nodes).
Where a deck runs as CUDA graphs (every deck whose shards all live on the
one card, path B included), the timed windows of every phase time its
graphed steps;
phases 5 and 8 and the sweep of 17 also time three windows op by op
(advance_eager) and print them beside, and a trace's step parts come from
a second trace of steps taken op by op, since a graph's replay has no
profiler scopes.
The line before the last is the kernels' JSON record: per kernel its
launches on the path that runs it, its launches per step of the default
path, the accumulator's or rows' max abs error against the plain version,
the wrapper's time (``ms``), the kernel's alone (``kernel_ms``), the plain
version's, the bound (the larger of bytes over 3.35 TB/s and float32
operations over 67 TFLOP/s, the H100 SXM's published peaks) and what sets
it, and the one PyTorch call that computes the same function
(``library_ms``, null where there is none); the push kernel's record adds
the same numbers on the turbulence path (``turbulence_*``: its launches
in phase 11's timed windows, its error over the six species, its times
on eT) and on each deck of phase 12 (``trecon_*``, ``sigma_*``,
``turbulence_fan_*``: launches, error, the species that needed the
quantum allowance, the times on the electrons, the step, busy device ms,
device ops, dropped movers and the readers' ms) and on phase 13
(``open_*``: the push launches in the absorb box's timed windows, the
walk_only launches per step, the error over the open checks, the push's
times on the absorb box and the walk_only entry's on the reflux round's
buffer (``open_walk_*``), and per variant its step, busy device ms, ops,
idle share, host reads, counts and launches per step; ``collisions_*``)
and on phase 14 (``materials_*``: launches, error, the species that needed
the quantum allowance, the times on the electrons, the step, busy ms, ops
and idle share, ``step.field``'s busy ms and ops against the one-vacuum
deck's (``materials_vacuum_*``), drift, dropped movers, the rms div E
error around a clean and the damping ratio) and on phase 15
(``shards_*``: the push launches in the four-shard windows, the error
over every shard's checks, the step against the one-shard step, busy
device ms, ops, the host wait for the other shards' turns, migrated lanes
per step, the fields' and energies' distance from the one-shard run;
``shards_walk_*``: the walk_only launches in those windows and the times
of one round's walk on shard 0; the deposit kernel's ``shards_launches``
in the unfused steps, its error over the shards' deposits and the
unfused steps' distance from the one-shard run) and on phase 17
(``sweep_64cube_*``, ``sweep_256sq_8M_*``: error, the species checked
with the quantum allowance, slots and the times on the electrons;
``tools_*_launches``: the push launches of the two evidence runs, of the
sweep's own steps and of the profile).  The six probe
kernels' records (phase 16) carry their launches in the tools' entry
points, 0.0 as their error (bitwise), the chain's per-shape wrapper times
(``shapes_ms``) and, for gather3d and deposit2d, the error on random
operands (``random_max_abs_err``, and over 2^-24 * sum|terms|); their
bounds count the products of gather3d and deposit2d at the bf16 tensor
cores' 989 TFLOP/s, and the chain's five float32 instructions per element
and rep at 67 TFLOP/s.
The last line is {"ok": true, "device": {...}}.  Without a CUDA
device the script exits 2.
"""

import collections
import json
import os
import subprocess
import sys
import time

# the profiler attribution (padded traces retaken where device events are
# lost, busy time as a union of intervals, ops placed in step parts by
# their launch calls, the per-step sums) is the per-op profile tool's
from vpic_tpu_torch.tools.profile_step import (PROFILE_ATTEMPTS, _busy_us,
                                               _step_parts, breakdown,
                                               profiled)

SLICE = dict(nx=128, ny=128, nz=1, npart=2_000_000)
SMALL_DECK = dict(nx=16, ny=16, nz=1, npart=4096)
WARM_STEPS, STEPS, WINDOWS, TRACE_STEPS = 8, 16, 3, 8
DRIFT_LIMIT = 1e-5     # |relative total-energy change| over STEPS

# the kernel cases of tests/test_sort_pallas.py (its m_cap = 256):
# (seed, n, nvk, np_, perturbation kwargs or None, key0 sentinel, rounds)
MERGE_CASES = {
    "perturbed-1.0": (7, 2048, 96, 2048, {}, False, 1),
    "perturbed-0.93": (7, 2048, 96, int(2048 * 0.93), {}, False, 1),
    "sentinel": (3, 2048, 96, 2048, {}, True, 1),
    "mover-overflow": (11, 2048, 96, 2048, dict(frac=0.6), False, 1),
    "sparse-wide-span": (5, 1024, 4096, 300, dict(frac=0.1), False, 1),
    "steady-chain": (23, 2048, 128, 1920, dict(frac=0.04), True, 5),
    "identity": (2, 1024, 64, 1000, None, False, 1),
}
MERGE_M_CAP = 256
# where the merge (not the full sort) runs, round by round: a missing
# snapshot or more than m_cap movers force the full sort
MERGE_EXPECT_FAST = {"perturbed-1.0": [True], "perturbed-0.93": [True],
                     "sentinel": [False], "mover-overflow": [False],
                     "sparse-wide-span": [True],
                     "steady-chain": [False] + [True] * 4,
                     "identity": [True]}
# the cases of tests/test_deposit_pallas.py: (seed, n, nv, sorted)
DEPOSIT_CASES = ((1, 5000, 2000, True), (1, 1024, 130 * 130, True),
                 (2, 4096, 3000, False))


_T0 = time.perf_counter()


def log(msg):
    """Print a line; a phase's heading ("[k/21] ...") gets the seconds
    since the script started."""
    if msg.startswith("["):
        msg += f" (at {time.perf_counter() - _T0:.1f} s)"
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


def abs_deposit(st, neighbor, g, seg_cap, counts=False):
    """sum|contribution| per accumulator word of a walk from WalkState
    ``st``: the scale of the accumulator tolerance; with ``counts`` also
    the number of contributions per word."""
    import torch
    from vpic_tpu_torch.particles import push
    acc = torch.zeros((g.nv, 12), dtype=torch.float64, device=st.x.device)
    num = torch.zeros_like(acc)
    for _ in range(seg_cap):
        if not bool(st.active.any()):
            break
        was = st.active
        st, dep_vox, contrib = push.walk_segment(st, neighbor, g)
        c = torch.stack(contrib, dim=-1).abs().to(torch.float64)
        acc.index_add_(0, dep_vox[was].long(), c[was])
        num.index_add_(0, dep_vox[was].long(), (c[was] != 0).double())
    return (acc, num) if counts else acc


def compare(label, kernel_out, plain_out, kacc, pacc, tacc, absacc, floats,
            ints, floor=0.0):
    """Bitwise particle state, accumulator bitwise equal to the fixed-point
    twin ``tacc`` and within 1e-6*sum|c| (plus ``floor``, per word) of the
    float plain version; returns the accumulator's max abs error against
    the float one."""
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
    if not _bitwise_equal(kacc, tacc):
        bad = int((kacc.view(torch.int32) != tacc.view(torch.int32)).sum())
        raise AssertionError(f"{label}: acc differs from the fixed-point "
                             f"twin in {bad} words")
    err = (kacc.to(torch.float64) - pacc.to(torch.float64)).abs()
    limit = 1e-6 * absacc + floor + 1e-30
    if not bool((err <= limit).all()):
        ratio = err / limit
        w = int(ratio.argmax())
        v, k = divmod(w, 12)
        raise AssertionError(
            f"{label}: acc beyond 1e-6*sum|c| (worst "
            f"{float(ratio.max()):.3g}x the limit, {int((ratio > 1).sum())} "
            f"words; voxel {v} word {k}: kernel {float(kacc.view(-1)[w])!r},"
            f" float plain {float(pacc.view(-1)[w])!r}, sum|c| "
            f"{float(absacc.view(-1)[w])!r})")
    return float(err.max())


def check_rerun(label, first, second, names):
    """Two kernel runs from one state: every output bitwise equal."""
    import torch
    (o1, acc1), (o2, acc2) = first, second
    for name in names:
        if not torch.equal(getattr(o1, name), getattr(o2, name)):
            raise AssertionError(f"{label}: rerun differs in {name}")
    if not _bitwise_equal(acc1, acc2):
        raise AssertionError(f"{label}: rerun acc differs")


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


def check_push(label, sp, interp, nb, g, n_walk, quantum=False,
               count_pending=True):
    """The push entry against the plain push and its fixed-point twin, and
    a rerun; returns the accumulator's max abs error.  ``quantum``: the
    float bound also allows each contribution its fixed-point rounding,
    half of 2^-S (a word whose sum|c| is below about 1e6 2^-S, as the
    slowest lanes of a 3D deck give, cannot meet 1e-6 * sum|c| in fixed
    point).  ``count_pending=False``: the push of an open deck, which
    leaves its stopped and exhausted lanes to the boundary rounds."""
    import torch
    from vpic_tpu_torch.particles import deposit, push, push_cuda
    acc0 = torch.zeros((g.nv, 12), dtype=torch.float32, device=sp.dx.device)
    kw = dict(n_walk=n_walk, count_pending=count_pending)
    run = lambda: push_cuda.advance_p(sp, interp, acc0, nb, g, **kw)
    ko, kacc = run()
    check_rerun(label, (ko, kacc), run(), PUSH_FLOATS + ("i", "pc", "nm"))
    po, pacc = push.advance_p(sp, interp, acc0, nb, g, **kw)
    _, tacc = push.advance_p_fixed(sp, interp, acc0, nb, g, **kw)
    seg_cap = push.segment_cap(n_walk)
    absacc = abs_deposit(push.pushed_walk_state(sp, interp, g), nb, g,
                         seg_cap, counts=quantum)
    floor = 0.0
    if quantum:
        absacc, num = absacc
        floor = num * (0.5 / deposit.fixed_scale(sp.q, seg_cap, sp.max_np))
    err = compare(label, ko, po, kacc, pacc, tacc, absacc, PUSH_FLOATS,
                  ("i", "pc"), floor)
    if not torch.equal(ko.nm, po.nm):
        raise AssertionError(f"{label}: nm {int(ko.nm)} != {int(po.nm)}")
    moved = int((ko.i != sp.i).sum())
    log(f"  {label}: push ok (lanes {int(sp.np)}, changed voxel {moved}, "
        f"pending {int((ko.pc != 0).sum())}, acc max abs err {err:.3g}, "
        "acc bitwise the twin's, rerun bitwise equal)")
    return err


def check_walk(label, st, nb, g, n_iter, quantum=False):
    """The walk_only entry against the plain walk and its fixed-point twin,
    and a rerun; returns the accumulator's max abs error.  ``quantum`` as
    in :func:`check_push`."""
    import torch
    from vpic_tpu_torch.particles import deposit, push, push_cuda
    acc0 = torch.zeros((g.nv, 12), dtype=torch.float32, device=st.x.device)
    run = lambda: push_cuda.streak_walk(st, acc0, nb, g, n_iter)
    ko, kacc = run()
    check_rerun(label, (ko, kacc), run(), push.WalkState._fields)
    po, pacc = push.streak_walk(st, acc0, nb, g, n_iter)
    _, tacc = push.streak_walk_fixed(st, acc0, nb, g, n_iter)
    seg_cap = 4 * n_iter + 8
    absacc = abs_deposit(st, nb, g, seg_cap, counts=quantum)
    floor = 0.0
    if quantum:
        absacc, num = absacc
        floor = num * (0.5 / deposit.fixed_scale(st.q, seg_cap,
                                                 st.x.shape[0]))
    err = compare(label, ko, po, kacc, pacc, tacc, absacc, WALK_FLOATS,
                  ("vox", "pcode", "active"), floor)
    log(f"  {label}: walk_only ok (active {int(st.active.sum())}, "
        f"acc max abs err {err:.3g}, acc bitwise the twin's, rerun bitwise "
        "equal)")
    return err


def check_packed(label, sp, interp, nb, g, n_walk):
    """The packed push (the kernel on PackedSpecies rows) against the plain
    packed push and the twin, and a rerun."""
    import torch
    from vpic_tpu_torch.particles import push, push_cuda
    psp = push.pack_species(sp, g)
    acc0 = torch.zeros((g.nv, 12), dtype=torch.float32, device=sp.dx.device)
    run = lambda: push_cuda.advance_p_packed(psp, interp, acc0, nb, g,
                                             n_walk=n_walk)
    ko, kacc = run()
    check_rerun(label, (ko, kacc), run(), ("pk", "nm"))
    po, pacc = push.advance_p_packed(psp, interp, acc0, nb, g, n_walk=n_walk)
    usp = push.unpack_species(psp, g)
    _, tacc = push.advance_p_fixed(usp, interp, acc0, nb, g, n_walk=n_walk)
    absacc = abs_deposit(push.pushed_walk_state(usp, interp, g), nb, g,
                         push.segment_cap(n_walk))
    err = compare(label, ko, po, kacc, pacc, tacc, absacc, ("pk",), ("nm",))
    log(f"  {label}: packed push ok (acc max abs err {err:.3g}, acc "
        "bitwise the twin's, rerun bitwise equal)")
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
    errs = []
    for name in SMALL_FACES:
        for hot in (False, True):
            g, nb, interp, sp = small_grid_case(name, hot, device)
            label = f"3D 6x5x4 {name} {'hot' if hot else 'cold'}"
            errs.append(check_push(label, sp, interp, nb, g, n_walk=4))
            errs.append(check_walk(label, walk_state_from(
                sp, 5, 1.5 if hot else 0.3), nb, g, 2))
            errs.append(check_packed(label, sp, interp, nb, g, n_walk=4))
    return max(errs)


def walk_counts(sp, interp, nb, g, n_walk, warp=32):
    """From the plain walk of one species: its (lane, segment) pairs; the
    deposit atomics of one atomic per pair and nonzero contribution (the
    kernel before its warp deposit); the atomics of one per nonzero word
    sum of each (warp, voxel) group of a segment, the warps taken by slot
    as the kernel takes them (its warp deposit); and the live lanes by
    segments walked."""
    import torch
    from vpic_tpu_torch.particles import deposit, push
    dev = sp.dx.device
    n = sp.max_np
    seg_cap = push.segment_cap(n_walk)
    scale = deposit.fixed_scale(sp.q, seg_cap, n)
    st = push.pushed_walk_state(sp, interp, g)
    warp_of = torch.arange(n, device=dev) // warp
    segs = torch.zeros(n, dtype=torch.int64, device=dev)
    pairs = before = after = groups = 0
    for _ in range(seg_cap):
        was = st.active
        if not bool(was.any()):
            break
        st, dep_vox, contrib = push.walk_segment(st, nb, g)
        segs += was
        c = torch.stack(contrib, dim=-1)[was]
        words = torch.round(c.to(torch.float64) * scale).to(torch.int64)
        pairs += int(was.sum())
        before += int((c != 0).sum())
        key = warp_of[was] * g.nv + dep_vox[was].long()
        uniq, inv = torch.unique(key, return_inverse=True)
        sums = torch.zeros((uniq.numel(), 12), dtype=torch.int64, device=dev)
        sums.index_add_(0, inv, words)
        groups += uniq.numel()
        after += int((sums != 0).sum())
    hist = torch.bincount(segs[sp.alive]).tolist()
    return dict(pairs=pairs, atomics_before=before, groups=groups,
                atomics_after=after, lanes_by_segments=hist)


def profiled_ms(fn, reps, names, per_run):
    """Under torch.profiler, ``reps`` runs of fn(), each launching
    ``per_run`` kernels whose names contain one of ``names``: their mean
    device time per run, and the device operations per run.  A trace
    that lacks one of those kernels, or more than one other device
    event, is taken again."""
    fn()
    named = lambda dev: [e for e in dev if any(k in e.name for k in names)]
    _, _, dev, _ = profiled(
        lambda: [fn() for _ in range(reps)],
        lambda dev, lost: len(named(dev)) == reps * per_run and len(lost) <= 1)
    us = sum(e.time_range.elapsed_us() for e in named(dev))
    return us / reps / 1e3, len(dev) / reps


HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
FP32_OPS_PER_S = 67e12         # H100 SXM float32 outside the tensor cores


def bound(nbytes, ops):
    """(ms, "bytes" or "operations"): the least time of a function that
    moves ``nbytes`` (each input read once, each output written once) and
    does ``ops`` float32 operations, at the H100's published peaks."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def held_to_bound(label, ms, bound_ms):
    """Fail where a measured time beats its bound: the bound then counts
    work that the timed call does not do."""
    if ms < bound_ms:
        raise AssertionError(f"{label}: {ms:.4f} ms beats its bound "
                             f"{bound_ms:.4f} ms")


# float32 operations counted in csrc/push_walk.cu: push() per live lane,
# segment() (deposit words included) per walked segment
PUSH_OPS, SEGMENT_OPS = 120, 110


def push_bound(n, live, pairs, nv):
    """push_cuda.advance_p on n slots: x, y, z, vox, ux, uy, uz, q read;
    x, y, z, vox, ux, uy, uz, rx, ry, rz, pcode written; the (nv, 18)
    interpolator, the (nv, 6) neighbor table and the (nv, 12) float32
    accumulator read, the accumulator written."""
    nbytes = n * (8 + 11) * 4 + nv * (18 + 6 + 12 + 12) * 4
    return bound(nbytes, PUSH_OPS * live + SEGMENT_OPS * pairs)


def deposit_bound(n, lanes, nv):
    """deposit_cuda.deposit_sorted_into on n lanes: 12 contribution
    columns, vox and the valid flag read; the accumulator read and
    written; 12 additions per valid lane."""
    return bound(n * (12 * 4 + 4 + 1) + 2 * nv * 12 * 4, 12 * lanes)


def mark_bound(n, n_m, m_cap, tiles):
    """sort_cuda.mark on an (8, n) block with n_m movers: row 7 and key0
    read per lane; the first m_cap movers' lane, key and old key and each
    tile's residual prefix written."""
    return bound(n * 8 + min(n_m, m_cap) * 12 + tiles * 4, 0)


def tables_bound(n_m, nvk):
    """The tables kernel (launched by sort_cuda.assemble): the movers'
    sorted new and old keys and ctot read, the three (nvk + 3) tables
    written."""
    return bound(n_m * 8 + 4 * (nvk + 3) * 4, 0)


def merge_bound(n, n_m, nvk, tiles):
    """The assembly kernel on an (8, n) block with n_m movers: the 8 rows
    and key0 read and written per lane; per mover its sorted key, its
    mark slot (int64) and its lane; the two (nvk + 3) count tables and the
    tiles' residual prefixes and first keys."""
    return bound(n * (36 + 36) + n_m * (4 + 8 + 4) + 2 * (nvk + 3) * 4
                 + tiles * 8, 0)


def time_push(label, sp, interp, nb, g, n_walk, pairs):
    """The push kernel on ``sp`` (with ``pairs`` (lane, segment) pairs in
    its walk): the wrapper (CUDA events), the kernel alone (profiler) and
    the plain version, against the bound.  Returns the timing dict."""
    import torch
    from vpic_tpu_torch.particles import push, push_cuda
    live = int(sp.alive.sum())
    acc0 = torch.zeros((g.nv, 12), dtype=torch.float32, device=sp.dx.device)
    run_k = lambda: push_cuda.advance_p(sp, interp, acc0, nb, g,
                                        n_walk=n_walk)
    run_p = lambda: push.advance_p(sp, interp, acc0, nb, g, n_walk=n_walk)
    p1, k1, k2, p2 = (cuda_ms(run_p, 5), cuda_ms(run_k, 20),
                      cuda_ms(run_k, 20), cuda_ms(run_p, 5))
    kernel_ms, ops = profiled_ms(run_k, 20, ("push_walk_kernel",), 1)
    bound_ms, bound_by = push_bound(sp.max_np, live, pairs, g.nv)
    held_to_bound(f"{label}: the push kernel alone", kernel_ms, bound_ms)
    log(f"  timing, {label} ({live} lanes in {sp.max_np} slots): wrapper "
        f"{k1:.4f} / {k2:.4f} ms ({ops:.1f} device ops per call), kernel "
        f"alone {kernel_ms:.4f} ms, plain {p1:.4f} / {p2:.4f} ms; bound "
        f"{bound_ms:.4f} ms ({bound_by}), the kernel at "
        f"{bound_ms / kernel_ms:.4f} of it")
    return dict(ms=min(k1, k2), kernel_ms=kernel_ms, plain_ms=min(p1, p2),
                bound_ms=bound_ms, bound_by=bound_by)


def phase_kernel_slice(sim):
    """The bench shape: both species of the 128^2 deck after finalize,
    voxel-sorted as the step sorts them before its first push, through
    the push entry, the walk_only entry and the packed push (each against
    the plain version and its fixed-point twin, with a rerun); then, on
    the sorted electrons, the walk's counts and the timing of the wrapper
    (CUDA events), of the kernel alone (profiler) and of the plain
    version.  Returns (max abs err, timing dict)."""
    from vpic_tpu_torch.engine.step import walk_segments
    from vpic_tpu_torch.particles import aux
    st, g = sim.state, sim.grid
    nb, interp = st.grid_arrays.neighbor, st.interpolator
    n_walk = walk_segments(g, sim.opts)
    errs = []
    species = [aux.sort_p(sp) for sp in st.species]
    for sp in species:
        label = f"128^2 {sp.name}"
        errs.append(check_push(label, sp, interp, nb, g, n_walk))
        errs.append(check_walk(label, walk_state_from(sp, 3, 0.6), nb, g,
                               n_walk - 1))
        errs.append(check_packed(label, sp, interp, nb, g, n_walk))

    sp = species[0]
    live = int(sp.alive.sum())
    c = walk_counts(sp, interp, nb, g, n_walk)
    log(f"  walk of the sorted electrons (plain, {live} live lanes): "
        f"{c['pairs']} (lane, segment) pairs, {c['pairs'] / live:.6f} "
        f"segments per lane, live lanes by segments walked "
        f"{c['lanes_by_segments']}; deposit atomics: one per pair and "
        f"nonzero word {c['atomics_before']}, one per (warp, voxel) group "
        f"and nonzero word sum {c['atomics_after']} ({c['groups']} groups; "
        f"{c['atomics_before'] / c['atomics_after']:.4f}x fewer)")
    t = time_push("128^2 sorted electrons", sp, interp, nb, g, n_walk,
                  c["pairs"])
    return max(errs), dict(t, library_ms=None)


def phase_small_deck(device, **opts):
    """A 16^2 deck on the card (kernels) against the same deck on the CPU
    (plain path, which the CPU tests hold to the JAX package), both on the
    push path that ``opts`` (StepOptions fields) selects."""
    from vpic_tpu_torch.decks import bench_deck
    deck = dict(nx=16, ny=16, nz=1, npart=4096)
    gpu = bench_deck.build(**deck, device=device)
    cpu = bench_deck.build(**deck, device="cpu")
    if opts:
        gpu.modify_runparams(**opts)
        cpu.modify_runparams(**opts)
    gpu.advance_steps(8)
    cpu.advance_steps(8)
    eg, ec = gpu.energies(), cpu.energies()
    for k in ec:
        if abs(eg[k] - ec[k]) > 1e-6 * abs(ec[k]) + 1e-12:
            raise AssertionError(f"16^2 deck: energy {k} {eg[k]!r} vs "
                                 f"CPU {ec[k]!r}")
    log(f"  16^2 deck{' ' + str(opts) if opts else ''}, 8 steps: card "
        f"energies match the CPU plain path to 1e-6 relative ({len(ec)} "
        "energies)")


def phase_slice(sim):
    """The main path: advance the 128^2 deck through the Simulation API,
    WINDOWS timed windows of STEPS steps, each from a sort super-cycle
    boundary; returns (the launches of each kernel in those steps,
    median pushes/s, median step s)."""
    import math
    import statistics
    import torch
    from vpic_tpu_torch.particles import deposit_cuda, push_cuda, sort_cuda
    sim.advance_steps(WARM_STEPS)
    torch.cuda.synchronize()
    nsp = len(sim.state.species)
    n_total = sum(int(sp.np) for sp in sim.state.species)
    for mod in (push_cuda, deposit_cuda, sort_cuda):
        mod.reset_launch_counts()
    step_s = []
    for w in range(WINDOWS):
        if sim.step_count % (sim.opts.resort_interval * 4):
            raise AssertionError("a timed window must start on a "
                                 "super-cycle")
        e0, nm0 = sim.energies(), sim.mover_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sim.advance_steps(STEPS)
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
    launches = dict(push_walk=push_cuda.launches["push"],
                    deposit_sorted=deposit_cuda.launches["deposit_sorted"],
                    **sort_cuda.launches)
    if launches["push_walk"] != WINDOWS * STEPS * nsp:
        raise AssertionError(f"kernel launches {launches} != steps x "
                             f"species = {WINDOWS * STEPS * nsp}")
    med = statistics.median(step_s)
    log(f"  {n_total} particles, {WINDOWS * STEPS} steps: median "
        f"{med * 1e3:.4f} ms/step (min {min(step_s) * 1e3:.4f}, max "
        f"{max(step_s) * 1e3:.4f}), kernel launches {launches}; "
        f"{'graphed' if sim.graphed else 'eager'} path, dispatch "
        f"{dict(sim.dispatch_counts)}")
    eager_windows(sim, "main path", med)
    return launches, n_total / med, med


def eager_windows(sim, label, step_s):
    """WINDOWS windows of STEPS steps taken op by op
    (``sim.advance_eager``), each timed on the host clock as the windows
    of ``sim.advance`` are, logged beside that path's median
    ``step_s``."""
    import statistics
    import torch
    out = []
    for _ in range(WINDOWS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sim.advance_eager(STEPS)
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) / STEPS)
    med = statistics.median(out)
    log(f"  {label} op by op (advance_eager), {WINDOWS} windows of {STEPS} "
        f"steps: median {med * 1e3:.4f} ms/step (min {min(out) * 1e3:.4f}, "
        f"max {max(out) * 1e3:.4f}) beside {step_s * 1e3:.4f} ms/step "
        f"through advance ({'graphed' if sim.graphed else 'eager'})")


def _trace(sim, advance, steps=TRACE_STEPS):
    """A torch.profiler trace of ``steps`` steps of ``advance`` (the
    deck's own ``sim.advance`` or ``sim.advance_eager``): (host-clock us,
    device events, how many were placed with their launch call, runtime
    calls without a device event, the per-step breakdown)."""
    # a trace taken again starts one super-cycle later; one runtime call
    # per step may lack its device event (it did in some traces)
    wall_us, events, dev, lost = profiled(
        lambda: advance(steps), lambda dev, lost: len(lost) <= steps)
    parts, placed = _step_parts(events, dev)
    return wall_us, dev, placed, lost, breakdown(dev, parts, steps)


def phase_trace(sim, step_s, label="main path", parts=None):
    """torch.profiler traces of TRACE_STEPS steps each (one sort
    super-cycle): per step, the device busy time (union of kernel and copy
    intervals), the device operations, the busy device time of each step
    part and of the busiest kernels; the idle share under the profiler,
    and, given the unprofiled step time ``step_s``, the one derived from
    the busy time.  Where the deck runs as CUDA graphs (``sim.graphed``)
    the busy time, ops, host reads and idle share are those of its
    graphed steps (the graphs' nodes, one cudaGraphLaunch per replay), and
    the step parts come from a second trace of steps taken op by op
    (``sim.advance_eager``; not taken where ``parts`` is empty): the
    step's scopes do not exist inside a replay.  Returns per step the
    busy device ms (``busy_ms``), the device ops (``ops``), the host
    reads (``reads``: device-to-host copies) and, for each step part,
    both (``parts``).  Every part of ``parts``
    (default: sort, push and field) must have busy time."""
    from vpic_tpu_torch.engine.step import CORE_PHASES, PHASES
    parts_needed = CORE_PHASES if parts is None else parts
    if sim.step_count % (sim.opts.resort_interval * 4):
        raise AssertionError("traced window must start on a super-cycle")
    # a state read since the last advance goes into the graphs' buffers
    # here, not inside the trace
    sim.advance_steps(0)
    wall_us, dev, placed, lost, b = _trace(sim, sim.advance_steps)
    busy = b["busy_ms"]
    reads = sum("DtoH" in e.name for e in dev) / TRACE_STEPS
    what = "graphed steps" if sim.graphed else "steps"
    log(f"  trace of the {label}, {TRACE_STEPS} {what} under "
        f"torch.profiler: device busy "
        f"{busy:.4f} ms/step, device ops {b['ops']:.1f}"
        f"/step ({placed} of {len(dev)} with their launch call; {lost} "
        f"runtime calls without a device event), host reads {reads:.1f}"
        f"/step, wall {wall_us / TRACE_STEPS / 1e3:.4f} ms/step, idle share "
        f"{1 - busy * TRACE_STEPS * 1e3 / wall_us:.4f}")
    if step_s is not None:
        log(f"  derived idle share without the profiler: 1 - busy / step = "
            f"1 - {busy:.4f} / {step_s * 1e3:.4f} = "
            f"{1 - busy / (step_s * 1e3):.4f}")
    eb = b
    if sim.graphed and parts_needed:
        sim.states      # the copy out of the graphs' buffers, not traced
        ewall_us, edev, _, elost, eb = _trace(sim, sim.advance_eager)
        log(f"  the step parts from a trace of {TRACE_STEPS} steps op by op "
            f"(advance_eager; a graph's replay has no scopes): device busy "
            f"{eb['busy_ms']:.4f} ms/step, {eb['ops']:.1f} ops/step, wall "
            f"{ewall_us / TRACE_STEPS / 1e3:.4f} ms/step, {elost} runtime "
            "calls without a device event")
    part_busy, part_ops = eb["parts"], eb["part_ops"]
    log("  busy device ms/step (device ops/step) by step part: " + ", ".join(
        f"{k} {part_busy[k]:.4f} ({part_ops[k]:.1f})"
        for k in PHASES if part_ops[k] or k in parts_needed)
        + f", outside the parts {part_busy[None]:.4f} "
        f"({part_ops[None]:.1f})")
    log("  busiest kernels, device ms/step: " + "; ".join(
        f"{name[:60]} {ms / TRACE_STEPS:.4f}" for name, ms in sorted(
            b["op_ms"].items(), key=lambda kv: -kv[1])[:6]))
    if not all(part_busy[k] > 0 for k in parts_needed):
        raise AssertionError(f"the trace attributes no device time to a "
                             f"step part: {part_busy}")
    return dict(busy_ms=busy, ops=b["ops"], reads=reads,
                parts={k: dict(busy_ms=part_busy[k], ops=part_ops[k])
                       for k in PHASES})


def deposit_twin(acc0, vox, cols, valid, nv):
    """The deposit kernel's result computed plainly: its scale 2^S
    (deposit_scale_kernel: 2^(62 - e) with max|c| over the valid lanes
    times n below 2^e) and its fixed-point sums (``deposit.deposit_fixed``,
    ``deposit.unfix``).  Returns (acc, 2^S)."""
    import torch
    from vpic_tpu_torch.particles import deposit
    c = torch.stack(cols, dim=-1).abs()
    m = float(torch.where(valid[:, None], c, 0.0).max())
    b = torch.tensor(m, dtype=torch.float64) * float(vox.shape[0])
    scale = 1.0
    if 0.0 < float(b) < float("inf"):
        scale = 2.0 ** (62 - int(torch.frexp(b).exponent))
    fix = torch.zeros((nv, 12), dtype=torch.int64, device=vox.device)
    fix, _ = deposit.deposit_fixed(scale)(fix, vox, cols, valid, nv)
    return deposit.unfix(acc0, fix, scale), scale


def check_deposit(label, acc0, vox, cols, valid, nv, quantum=False):
    """The deposit kernel against its plain version summed in float64:
    acc within 1e-6 * sum|c| per word, bitwise its fixed-point twin, two
    kernel runs bitwise equal, no lane dropped; returns the max abs error.
    The plain version's float32 ``index_add`` is off the exact sums by its
    own roundoff, which past about a hundred lanes per word can exceed
    1e-6 * sum|c| (the sharded bench deck's ions); its distance is logged.
    ``quantum``: the bound also allows each contribution its fixed-point
    rounding, half of 2^-S, as check_push's does (a word whose sum|c| is
    below about 1e6 2^-S cannot meet 1e-6 * sum|c| in fixed point)."""
    import torch
    from vpic_tpu_torch.particles import deposit, deposit_cuda
    k1, d1 = deposit_cuda.deposit_sorted_into(acc0, vox, cols, valid, nv)
    k2, d2 = deposit_cuda.deposit_sorted_into(acc0, vox, cols, valid, nv)
    t, scale = deposit_twin(acc0, vox, cols, valid, nv)
    if not torch.equal(k1, k2):
        raise AssertionError(f"{label}: two deposit runs differ")
    if int(d1) != 0 or int(d2) != 0:
        raise AssertionError(f"{label}: the deposit dropped {int(d1)} lanes")
    if not _bitwise_equal(k1, t):
        raise AssertionError(f"{label}: the deposit differs from its "
                             "fixed-point twin")
    f64 = lambda x: x.to(torch.float64)
    exact, _ = deposit.deposit_sorted_into(f64(acc0), vox,
                                           [f64(c) for c in cols], valid, nv)
    p, _ = deposit.deposit_sorted_into(acc0, vox, cols, valid, nv)
    c = f64(torch.stack(cols, dim=-1).abs())
    absacc = torch.zeros((nv, 12), dtype=torch.float64, device=vox.device)
    absacc.index_add_(0, vox[valid].long(), c[valid])
    floor = 0.0
    if quantum:
        num = torch.zeros_like(absacc).index_add_(
            0, vox[valid].long(), (c[valid] != 0).to(torch.float64))
        floor = num * (0.5 / scale)
    err = (f64(k1) - exact).abs()
    limit = 1e-6 * absacc + floor + 1e-30
    plain_rel = float(((f64(p) - exact).abs() / (absacc + 1e-30)).max())
    if not bool((err <= limit).all()):
        worst = float((err / limit).max())
        raise AssertionError(f"{label}: acc beyond 1e-6*sum|c|"
                             + (" + half a quantum per contribution"
                                if quantum else "")
                             + f" of the float64 sums (worst {worst:.3g}x "
                             "the limit)")
    log(f"  {label}: deposit ok ({int(valid.sum())} lanes, two runs "
        f"bitwise equal, bitwise the fixed-point twin, acc max abs err "
        f"{float(err.max()):.3g}, at most "
        f"{float((err / (absacc + 1e-30)).max()):.3g} sum|c|; the float32 "
        f"plain version at most {plain_rel:.3g} sum|c|"
        + (f", 2^-S {1 / scale:.3g}" if quantum else "") + ")")
    return float(err.max())


def segment1_currents(sp, interp, nb, g):
    """Segment 1's deposit voxels, contribution columns and lane mask of a
    species, as the unfused push hands them to the deposit."""
    from vpic_tpu_torch.particles import push
    st = push.pushed_walk_state(sp, interp, g)
    _, vox, cols = push.walk_segment(st, nb, g)
    return vox, cols, sp.alive


def deposit_case(case, device):
    """check_deposit's arguments for one of DEPOSIT_CASES."""
    import numpy as np
    import torch
    seed, n, nv, is_sorted = case
    rng = np.random.default_rng(seed)
    vox = rng.integers(1, nv - 5, n)
    vox = (np.sort(vox) if is_sorted else vox).astype(np.int32)
    c = rng.normal(size=(n, 12)).astype(np.float32)
    return (f"{'sorted' if is_sorted else 'unsorted'} n={n} nv={nv}",
            torch.zeros((nv, 12), dtype=torch.float32, device=device),
            torch.as_tensor(vox, device=device),
            torch.as_tensor(c.T.copy(), device=device).unbind(0),
            torch.ones(n, dtype=torch.bool, device=device), nv)


def phase_deposit(sim, device):
    """Returns (max abs err, timing dict) at the bench shape: the wrapper
    (CUDA events), its kernels alone (profiler), the plain version and one
    ``index_add_`` of the valid lanes' (n, 12) contributions at their
    voxels, prepared beforehand."""
    import torch
    from vpic_tpu_torch.particles import aux, deposit, deposit_cuda
    st, g = sim.state, sim.grid
    nb = st.grid_arrays.neighbor
    errs = []
    acc0 = torch.zeros((g.nv, 12), dtype=torch.float32, device=device)
    bench = None
    for sp in st.species:
        args = segment1_currents(aux.sort_p(sp), st.interpolator, nb, g)
        errs.append(check_deposit(f"128^2 {sp.name} segment 1", acc0,
                                  *args, g.nv))
        bench = bench or args
    for case in DEPOSIT_CASES:
        errs.append(check_deposit(*deposit_case(case, device)))
    vox, cols, valid = bench
    lib_vox = vox[valid].long()
    lib_c = torch.stack(cols, dim=-1)[valid]
    lib_acc = acc0.clone()
    run_k = lambda: deposit_cuda.deposit_sorted_into(acc0, *bench, g.nv)
    run_p = lambda: deposit.deposit_sorted_into(acc0, *bench, g.nv)
    run_l = lambda: lib_acc.index_add_(0, lib_vox, lib_c)
    p1, k1, l1, k2, l2, p2 = (cuda_ms(run_p, 20), cuda_ms(run_k, 20),
                              cuda_ms(run_l, 20), cuda_ms(run_k, 20),
                              cuda_ms(run_l, 20), cuda_ms(run_p, 20))
    kernel_ms, ops = profiled_ms(run_k, 20, ("deposit_",), 3)
    lanes = int(valid.sum())
    bound_ms, bound_by = deposit_bound(vox.numel(), lanes, g.nv)
    held_to_bound("the deposit kernels alone", kernel_ms, bound_ms)
    log(f"  timing, 128^2 sorted electrons' segment 1 ({vox.numel()} "
        f"lanes, {lanes} valid): wrapper {k1:.4f} / {k2:.4f} ms ({ops:.1f} "
        f"device ops per call), its kernels alone {kernel_ms:.4f} ms, plain "
        f"{p1:.4f} / {p2:.4f} ms, index_add_ {l1:.4f} / {l2:.4f} ms; bound "
        f"{bound_ms:.4f} ms ({bound_by})")
    return max(errs), dict(ms=min(k1, k2), kernel_ms=kernel_ms,
                           plain_ms=min(p1, p2), bound_ms=bound_ms,
                           bound_by=bound_by, library_ms=min(l1, l2))


def _mk_sorted(rng, n, np_, nvk):
    """A freshly sorted packed block and its key0/ctot carry
    (tests/test_sort_pallas.py:_mk_sorted)."""
    import numpy as np
    key = np.sort(rng.integers(0, nvk, size=np_)).astype(np.int32)
    pk = np.zeros((8, n), np.float32)
    pk[:7, :np_] = rng.standard_normal((7, np_)).astype(np.float32)
    pk[7, :np_] = key.astype(np.float32)
    key0 = np.full((n,), nvk, np.int32)
    key0[:np_] = key
    full = np.concatenate([key, np.full((n - np_,), nvk, np.int32)])
    ctot = np.searchsorted(full, np.arange(nvk + 3), side="left")
    return pk, key0, ctot.astype(np.int32)


def _perturb(rng, pk, np_, nvk, frac=0.03, far_frac=0.002,
             strides=(-8, -1, 1, 8)):
    """Move a fraction of live lanes by a stride and a few to far keys
    (tests/test_sort_pallas.py:_perturb)."""
    import numpy as np
    pk = pk.copy()
    k = pk[7, :np_].astype(np.int32)
    m = rng.random(np_) < frac
    k2 = np.where(m, (k + rng.choice(strides, size=np_)) % nvk, k)
    far = rng.random(np_) < far_frac
    k2 = np.where(far, rng.integers(0, nvk, size=np_), k2)
    pk[7, :np_] = k2.astype(np.float32)
    return pk


def _bitwise_equal(a, b):
    import torch
    return a.shape == b.shape and torch.equal(a.view(torch.int32),
                                              b.view(torch.int32))


def check_merge_kernels(label, pk, np_, key0, ctot, nvk, m_cap):
    """Each merge kernel against its plain version on one block: the mark
    pass (tile prefixes, counts, every mover slot, the sentinels past the
    movers included), then the tables and the assembly on the plain
    passes' marks and plan, and the assembly in its gather mode on the
    full sort's order, which read the mover count and the decision from
    the marks' ``info`` on the device: the tables and no anomaly always;
    where fast the merge, where slow the full sort's gather (every row,
    key0), each written only where the decision is its own.  Returns the
    plain decision, n_m (read here, by the check) and the mark kernel's
    max abs difference from the plain pass."""
    import torch
    from vpic_tpu_torch.particles import sort, sort_cuda
    km = sort_cuda.mark(pk, np_, key0, ctot, nvk, m_cap)
    pm = sort.mark(pk, np_, key0, ctot, nvk, m_cap)
    fast = bool(sort.fast_path(pm.info, m_cap))
    n_m = int(pm.info[0])
    mark_err = 0
    for name in pm._fields:
        a, b = getattr(km, name), getattr(pm, name)
        if a.numel():
            mark_err = max(mark_err, int((a.long() - b.long()).abs().max()))
        if not torch.equal(a, b):
            raise AssertionError(f"{label}: mark kernel's {name} differs "
                                 f"from the plain pass in "
                                 f"{int((a != b).sum())} entries")
    plan, full = sort.merge_plan(pm), sort.full_order(pk, np_, nvk)
    ko = sort_cuda.assemble(pk, np_, key0, ctot, pm, plan, nvk, m_cap)
    po = sort.assemble(pk, np_, key0, ctot, pm, plan, nvk, m_cap)
    kg = sort_cuda.gather(pk, np_, full, nvk, pm.info, m_cap)
    pg = sort.gather(pk, np_, full, nvk, pm.info, m_cap)
    # the mode whose decision it is: the merge where fast, else the gather
    k_rows, k_key0 = (ko.pk, ko.key0) if fast else kg[:2]
    p_rows, p_key0 = (po.pk, po.key0) if fast else pg[:2]
    if not _bitwise_equal(k_rows, p_rows):
        bad = int((k_rows.view(torch.int32) != p_rows.view(torch.int32))
                  .any(0).sum())
        raise AssertionError(f"{label}: {bad} lanes of the assembly kernel "
                             f"differ from the plain pass (fast {fast})")
    if not torch.equal(k_key0, p_key0):
        raise AssertionError(f"{label}: the kernels' key0 differs "
                             f"(fast {fast})")
    if int(kg[2]) or int(pg[2]):
        raise AssertionError(f"{label}: gather anomaly {int(kg[2])}")
    for name in ("cum_res", "cum_mov", "cum_tot"):
        if not torch.equal(getattr(ko, name), getattr(po, name)):
            raise AssertionError(f"{label}: the kernels' {name} differs "
                                 f"(fast {fast})")
    if int(ko.anomaly) or int(po.anomaly):
        raise AssertionError(f"{label}: assembly anomaly "
                             f"{int(ko.anomaly)}/{int(po.anomaly)}")
    return fast, n_m, mark_err


def check_merge(label, pk, np_, key0, ctot, nvk, m_cap, expect_fast):
    """Each merge kernel against its plain version (check_merge_kernels),
    then the merge re-sort with the kernels against the plain one on one
    block: every row bitwise equal, key0/ctot equal, no anomaly, the fast
    path as expected, the live keys sorted, each row's values kept, and a
    second run bitwise equal.  Returns the kernel's (pk, key0, ctot), the
    max abs difference of its rows from the plain ones and that of the
    mark kernel from the plain pass."""
    import torch
    from vpic_tpu_torch.particles import sort, sort_cuda
    fast, _, mark_err = check_merge_kernels(label, pk, np_, key0, ctot, nvk,
                                            m_cap)
    k = sort_cuda.merge_sort_packed(pk, np_, key0, ctot, nvk, m_cap)
    k2 = sort_cuda.merge_sort_packed(pk, np_, key0, ctot, nvk, m_cap)
    p = sort.merge_sort_packed(pk, np_, key0, ctot, nvk, m_cap)
    if not bool(k.fast) == bool(p.fast) == fast == expect_fast:
        raise AssertionError(f"{label}: fast path {bool(k.fast)}/"
                             f"{bool(p.fast)}, expected {expect_fast}")
    if not (_bitwise_equal(k[0], k2[0]) and all(
            torch.equal(k[i], k2[i]) for i in (1, 2, 3))):
        raise AssertionError(f"{label}: two merge re-sorts differ")
    if not _bitwise_equal(k[0], p[0]):
        bad = int((k[0].view(torch.int32) != p[0].view(torch.int32))
                  .any(0).sum())
        raise AssertionError(f"{label}: {bad} lanes differ from the plain "
                             "merge re-sort")
    if not (torch.equal(k[1], p[1]) and torch.equal(k[2], p[2])):
        raise AssertionError(f"{label}: key0/ctot differ")
    if int(k[3]) or int(p[3]):
        raise AssertionError(f"{label}: anomaly {int(k[3])}/{int(p[3])}")
    n_live = int(np_)
    keys = k[0][7, :n_live]
    if n_live > 1 and not bool((keys[1:] >= keys[:-1]).all()):
        raise AssertionError(f"{label}: live keys not sorted")
    if bool(k[0][:, n_live:].any()):
        raise AssertionError(f"{label}: dead tail not zero")
    for r in range(7):
        if not torch.equal(torch.sort(k[0][r, :n_live]).values,
                           torch.sort(pk[r, :n_live]).values):
            raise AssertionError(f"{label}: row {r} lost values")
    err = float((k[0].to(torch.float64) - p[0].to(torch.float64)).abs().max())
    return k[0], k[1], k[2], err, mark_err


def run_merge_case(name, device):
    """check_merge on every round of one of MERGE_CASES, each round's
    input perturbed from the last one's output; returns the max abs
    errors of the merge re-sort's rows and of the mark pass."""
    import numpy as np
    import torch
    t = lambda a: torch.as_tensor(a, device=device)
    seed, n, nvk, np_, perturb, sentinel, rounds = MERGE_CASES[name]
    rng = np.random.default_rng(seed)
    pk, key0, ctot = _mk_sorted(rng, n, np_, nvk)
    if sentinel:
        key0[0] = -1
    pk, key0, ctot = t(pk), t(key0), t(ctot)
    npt = torch.tensor(np_, dtype=torch.int32, device=device)
    errs = []
    for r, fast in enumerate(MERGE_EXPECT_FAST[name]):
        pk_in = pk if perturb is None else t(_perturb(
            rng, pk.cpu().numpy(), np_, nvk, **perturb))
        pk, key0, ctot, *err = check_merge(f"{name} round {r}", pk_in, npt,
                                           key0, ctot, nvk, MERGE_M_CAP, fast)
        errs.append(err)
    log(f"  {name}: merge kernels ok ({rounds} round(s), n={n}, np={np_}, "
        f"nvk={nvk}, fast {MERGE_EXPECT_FAST[name]}; each kernel bitwise "
        "its plain pass's, two runs bitwise equal)")
    return tuple(max(e) for e in zip(*errs))


def bench_merge_block(g, device, n=2_125_824):
    """The bench shape of the merge re-sort (n = one 128^2 species'
    slots), 98 % live, 5 % movers by +-1 and +-(nx+2) voxels
    (tools/sort_bench.py), the port's key space: (pk, np, key0, ctot,
    nvk, m_cap)."""
    import numpy as np
    import torch
    from vpic_tpu_torch.particles import sort
    t = lambda a: torch.as_tensor(a, device=device)
    nvk = g.nv
    np_ = int(n * 0.98)
    rng = np.random.default_rng(0)
    pk, key0, ctot = _mk_sorted(rng, n, np_, nvk)
    pk = _perturb(rng, pk, np_, nvk, frac=0.05, far_frac=0.0,
                  strides=(-g.nxg, -1, 1, g.nxg))
    return (t(pk), torch.tensor(np_, dtype=torch.int32, device=device),
            t(key0), t(ctot), nvk, sort.mover_capacity(n, 2))


def call_profile(fn, merge_kernels=0, reps=10):
    """Under torch.profiler, ``reps`` calls of fn(), each launching
    ``merge_kernels`` kernels named ``merge_*`` (traced again until they
    are all there and at most one runtime call lacks its device event):
    per call the device time of those kernels (``kernel_ms``), the device
    busy time (``busy_ms``, the union of all device ops), the sum of
    their device times (``device_ms``), the device ops, the host reads
    (device to host copies) and the device ops by name.  ``merge_kernels``
    None: any number of them (a graph's replay, whose conditional bodies'
    kernels the trace may not show; ``merge_seen`` counts those it
    shows)."""
    fn()
    merge = lambda dev: [e for e in dev if "merge_" in e.name]
    _, _, dev, _ = profiled(
        lambda: [fn() for _ in range(reps)],
        lambda dev, lost: ((merge_kernels is None
                            or len(merge(dev)) == merge_kernels * reps)
                           and len(lost) <= 1))
    names = collections.Counter(e.name[:48] for e in dev)
    return dict(
        kernel_ms=sum(e.time_range.elapsed_us() for e in merge(dev))
        / reps / 1e3,
        device_ms=sum(e.time_range.elapsed_us() for e in dev) / reps / 1e3,
        busy_ms=_busy_us([(e.time_range.start, e.time_range.end)
                          for e in dev]) / reps / 1e3,
        ops=len(dev) / reps,
        reads=sum("DtoH" in e.name for e in dev) / reps,
        merge_seen=len(merge(dev)) / reps,
        names={k: v / reps for k, v in names.most_common()})


def entry_replayed(device, steps):
    """``vpic_tpu_torch.entry.entry()``'s step captured once into a CUDA
    graph (``engine/graphs.GraphRunner``, one unit of one step under one
    key) and replayed ``steps`` times from the deck's state: (the state
    after them, the runner's dispatch counts, the top-level nodes of the
    graph by type)."""
    from vpic_tpu_torch.engine import graphs
    from vpic_tpu_torch.entry import entry
    fn, (state,) = entry(device)
    counts, captures = collections.Counter(), []
    runner = graphs.GraphRunner(device, counts, captures)
    runner.load(state)
    for t in range(steps):
        runner.run("step", (), t, 1, lambda st, start, n: fn(st))
    graph, _ = runner.graphs[()]
    return (graphs.clone_state(runner.static), dict(counts),
            graphs.node_types(graph.raw_cuda_graph()))


def states_equal(a, b) -> bool:
    """Every tensor of two states bitwise equal (floats by their bits)."""
    import torch
    from vpic_tpu_torch.engine import graphs
    ints = {torch.float32: torch.int32, torch.float64: torch.int64}
    bits = lambda t: t.view(ints.get(t.dtype, t.dtype))
    la, lb = graphs._leaves(a), graphs._leaves(b)
    return len(la) == len(lb) and all(
        x.shape == y.shape and x.dtype == y.dtype
        and torch.equal(bits(x), bits(y)) for x, y in zip(la, lb))


def captured_resort(label, args, merge_kernels):
    """The merge re-sort on one block captured alone into a CUDA graph
    (after a warm-up on the capture stream), its fast-or-full decision as
    conditional nodes (engine/cond.py): a replay bitwise the eager
    re-sort, the replay's ms from CUDA events (20 replays, twice), and
    from a trace of 10 replays its device busy ms, ops and host reads,
    with ``merge_kernels`` merge kernels a replay (3 where the merge is
    kept, 2 where it falls back: the mark and the gather); the graph's
    top-level nodes by type."""
    import torch
    from vpic_tpu_torch.engine import cond, graphs
    from vpic_tpu_torch.particles import sort_cuda
    device = args[0].device
    cond.prepare(device)
    want = sort_cuda.merge_sort_packed(*args)
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        sort_cuda.merge_sort_packed(*args)
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        graph.capture_begin()
        try:
            out = sort_cuda.merge_sort_packed(*args)
        finally:
            graph.capture_end()
    torch.cuda.current_stream(device).wait_stream(side)
    nodes = graphs.node_types(graph.raw_cuda_graph())
    graph.instantiate()
    graph.replay()
    torch.cuda.synchronize()
    if not (_bitwise_equal(out[0], want[0])
            and all(torch.equal(a, b) for a, b in zip(out[1:], want[1:]))):
        raise AssertionError(f"{label}: the captured re-sort differs from "
                             "the eager one")
    if not nodes.get("conditional"):
        raise AssertionError(f"{label}: no conditional node in {nodes}")
    r1, r2 = cuda_ms(graph.replay, 20), cuda_ms(graph.replay, 20)
    prof = call_profile(graph.replay, None)
    if prof["reads"]:
        raise AssertionError(f"{label}: {prof['reads']} host reads per "
                             "replay")
    log(f"  {label}, captured alone: fast {bool(out.fast)}, replay "
        f"{r1:.4f} / {r2:.4f} ms (CUDA events), device busy "
        f"{prof['busy_ms']:.4f} ms, {prof['ops']:.1f} device ops, "
        f"{prof['reads']:.1f} host reads per replay ({prof['merge_seen']:.1f}"
        f" of the {merge_kernels} merge kernels that ran in the trace); "
        f"top-level nodes {nodes}; bitwise the eager re-sort; device ops "
        f"{prof['names']}")
    return dict(replay_ms=min(r1, r2), busy_ms=prof["busy_ms"],
                ops=prof["ops"], merge_kernels_traced=prof["merge_seen"],
                nodes=nodes)


def phase_merge(g, device):
    """Returns the records of the mark, tables and assembly kernels: the
    max abs error over the cases and, at the bench shape, wrappers (CUDA
    events), kernels alone (profiler), plain passes, bounds and, for the
    assembly, one ``index_copy_`` of the block by the prepared permutation
    (the other two have no one-call counterpart); also the whole merge
    re-sort against a full sort_p_packed."""
    import torch
    from vpic_tpu_torch.core.types import PackedSpecies
    from vpic_tpu_torch.particles import aux, sort, sort_cuda
    errs = [run_merge_case(name, device) for name in MERGE_CASES]

    pk, npt, key0, ctot, nvk, m_cap = bench_merge_block(g, device)
    n = pk.shape[1]
    args = (pk, npt, key0, ctot, nvk, m_cap)
    errs.append(check_merge("bench shape", *args, True)[3:])
    marks = sort_cuda.mark(*args)
    n_m = int(marks.info[0])
    plan = sort.merge_plan(marks)
    log(f"  bench shape: merge kernels ok (n={n}, np={int(npt)}, nvk={nvk}, "
        f"movers {n_m}, m_cap {m_cap}; each kernel bitwise its plain "
        "pass's, two runs bitwise equal)")

    # the yardstick: the same permutation by one index_copy_, its
    # destinations per source lane prepared beforehand
    cum_res, cum_mov, _ = sort.tables(plan.key_ms, marks.mov_old, ctot)
    d = sort.destinations(pk, npt, key0, marks, plan, cum_res, cum_mov, nvk)
    dest_lane = d.dest[:n].clone()
    moved = d.dest[n:] < n
    dest_lane[d.src[n:][moved]] = d.dest[n:][moved]
    lib_out = torch.empty_like(pk)
    run_l = lambda: lib_out.index_copy_(1, dest_lane, pk)
    run_a = lambda: sort_cuda.assemble(pk, npt, key0, ctot, marks, plan,
                                       nvk, m_cap)
    run_l()
    if not _bitwise_equal(lib_out, run_a().pk):
        raise AssertionError("bench shape: index_copy_ by the destinations "
                             "differs from the assembly")
    run_pa = lambda: sort.assemble(pk, npt, key0, ctot, marks, plan, nvk,
                                   m_cap)
    run_m = lambda: sort_cuda.mark(*args)
    run_pm = lambda: sort.mark(*args)
    mp1, mk1, mk2, mp2 = (cuda_ms(run_pm, 20), cuda_ms(run_m, 20),
                          cuda_ms(run_m, 20), cuda_ms(run_pm, 20))
    run_pt = lambda: sort.tables(plan.key_ms, marks.mov_old, ctot)
    tab_err = max(int((a.long() - b.long()).abs().max())
                  for a, b in zip(run_a()[2:5], run_pt()))
    tp1, tp2 = cuda_ms(run_pt, 20), cuda_ms(run_pt, 20)
    p1, k1, l1, k2, l2, p2 = (cuda_ms(run_pa, 20), cuda_ms(run_a, 20),
                              cuda_ms(run_l, 20), cuda_ms(run_a, 20),
                              cuda_ms(run_l, 20), cuda_ms(run_pa, 20))
    psp = PackedSpecies(name="bench", sid=0, max_np=n, sort_interval=0,
                        q_m=-1.0, np=npt, nm=torch.zeros_like(npt), pk=pk,
                        key0=key0, ctot=ctot)
    run_merge = lambda: sort_cuda.merge_sort_packed(*args)
    run_full = lambda: aux.sort_p_packed(psp, g)
    w1, f1, w2, f2 = (cuda_ms(run_merge, 10), cuda_ms(run_full, 10),
                      cuda_ms(run_merge, 10), cuda_ms(run_full, 10))
    mark_alone, mark_ops = profiled_ms(run_m, 20, ("merge_mark_kernel",), 1)
    tab_alone, asm_ops = profiled_ms(run_a, 20, ("merge_tables_kernel",), 1)
    asm_alone, _ = profiled_ms(run_a, 20, ("merge_assemble_kernel",), 1)
    fast_p = call_profile(run_merge, 4)
    # a fallback: more movers than a 1024-slot buffer holds
    run_slow = lambda: sort_cuda.merge_sort_packed(pk, npt, key0, ctot, nvk,
                                                   1024)
    if bool(run_slow().fast):
        raise AssertionError("bench shape: 1024 mover slots did not overflow")
    slow_p = call_profile(run_slow, 4)
    full_p = call_profile(run_full)
    if fast_p["reads"] or slow_p["reads"]:
        raise AssertionError(f"bench shape: the merge re-sort read the card "
                             f"{fast_p['reads']} / {slow_p['reads']} times "
                             "per call")
    # what an eager re-sort adds to a merge: the full sort's order (the
    # lane keys and a torch.sort of all of them), the other branch
    run_order = lambda: sort.full_order(pk, npt, nvk)
    o1, o2 = cuda_ms(run_order, 20), cuda_ms(run_order, 20)
    order_p = call_profile(run_order)
    # the re-sort as one program: captured alone, its decision two
    # conditional nodes, on the kept merge and on the fallback
    kept = captured_resort("bench shape, merge kept", args, 3)
    fell = captured_resort("bench shape, fallback (1024 mover slots)",
                           args[:-1] + (1024,), 2)
    tiles = -(-n // sort.TILE)
    mb_ms, mb_by = mark_bound(n, n_m, m_cap, tiles)
    tb_ms, tb_by = tables_bound(n_m, nvk)
    ab_ms, ab_by = merge_bound(n, n_m, nvk, tiles)
    for name, t, b in (("mark", mark_alone, mb_ms), ("tables", tab_alone,
                                                     tb_ms),
                       ("assembly", asm_alone, ab_ms)):
        held_to_bound(f"the {name} kernel alone", t, b)
    log(f"  timing, bench shape: mark wrapper {mk1:.4f} / {mk2:.4f} ms "
        f"({mark_ops:.1f} device ops per call), kernel alone "
        f"{mark_alone:.4f} ms, plain {mp1:.4f} / {mp2:.4f} ms, bound "
        f"{mb_ms:.4f} ms ({mb_by}), the kernel at {mb_ms / mark_alone:.4f} "
        "of it")
    log(f"  timing, bench shape: tables kernel alone {tab_alone:.4f} ms "
        f"(launched by the assembly's wrapper), plain {tp1:.4f} / "
        f"{tp2:.4f} ms, bound {tb_ms:.4f} ms ({tb_by})")
    log(f"  timing, bench shape: assembly wrapper (tables and assembly "
        f"kernels) {k1:.4f} / {k2:.4f} ms ({asm_ops:.1f} device ops per "
        f"call), assembly kernel alone {asm_alone:.4f} "
        f"ms, plain {p1:.4f} / {p2:.4f} ms, index_copy_ {l1:.4f} / {l2:.4f} "
        f"ms; bound {ab_ms:.4f} ms ({ab_by}), the kernel at "
        f"{ab_ms / asm_alone:.4f} of it")
    log(f"  timing, bench shape: the whole merge re-sort {w1:.4f} / "
        f"{w2:.4f} ms (device busy {fast_p['busy_ms']:.4f} ms, "
        f"{fast_p['ops']:.1f} device ops and {fast_p['reads']:.1f} host "
        f"reads per call, its four merge kernels {fast_p['kernel_ms']:.4f} ms "
        f"alone) against a full sort_p_packed {f1:.4f} / {f2:.4f} ms "
        f"(device busy {full_p['busy_ms']:.4f} ms, {full_p['ops']:.1f} "
        f"device ops per call); the re-sort's device ops: {fast_p['names']}")
    log(f"  a re-sort that falls back (1024 mover slots): device busy "
        f"{slow_p['busy_ms']:.4f} ms, {slow_p['ops']:.1f} device ops and "
        f"{slow_p['reads']:.1f} host reads per call, its four merge kernels "
        f"{slow_p['kernel_ms']:.4f} ms alone")
    log(f"  the full sort's order that an eager re-sort computes (the lane "
        f"keys and one torch.sort of all {n}): {o1:.4f} / {o2:.4f} ms "
        f"(device busy {order_p['busy_ms']:.4f} ms, {order_p['ops']:.1f} "
        "device ops): the select's cost on a merge that is kept, which a "
        "graph's conditional nodes skip")
    whole = dict(whole_merge_ms=min(w1, w2), full_sort_ms=min(f1, f2),
                 whole_merge_busy_ms=fast_p["busy_ms"],
                 full_sort_busy_ms=full_p["busy_ms"],
                 merge_ops_per_call=fast_p["ops"],
                 host_reads_per_sort=fast_p["reads"],
                 fallback_ops_per_call=slow_p["ops"],
                 fallback_busy_ms=slow_p["busy_ms"],
                 fallback_host_reads_per_sort=slow_p["reads"],
                 full_order_ms=min(o1, o2),
                 full_order_busy_ms=order_p["busy_ms"],
                 **{f"graphed_merge_{k}": v for k, v in kept.items()},
                 **{f"graphed_fallback_{k}": v for k, v in fell.items()})
    err, mark_err = (max(e) for e in zip(*errs))
    return (
        dict(ms=min(mk1, mk2), max_abs_err=mark_err, kernel_ms=mark_alone,
             plain_ms=min(mp1, mp2), bound_ms=mb_ms, bound_by=mb_by,
             library_ms=None),
        dict(ms=min(k1, k2), max_abs_err=tab_err, kernel_ms=tab_alone,
             plain_ms=min(tp1, tp2), bound_ms=tb_ms, bound_by=tb_by,
             library_ms=None),
        dict(ms=min(k1, k2), max_abs_err=err, kernel_ms=asm_alone,
             plain_ms=min(p1, p2),
             bound_ms=ab_ms, bound_by=ab_by, library_ms=min(l1, l2),
             **whole))


def timed_windows(sim, label, e_refs):
    """WINDOWS windows of STEPS steps through the Simulation API, each
    timed on the host clock around ``advance(STEPS)`` ending in a
    synchronize, as phase 5 times the main path.  Each window: finite
    energies, bounded drift, no dropped movers, and energies equal to the
    default path's at the same step (``e_refs``, one dict per window) to
    1e-6 relative.  Returns the median step time in s."""
    import math
    import statistics
    import torch
    n_total = sum(int(sp.np) for sp in sim.state.species)
    step_s = []
    for w, e_ref in enumerate(e_refs):
        e0, nm0 = sim.energies(), sim.mover_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sim.advance_steps(STEPS)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        e1, nm1 = sim.energies(), sim.mover_counts()
        if not all(math.isfinite(v) for v in list(e0.values())
                   + list(e1.values())):
            raise AssertionError(f"{label}: non-finite energies {e1}")
        drops = {k: nm1[k] - nm0[k] for k in nm1}
        if any(drops.values()):
            raise AssertionError(f"{label}: dropped movers {drops}")
        tot0, tot1 = sum(e0.values()), sum(e1.values())
        drift = (tot1 - tot0) / tot0
        if not abs(drift) < DRIFT_LIMIT:
            raise AssertionError(f"{label}: energy drift {drift:.3e} over "
                                 f"{STEPS} steps")
        for k in e_ref:
            if abs(e1[k] - e_ref[k]) > 1e-6 * abs(e_ref[k]) + 1e-12:
                raise AssertionError(f"{label}: energy {k} {e1[k]!r} vs the "
                                     f"default path's {e_ref[k]!r}")
        step_s.append(dt / STEPS)
        log(f"  {label} window {w + 1}/{len(e_refs)}: {STEPS} steps in "
            f"{dt:.4f} s, {dt / STEPS * 1e3:.4f} ms/step, "
            f"{n_total * STEPS / dt:.6e} pushes/s, dropped movers {drops}, "
            f"energy drift {drift:.3e}, energies match the default path's "
            f"at step {sim.step_count} to 1e-6 relative")
    med = statistics.median(step_s)
    log(f"  {label}: median {med * 1e3:.4f} ms/step (min "
        f"{min(step_s) * 1e3:.4f}, max {max(step_s) * 1e3:.4f}), "
        f"{n_total / med:.6e} pushes/s")
    return med


def reference_energies(device):
    """The default path's energies on a fresh 128^2 deck at the end of
    each window that paths A and B time (after WARM_STEPS, every STEPS
    steps).  Each path starts from a fresh deck, as the main path does:
    later in a run the deck's own drift over STEPS steps nears
    DRIFT_LIMIT on every path alike."""
    from vpic_tpu_torch.decks import bench_deck
    ref = bench_deck.build(**SLICE, device=device)
    ref.advance_steps(WARM_STEPS)
    out = []
    for _ in range(WINDOWS):
        ref.advance_steps(STEPS)
        out.append(ref.energies())
    return out


def phase_path_a(device, e_refs):
    """The unfused push on a fresh 128^2 deck; returns deposit launches
    and the median step time."""
    from vpic_tpu_torch.decks import bench_deck
    from vpic_tpu_torch.particles import deposit_cuda, push_cuda
    phase_small_deck(device, fused_push=False)
    sim = bench_deck.build(**SLICE, device=device)
    sim.modify_runparams(fused_push=False)
    sim.advance_steps(WARM_STEPS)
    nsp = len(sim.state.species)
    push_cuda.reset_launch_counts()
    deposit_cuda.reset_launch_counts()
    med = timed_windows(sim, "128^2 path A (fused_push=False)", e_refs)
    dep = deposit_cuda.launches["deposit_sorted"]
    walk = push_cuda.launches["walk_only"]
    steps = WINDOWS * STEPS
    if dep != steps * nsp or walk != steps * nsp:
        raise AssertionError(f"path A: deposit launches {dep}, walk_only "
                             f"launches {walk}, expected {steps * nsp} each")
    if push_cuda.launches["push"]:
        raise AssertionError("path A launched the fused push")
    log(f"  path A launches: deposit {dep}, walk_only {walk} "
        f"(= {steps} steps x {nsp} species); "
        f"{'graphed' if sim.graphed else 'eager'} path, dispatch "
        f"{dict(sim.dispatch_counts)}")
    eager_windows(sim, "path A", med)
    phase_trace(sim, med, "path A")
    return dep, med


def packed_windows(sim, label, e_refs):
    """timed_windows on a deck that runs the packed cycle as CUDA graphs,
    with the push and merge launch counts set to 0 just before and read
    just after: one push launch per species per step, none of walk_only,
    one mark launch per sort, one tables and one assembly launch per
    merge kept (the merge's conditional body runs only there).  Returns
    the merge kernels' launches, the fast and slow sorts per species and
    the median step time."""
    from vpic_tpu_torch.particles import push_cuda, sort
    nsp = len(sim.state.species)
    _reset_launch_counts()
    med = timed_windows(sim, label, e_refs)
    steps = WINDOWS * STEPS
    launches = _launch_counts()
    push, walk = launches["push"], launches["walk_only"]
    if push != steps * nsp or walk:
        raise AssertionError(f"{label}: push launches {push}, walk_only "
                             f"{walk}, expected {steps * nsp} and 0")
    merges = {k: v for k, v in launches.items() if k.startswith("merge_")}
    counts = sort_counts_of()
    if merges != merge_launches(counts, graphed=True):
        raise AssertionError(f"{label}: merge launches {merges} for sorts "
                             f"{counts}")
    caps = {sp.name: round(sort.mover_capacity(
        sp.max_np, max(sim.opts.resort_interval, sp.sort_interval))
        / sp.max_np, 4) for sp in sim.state.species}
    log(f"  {label}: push launches {push} (= {steps} steps x {nsp} "
        f"species), sorts {counts}, merge launches {merges}; mover buffers "
        f"(share of the slots): {caps}")
    return merges, counts, med


def phase_path_b(device, e_refs):
    """The packed cycle with the merge re-sort: the 16^2 deck (every sort
    after a species' first merges), then two fresh 128^2 decks, at the
    deck's own sort cadence and with every species sorted every step.
    Returns the merge kernels' launches in the every-step deck's timed
    windows, on the 16^2 deck and in the own-cadence deck's timed
    windows, the median step times of the two 128^2 decks and the
    every-step deck's trace."""
    from vpic_tpu_torch.decks import bench_deck
    from vpic_tpu_torch.particles import sort_cuda
    small = bench_deck.build(**SMALL_DECK, device=device)
    small.modify_runparams(merge_sort=True)
    cpu = bench_deck.build(**SMALL_DECK, device="cpu")
    cpu.modify_runparams(merge_sort=True)
    _reset_launch_counts()
    small.advance_steps(STEPS)
    counts = sort_counts_of()
    small_launches = {k: v for k, v in _launch_counts().items()
                      if k.startswith("merge_")}
    cpu.advance_steps(STEPS)
    want = {"electron": {"fast": 7, "slow": 1}, "ion": {"fast": 1, "slow": 1}}
    if counts != want:
        raise AssertionError(f"16^2 path B: sorts {counts}, expected {want}")
    if small_launches != merge_launches(counts, graphed=True):
        raise AssertionError(f"16^2 path B: merge launches {small_launches}, "
                             "expected a mark and an assembly per sort (10) "
                             "and the tables per merge kept (8)")
    eg, ec = small.energies(), cpu.energies()
    for k in ec:
        if abs(eg[k] - ec[k]) > 1e-6 * abs(ec[k]) + 1e-12:
            raise AssertionError(f"16^2 path B: energy {k} {eg[k]!r} vs "
                                 f"CPU {ec[k]!r}")
    if any(small.mover_counts().values()):
        raise AssertionError(f"16^2 path B: {small.mover_counts()}")
    log(f"  16^2 path B, {STEPS} steps: sorts {counts}, merge launches "
        f"{small_launches}, energies match the CPU plain path to 1e-6")

    sim = bench_deck.build(**SLICE, device=device)
    sim.modify_runparams(merge_sort=True)
    sim.advance_steps(WARM_STEPS)
    cadence_launches, counts, med = packed_windows(
        sim, "128^2 path B (merge_sort=True)", e_refs)
    log("  (slow expected at the deck's own cadence: more lanes change "
        "voxel between two sorts than the reference's mover buffer holds)")
    phase_trace(sim, med, "path B")
    del sim

    sim = bench_deck.build(**SLICE, resort_interval=1, ion_sort_mult=1,
                           device=device)
    sim.modify_runparams(merge_sort=True)
    sim.advance_steps(WARM_STEPS)
    launches, counts, med_1 = packed_windows(
        sim, "128^2 path B, every species sorted every step", e_refs)
    if launches["merge_assemble"] < 1:
        raise AssertionError(f"128^2 path B, sorts every step: no merge for "
                             f"sorts {counts}")
    trace = phase_trace(sim, med_1, "path B, sorts every step")
    srt = trace["parts"]["step.sort"]
    log(f"  path B, every species sorted every step: step.sort busy "
        f"{srt['busy_ms']:.4f} ms/step, {srt['ops']:.1f} device ops/step")
    return (launches, small_launches, cadence_launches, med, med_1, trace)


ROOT = os.path.dirname(os.path.abspath(__file__))
TURB_DECK = "vpic_tpu_torch/decks/turbulence.py"
# the deck's own defaults, set explicitly: 64x32x32 cells, 16 per cell
TURB_FULL = dict(TURB_NX="64", TURB_NY="32", TURB_NZ="32", TURB_PPC="16")
TURB_SMALL = dict(TURB_NX="8", TURB_NY="8", TURB_NZ="8", TURB_PPC="2")
TURB_STEPS, TURB_RESTART = 100, 50   # restart1 holds step 50
# the CLI run's intervals: energies, fields and hydro, particles, restart,
# tracers, spectra
TURB_DIAG = dict(TURB_ENERGY_INTERVAL="10", TURB_FIELD_INTERVAL="50",
                 TURB_PARTICLE_INTERVAL="100", TURB_RESTART_INTERVAL="50",
                 TURB_TRACER_INTERVAL="50", TURB_SPECTRUM_INTERVAL="100")
TURB_DRIFT_LIMIT = 2e-2     # |relative total-energy change| over 10 steps


def port_deck(name, device, size):
    """The port's ``vpic_tpu_torch/decks/<name>.py`` built and finalized at
    ``size`` (the deck's environment knobs) on ``device``."""
    import importlib
    saved = {k: os.environ.get(k) for k in size}
    os.environ.update(size)
    try:
        mod = importlib.import_module(f"vpic_tpu_torch.decks.{name}")
        sim = mod.deck(device=device)
        sim.finalize()
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k)
            else:
                os.environ[k] = v
    return sim


def turb_deck(device, size):
    """The port's turbulence deck at ``size`` (TURB_* values)."""
    return port_deck("turbulence", device, size)


def _float_rho(sp, g):
    """rhof of one species by a float32 ``index_add_`` of the trilinear
    weights: the charge deposit as it was before it summed in fixed point
    (the finding's control)."""
    import torch
    from vpic_tpu_torch.particles import aux
    q = torch.where(sp.alive, sp.q, 0.0)
    w = aux.trilinear_weights(q, sp.dx, sp.dy, sp.dz, aux._r8V(g))
    offs = torch.tensor([ox + g.nxg * (oy + g.nyg * oz)
                         for ox, oy, oz in aux._NODE_OFFS], device=q.device)
    idx = torch.where(sp.alive, sp.i, 0).long()[:, None] + offs
    rho = torch.zeros(g.nv, dtype=torch.float32, device=q.device)
    return rho.index_add_(0, idx.reshape(-1), w.reshape(-1))


def check_fixed_deposits(label, sim, species):
    """The fixed-point rho and hydro deposits of ``species`` (names) on the
    card: two calls bitwise equal, each node within 1e-6 * sum|w| (per
    hydro column, sum|contribution|) of a float64 ``index_add_`` of the
    same contributions, plus half of the column's fixed-point quantum 2^-S
    per contribution (a node whose sum|c| is below about 1e6 2^-S, as a
    nearly still lane's stress terms give, cannot meet the relative bar in
    fixed point)."""
    import numpy as np
    import torch
    from vpic_tpu_torch.core.types import FieldState
    from vpic_tpu_torch.particles import aux
    g, st = sim.grid, sim.state
    r8V = aux._r8V(g)
    worst = quant = 0.0
    for name in species:
        sp = st.species[sim._species_by_name(name)["sid"]]
        dev = sp.dx.device
        f0 = FieldState.zeros(g, dev)
        r1, r2 = (aux.accumulate_rho_p(f0, sp, g).rhof.reshape(-1, 1)
                  for _ in range(2))
        h0 = torch.zeros((g.nv, aux.N_HYDRO), device=dev)
        h1, h2 = (aux.accumulate_hydro_p(h0, sp, st.interpolator, g)
                  for _ in range(2))
        if not (_bitwise_equal(r1, r2) and _bitwise_equal(h1, h2)):
            raise AssertionError(f"{label} {name}: two fixed-point deposits "
                                 "differ")
        vox, q, vals = aux.hydro_moments(sp, st.interpolator, g)
        w = aux.trilinear_weights(q, sp.dx, sp.dy, sp.dz, r8V)
        mc_q = float(np.float32(np.float32(g.cvac) / np.float32(sp.q_m)))
        f64 = lambda v: torch.tensor(v, dtype=torch.float64, device=dev)
        # the columns' scales, as accumulate_rho_p / accumulate_hydro_p
        # choose them
        rho_bound = aux._bound(q, torch.ones_like(q)[:, None], r8V, f64([1.0]))
        hyd_bound = aux._bound(q, vals, r8V, f64([1.0] * 4 + [abs(mc_q)] * 10))
        offs = torch.tensor([ox + g.nxg * (oy + g.nyg * oz)
                             for ox, oy, oz in aux._NODE_OFFS], device=dev)
        idx = (vox.long()[:, None] + offs).reshape(-1)
        for got, bound, contrib in (
                (r1, rho_bound, lambda: w[:, :, None]),
                (h1, hyd_bound, lambda: torch.cat(
                    [w[:, :, None] * vals[:, None, :4],
                     (w * mc_q)[:, :, None] * vals[:, None, 4:]], dim=-1))):
            c = contrib().reshape(idx.numel(), -1).to(torch.float64)
            exact = torch.zeros(got.shape, dtype=torch.float64,
                                device=dev).index_add_(0, idx, c)
            absum = torch.zeros_like(exact).index_add_(0, idx, c.abs())
            num = torch.zeros_like(exact).index_add_(0, idx,
                                                     (c != 0).double())
            del c
            quantum = 0.5 / aux.deposit_scale(bound, vox.shape[0])
            err = (got.to(torch.float64) - exact).abs()
            if not bool((err <= 1e-6 * absum + num * quantum + 1e-30).all()):
                raise AssertionError(f"{label} {name}: a fixed-point deposit "
                                     "is beyond 1e-6 * sum|c| of float64")
            big = absum >= 1e6 * num * quantum
            rel = (err / (absum + 1e-30))[big]
            per = (err / (num * quantum + 1e-300))[~big]
            if rel.numel():
                worst = max(worst, float(rel.max()))
            if per.numel():
                quant = max(quant, float(per.max()))
    log(f"  {label}: fixed-point rho and hydro of {list(species)} repeat "
        f"bitwise; against float64, max |err| / sum|c| {worst:.3g} where "
        f"sum|c| is at least 1e6 quanta, else max |err| {quant:.3g} half "
        "quanta per contribution")


def phase_determinism(device):
    """The finding and its repair on the card: the charge deposit as a
    float32 ``index_add_`` run twice on the 128^2 electrons; two bench
    decks built from one seed (finalize deposits rho and cleans div E)
    compared by checksum_fields at finalize and after 4 steps."""
    from vpic_tpu_torch.decks import bench_deck
    digests = []
    for k in range(2):
        sim = bench_deck.build(**SLICE, device=device)
        if k == 0:
            sp = sim.state.species[0]
            a, b = _float_rho(sp, sim.grid), _float_rho(sp, sim.grid)
            bad = int((a != b).sum())
            log(f"  float32 index_add_ charge deposit of the 128^2 electrons, "
                f"two calls: {'bitwise equal' if bad == 0 else 'differ'} "
                f"({bad} of {a.numel()} nodes differ, max abs diff "
                f"{float((a - b).abs().max()):.3g})")
        d0 = sim.checksum_fields()
        sim.advance_steps(4)
        digests.append((d0, sim.checksum_fields()))
        log(f"  bench deck build {k + 1}: checksum_fields at finalize {d0}, "
            f"after 4 steps {digests[-1][1]}")
        del sim
    if digests[0] != digests[1]:
        raise AssertionError(f"two builds from one seed differ: {digests}")
    log("  two builds from one seed: checksum_fields equal at finalize and "
        "after 4 steps")
    return digests[0]


def check_tracer_push(sp, interp, nb, g, n_walk):
    """The push kernel on a q = 0 species: every accumulator word 0 and the
    wrapper's scale the finite 2^200 of the clamp."""
    import torch
    from vpic_tpu_torch.particles import push_cuda
    acc0 = torch.zeros((g.nv, 12), dtype=torch.float32, device=sp.dx.device)
    _, acc = push_cuda.advance_p(sp, interp, acc0, nb, g, n_walk=n_walk)
    stream = torch.cuda.current_stream(sp.dx.device).cuda_stream
    _, _, scale = push_cuda._scratch_for(sp.dx.device, g.nv, stream)
    if bool(acc.any()) or float(scale) != 2.0 ** 200:
        raise AssertionError(f"q = 0 species {sp.name}: acc nonzero "
                             f"{int((acc != 0).sum())} words, scale "
                             f"{float(scale)!r}")
    log(f"  {sp.name} (q = 0): accumulator all zero, scale 2^200")


def phase_turb_kernel(sim):
    """The push kernel on the turbulence deck's six species (3D, PEC z
    walls with reflected particles, q = 0 tracers), voxel-sorted as the
    step sorts them, against the plain push and its fixed-point twin; the
    tracers' zero deposit; then on eT the walk's counts and the timing of
    the wrapper, the kernel alone and the plain version against the bound.
    Returns (max abs err, timing dict)."""
    from vpic_tpu_torch.engine.step import walk_segments
    from vpic_tpu_torch.particles import aux
    st, g = sim.state, sim.grid
    nb, interp = st.grid_arrays.neighbor, st.interpolator
    n_walk = walk_segments(g, sim.opts)
    errs = []
    species = [aux.sort_p(sp) for sp in st.species]
    for sp in species:
        errs.append(check_push(f"turbulence {sp.name} (n_walk {n_walk})", sp,
                               interp, nb, g, n_walk, quantum=True))
        if not bool(sp.q.any()):
            check_tracer_push(sp, interp, nb, g, n_walk)
    sp = species[0]
    c = walk_counts(sp, interp, nb, g, n_walk)
    log(f"  walk of the sorted eT (plain, {int(sp.alive.sum())} live lanes):"
        f" {c['pairs']} (lane, segment) pairs, live lanes by segments walked "
        f"{c['lanes_by_segments']}")
    return max(errs), time_push("turbulence eT", sp, interp, nb, g, n_walk,
                                c["pairs"])


def deck_cli(deck, env, steps, *args):
    """The port's CLI on ``deck`` (a path in the repo) for ``steps`` steps
    in a process of its own on the card, with the environment ``env`` added
    to this one's; returns its seconds."""
    cmd = [sys.executable, "-m", "vpic_tpu_torch.cli.run", deck,
           "--num-step", str(steps), "--status-interval", "50", *args]
    t0 = time.perf_counter()
    r = subprocess.run(cmd, cwd=ROOT, env=dict(os.environ, **env),
                       capture_output=True, text=True, timeout=600)
    dt = time.perf_counter() - t0
    for line in r.stdout.splitlines():
        log(f"  cli: {line}")
    if r.returncode:
        raise AssertionError(f"the CLI exited {r.returncode}: "
                             f"{r.stderr[-3000:]}")
    return dt


def run_cli(out, *args):
    """The port's CLI on the turbulence deck at full size, writing under
    ``out``; returns its seconds."""
    return deck_cli(TURB_DECK, dict(TURB_FULL, **TURB_DIAG, TURB_OUT=str(out)),
                    TURB_STEPS, *args)


def read_energies(path):
    """{step: [6 field energies, then each species' KE]} of an energies
    file."""
    out = {}
    for line in open(path):
        if not line.startswith("%"):
            words = line.split()
            out[int(words[0])] = [float(v) for v in words[1:]]
    return out


def phase_turb_cli(tmp, e0_total):
    """The CLI on the card at the deck's full size for TURB_STEPS steps
    with standard_diagnostics, then again from its step-TURB_RESTART
    restart: every step-TURB_STEPS dump byte for byte the first run's;
    finite energies and the total within TURB_DRIFT_LIMIT over the first
    10 steps (``e0_total``: a fresh deck's at step 0); each species'
    dropped movers at the last step.  Returns the two runs' seconds and
    the movers."""
    import math
    import numpy as np
    first, second = os.path.join(tmp, "first"), os.path.join(tmp, "second")
    t1 = run_cli(first)
    # the rotating restart: restart1 holds step 50, restart2 step 100
    t2 = run_cli(second, "--restart",
                 os.path.join(first, "restart1", "restart"))
    tag = f".{TURB_STEPS}.0"
    dumps = sorted(os.path.relpath(os.path.join(d, f), first)
                   for d, _, files in os.walk(first) for f in files
                   if f.endswith(tag) or os.path.basename(d)
                   == f"T.{TURB_STEPS}")
    kinds = collections.Counter(p.split(os.sep)[0] for p in dumps)
    want = {"fields": 1, "hydro": 6, "particle": 4, "tracer": 2,
            "spectra": 8}
    if kinds != want:
        raise AssertionError(f"step-{TURB_STEPS} dumps {dict(kinds)}, "
                             f"expected {want}")
    nbytes = 0
    for rel in dumps:
        a = open(os.path.join(first, rel), "rb").read()
        b = open(os.path.join(second, rel), "rb").read()
        if a != b:
            raise AssertionError(f"{rel}: the restarted run's bytes differ")
        nbytes += len(a)
    log(f"  restart from step {TURB_RESTART}: all {len(dumps)} step-"
        f"{TURB_STEPS} dumps ({dict(kinds)}, {nbytes} bytes) byte-identical "
        "to the first run's")
    en = read_energies(os.path.join(first, "rundata", "energies"))
    if sorted(en) != list(range(10, TURB_STEPS + 1, 10)) or not all(
            math.isfinite(v) for vals in en.values() for v in vals):
        raise AssertionError(f"energies file: steps {sorted(en)}, finite "
                             "values expected")
    drift = (sum(en[10]) - e0_total) / e0_total
    if not abs(drift) < TURB_DRIFT_LIMIT:
        raise AssertionError(f"total energy moved {drift:.3e} in 10 steps")
    log(f"  energies finite at steps 10..{TURB_STEPS}; total {e0_total!r} "
        f"at step 0, {sum(en[10])!r} at step 10 ({drift:.3e}), "
        f"{sum(en[TURB_STEPS])!r} at step {TURB_STEPS}")
    ck = os.path.join(first, "restart2", "restart")
    meta = json.load(open(ck + ".json"))
    with np.load(ck + ".npz") as data:
        nm = {s["name"]: int(data[f"species/{k}/nm"])
              for k, s in enumerate(meta["species"])}
    log(f"  dropped movers by step {meta['extra']['step_count']}: {nm}")
    return t1, t2, nm


def phase_turb_small(device):
    """The deck at the tests' size (8^3 cells, 2 per cell) on the card and
    on the CPU, 8 steps: energies equal to 1e-6 relative."""
    gpu, cpu = turb_deck(device, TURB_SMALL), turb_deck("cpu", TURB_SMALL)
    gpu.advance_steps(8)
    cpu.advance_steps(8)
    eg, ec = gpu.energies(), cpu.energies()
    for k in ec:
        if abs(eg[k] - ec[k]) > 1e-6 * abs(ec[k]) + 1e-12:
            raise AssertionError(f"8^3 turbulence deck: energy {k} "
                                 f"{eg[k]!r} vs CPU {ec[k]!r}")
    log(f"  8^3 turbulence deck, 8 steps: card energies match the CPU plain "
        f"path to 1e-6 relative ({len(ec)} energies), movers "
        f"{gpu.mover_counts()}")


def timed_call(fn):
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def push_only_windows(sim, label, graphed=True):
    """WINDOWS timed windows of STEPS steps (no diagnostics) with the
    kernels' launch counts set to 0 just before and read just after: one
    push launch per species per step and no other kernel, finite
    energies; the deck runs as CUDA graphs where ``graphed`` (the windows
    then replay them), else op by op.  Returns (launches, median step
    s)."""
    import math
    import statistics
    import torch
    from vpic_tpu_torch.particles import deposit_cuda, push_cuda, sort_cuda
    if sim.graphed is not graphed:
        raise AssertionError(f"{label}: graphed is {sim.graphed}, expected "
                             f"{graphed}")
    nsp = len(sim.state.species)
    n_total = sum(int(sp.np) for sp in sim.state.species)
    for mod in (push_cuda, deposit_cuda, sort_cuda):
        mod.reset_launch_counts()
    step_s = []
    for w in range(WINDOWS):
        e0 = sum(sim.energies().values())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sim.advance_steps(STEPS)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        e1 = sim.energies()
        if not all(math.isfinite(v) for v in e1.values()):
            raise AssertionError(f"{label}: non-finite energies {e1}")
        step_s.append(dt / STEPS)
        log(f"  {label} window {w + 1}/{WINDOWS} (steps "
            f"{sim.step_count - STEPS}-{sim.step_count}): {dt:.4f} s, "
            f"{dt / STEPS * 1e3:.4f} ms/step, {n_total * STEPS / dt:.6e} "
            f"pushes/s, energy change {(sum(e1.values()) - e0) / e0:.3e}")
    launches = dict(push_walk=push_cuda.launches["push"],
                    walk_only=push_cuda.launches["walk_only"],
                    deposit_sorted=deposit_cuda.launches["deposit_sorted"],
                    **sort_cuda.launches)
    want = WINDOWS * STEPS * nsp
    if launches["push_walk"] != want or sum(launches.values()) != want:
        raise AssertionError(f"{label} launches {launches}, expected "
                             f"{want} push launches and no other kernel")
    med = statistics.median(step_s)
    log(f"  {label}, {n_total} particles in {nsp} species: median "
        f"{med * 1e3:.4f} ms/step (min {min(step_s) * 1e3:.4f}, max "
        f"{max(step_s) * 1e3:.4f}), kernel launches {launches}, movers "
        f"{sim.mover_counts()}; "
        + (f"graphed, dispatch {dict(sim.dispatch_counts)}" if graphed
           else "op by op"))
    return launches, med


def phase_turb_timing(device, tmp):
    """In process on a fresh full-size deck after WARM_STEPS steps:
    WINDOWS timed windows of STEPS steps (no diagnostics) with the kernels'
    launch counts set to 0 just before and read just after (one push
    launch per species per step, no other kernel), a trace of
    TRACE_STEPS steps, and one call of each diagnostic after an untimed
    one.  Returns (launches, median step s, trace, diagnostic ms)."""
    from vpic_tpu_torch.io import banded
    sim = turb_deck(device, TURB_FULL)
    sim.advance_steps(WARM_STEPS)
    launches, med = push_only_windows(sim, "turbulence")
    trace = phase_trace(sim, med, "turbulence path")

    g, s = sim.grid, sim.step_count
    ck = os.path.join(tmp, "timing", "ck")
    calls = {
        "energies": lambda: sim.energies(),
        "banded fields": lambda: banded.field_dump(
            sim.state, g, os.path.join(tmp, "timing", "fields"),
            banded.DumpParameters(), s),
        **{f"hydro {h['name']}": (lambda n=h["name"]: sim.dump_hydro(
            n, os.path.join(tmp, "timing", f"{n}hydro")))
           for h in sim._species},
        "particles eT": lambda: sim.dump_particles(
            "eT", os.path.join(tmp, "timing", "eTparticle")),
        "spectrum eT": lambda: sim.dump_energy_diag(
            "eT", os.path.join(tmp, "timing", "spectra"), nex=200, emax=50.0,
            vth=0.6),
        "checkpoint save": lambda: sim.checkpoint(ck),
        "restore": lambda: sim.restore(ck),
    }
    diag_ms = {}
    for name, fn in calls.items():
        fn()
        diag_ms[name] = timed_call(fn)
    log("  one call of each diagnostic, ms (after an untimed one): "
        + ", ".join(f"{k} {v:.3f}" for k, v in diag_ms.items()))
    return launches, med, trace, diag_ms


def phase_turbulence(device, card):
    """Phase 11: the turbulence path.  Returns the push kernel's record on
    it (max abs err, timing, launches in the timed windows) and logs the
    rest."""
    import shutil
    import tempfile
    import torch
    sim = turb_deck(device, TURB_FULL)
    g = sim.grid
    log(f"  deck: {g.nx}x{g.ny}x{g.nz} cells, nv {g.nv}, species "
        + ", ".join(f"{sp.name} {int(sp.np)}/{sp.max_np}"
                    for sp in sim.state.species)
        + f", field faces {g.fbc}, particle faces {g.pbc}")
    e0_total = sum(sim.energies().values())
    check_fixed_deposits("turbulence deck", sim,
                         [h["name"] for h in sim._species])
    err, kt = phase_turb_kernel(sim)
    del sim
    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="turb_smoke_")
    try:
        t1, t2, nm = phase_turb_cli(tmp, e0_total)
        phase_turb_small(device)
        launches, step_s, trace, diag_ms = phase_turb_timing(device, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"turbulence path ({card}; 64x32x32, 16 per cell, six species): "
        f"CLI {TURB_STEPS} steps with diagnostics {t1:.2f} s, restart "
        f"{TURB_RESTART}->{TURB_STEPS} {t2:.2f} s; step {step_s * 1e3:.4f} "
        f"ms (median of {WINDOWS} windows of {STEPS} steps), device busy "
        f"{trace['busy_ms']:.4f} ms/step, {trace['ops']:.1f} ops/step; "
        f"dropped movers at step {TURB_STEPS} {nm}")
    return dict(turbulence_max_abs_err=err,
                turbulence_launches=launches["push_walk"],
                turbulence_launches_per_step=launches["push_walk"]
                / (WINDOWS * STEPS),
                **{f"turbulence_{k}": v for k, v in kt.items()})


# -- phase 12: the reconnection decks ---------------------------------------

# each deck at its own default size, set explicitly; ``electrons`` is the
# species whose push is timed; ``diag``: the CLI run's dump intervals;
# ``cli_checkpoints``: the CLI writes the rotating checkpoints every
# RECON_RESTART steps (decks without a restart knob of their own; sigma's
# standard_diagnostics writes them); ``dumps``: the step-RECON_STEPS dump
# files expected, by top directory
RECON_STEPS, RECON_RESTART = 50, 25
RECON = {
    "trecon": dict(
        full=dict(TRECON_NX="256", TRECON_NZ="128", TRECON_PPC="64"),
        out="TRECON_OUT", electrons="electron", energies="energies.txt",
        diag=dict(TRECON_ENERGY_INTERVAL="5", TRECON_FIELD_INTERVAL="25",
                  TRECON_TRACER_INTERVAL="25",
                  TRECON_SPECTRUM_INTERVAL="25"),
        cli_checkpoints=True, dumps={"fields": 1, "hydro": 6, "tracer": 1}),
    "sigma": dict(
        full=dict(SIGMA_NX="256", SIGMA_NZ="128", SIGMA_PPC="64"),
        out="SIGMA_OUT", electrons="electron",
        energies=os.path.join("rundata", "energies"),
        diag=dict(SIGMA_ENERGY_INTERVAL="5", SIGMA_FIELD_INTERVAL="25",
                  SIGMA_PARTICLE_INTERVAL="50", SIGMA_RESTART_INTERVAL="25",
                  SIGMA_TRACER_INTERVAL="25", SIGMA_SPECTRUM_INTERVAL="50"),
        cli_checkpoints=False,
        dumps={"fields": 1, "hydro": 4, "particle": 2, "tracer": 2,
               "spectra": 4}),
    "turbulence_fan": dict(
        full=dict(FAN_NX="32", FAN_NY="32", FAN_NZ="32", FAN_PPC="16"),
        out="FAN_OUT", electrons="electron", energies="energies.txt",
        diag=dict(FAN_ENERGY_INTERVAL="5", FAN_SPECTRUM_INTERVAL="25"),
        cli_checkpoints=True, dumps={"hydro": 4}),
}
# the relative total-energy change over RECON_DRIFT_STEPS steps that phase
# 12 allows (tests/test_regressions_r3.py:196), or twice the JAX package's
# own change over those steps at the tests' sizes where that exceeds it
# (measured and checked by tests/test_torch_fan.py and test_torch_trecon.py)
RECON_DRIFT_STEPS, RECON_DRIFT_BAR = 25, 5e-3
JAX_DRIFT_25 = {"turbulence_fan": 1.5721e-2, "trecon": 2.0069e-2}


def recon_drift_limit(name):
    return max(RECON_DRIFT_BAR, 2 * JAX_DRIFT_25.get(name, 0.0))


def check_bar(check, label, *args, **kw):
    """``check`` (check_push, check_walk or check_deposit) at the 1e-6 *
    sum|c| float bar, and where fixed-point words cannot meet it, again
    with the quantum allowance of the turbulence deck.  Returns (max abs err,
    whether it needed the allowance)."""
    try:
        return check(label, *args, **kw), False
    except AssertionError as e:
        if "beyond 1e-6*sum|c|" not in str(e):
            raise
        log(f"  {label}: {e}; checked again with half a fixed-point quantum "
            "per contribution")
        return check(label, *args, quantum=True, **kw), True


def recon_kernel(name, sim):
    """The push kernel on every species of the deck, voxel-sorted as the
    step sorts them, against its plain version and the fixed-point twin;
    the q = 0 species' zero deposit; on the electrons the walk's counts and
    the kernel's times against its bound.  Returns (max abs err, the
    species that needed the quantum allowance, timing dict)."""
    from vpic_tpu_torch.engine.step import walk_segments
    from vpic_tpu_torch.particles import aux
    st, g = sim.state, sim.grid
    nb, interp = st.grid_arrays.neighbor, st.interpolator
    n_walk = walk_segments(g, sim.opts)
    errs, quantum = [], []
    electrons = None
    for sp in st.species:
        sp = aux.sort_p(sp)
        err, q = check_bar(check_push, f"{name} {sp.name} (n_walk "
                           f"{n_walk})", sp, interp, nb, g, n_walk)
        errs.append(err)
        if q:
            quantum.append(sp.name)
        if not bool(sp.q.any()):
            check_tracer_push(sp, interp, nb, g, n_walk)
        if sp.name == RECON[name]["electrons"]:
            electrons = sp
    c = walk_counts(electrons, interp, nb, g, n_walk)
    log(f"  walk of the sorted {name} electrons (plain, "
        f"{int(electrons.alive.sum())} live lanes): {c['pairs']} (lane, "
        f"segment) pairs, live lanes by segments walked "
        f"{c['lanes_by_segments']}")
    log(f"  {name}: the float bar needed the quantum allowance for "
        f"{quantum or 'no species'}")
    t = time_push(f"{name} electrons", electrons, interp, nb, g, n_walk,
                  c["pairs"])
    return max(errs), quantum, t


def recon_drift(name, sim):
    """RECON_DRIFT_STEPS steps from finalize: finite energies, the total
    within recon_drift_limit, and each species' dropped movers (logged,
    returned).  On trecon the trajectories are collected at step 0 and
    after every step."""
    import math
    tracers = name == "trecon"
    e0 = sum(sim.energies().values())
    if tracers:
        sim.collect_trajectories()
    for _ in range(RECON_DRIFT_STEPS):
        sim.advance_steps(1)
        if tracers:
            sim.collect_trajectories()
    e1 = sim.energies()
    if not all(math.isfinite(v) for v in e1.values()):
        raise AssertionError(f"{name}: non-finite energies {e1}")
    drift = (sum(e1.values()) - e0) / e0
    limit = recon_drift_limit(name)
    if not abs(drift) <= limit:
        raise AssertionError(f"{name}: total energy moved {drift:.4e} in "
                             f"{RECON_DRIFT_STEPS} steps (limit {limit:.4e})")
    nm = sim.mover_counts()
    log(f"  {name}: total energy {e0!r} at step 0, {sum(e1.values())!r} at "
        f"step {RECON_DRIFT_STEPS} ({drift:.4e}, limit {limit:.4e}"
        + (", twice the JAX package's at the tests' size" if limit >
           RECON_DRIFT_BAR else "") + f"); dropped movers {nm}")
    return drift, nm


def recon_readers(name, sim, tmp):
    """The port's readers on dumps of the deck's state: fields and the
    electrons' hydro bitwise the state on the card, the electrons' particle
    records bitwise ``center_p`` of the state, the native particle read
    equal to the numpy read.  Returns each read's ms."""
    import numpy as np
    from vpic_tpu_torch.interop import to_numpy
    from vpic_tpu_torch.io import dump, native, readers
    from vpic_tpu_torch.particles import push
    st, g, s = sim.state, sim.grid, sim.step_count
    el = RECON[name]["electrons"]
    base = os.path.join(tmp, "readers")
    sim.dump_fields(os.path.join(base, "f"))
    sim.dump_hydro(el, os.path.join(base, "h"))
    sim.dump_particles(el, os.path.join(base, "p"))
    path = lambda k: os.path.join(base, f"{k}.{s}.0")
    ms, out = {}, {}
    for key, fn in (("read_fields", lambda: readers.read_fields(path("f"))),
                    ("read_hydro", lambda: readers.read_hydro(path("h"))),
                    ("read_particles",
                     lambda: readers.read_particles(path("p"))),
                    ("native.read_particles",
                     lambda: native.read_particles(path("p")))):
        out[key] = fn()
        ms[key] = timed_call(fn)
    _, fields = out["read_fields"]
    for c in fields:
        if c != "materials" and not np.array_equal(
                fields[c], to_numpy(getattr(st.field, c))):
            raise AssertionError(f"{name}: read_fields {c} differs from the "
                                 "state on the card")
    _, hydro = out["read_hydro"]
    h = to_numpy(sim._hydro(el)[0])
    for k, col in enumerate(readers.HYDRO_NAMES):
        if not np.array_equal(hydro[col].reshape(-1), h[:, k]):
            raise AssertionError(f"{name}: read_hydro {col} differs")
    sp = st.species[sim._species_by_name(el)["sid"]]
    c = push.center_p(sp, st.interpolator, g)
    alive = to_numpy(sp.alive)
    _, rec, _ = out["read_particles"]
    for k in readers.PARTICLE_REC.names:
        if not np.array_equal(rec[k], to_numpy(getattr(c, k))[alive]):
            raise AssertionError(f"{name}: read_particles {k} differs from "
                                 "center_p on the card")
    with open(path("p"), "rb") as f:
        dump.read_header_v0(f)
        dump.read_array_header(f)
        raw = np.fromfile(f, "<f4").reshape(-1, 8)
    if not np.array_equal(out["native.read_particles"], raw):
        raise AssertionError(f"{name}: native.read_particles differs from "
                             "the numpy read")
    log(f"  {name} readers: fields and {el} hydro bitwise the state on the "
        f"card, {rec.shape[0]} particle records bitwise center_p, the "
        "native read equal to numpy's; ms: "
        + ", ".join(f"{k} {v:.3f}" for k, v in ms.items()))
    return ms


def recon_tracers(sim, tmp):
    """The trajectories collected on trecon (recon_drift): both layouts of
    dump_traj read back with the port's readers, one row per tag and step,
    positions inside the box, per-tag files equal to the consolidated ones;
    the H5Part file where h5py is installed (it is not on every machine;
    the CPU tests write and read it); a checkpoint/restore round trip of
    the records and the flushed watermark; then one collect_trajectories
    call timed.  Returns its ms."""
    import importlib.util
    import numpy as np
    from vpic_tpu_torch.io import tracers
    g = sim.grid
    n_tags = 1024
    steps = RECON_DRIFT_STEPS + 1
    d = os.path.join(tmp, "traj")
    sim.dump_traj(os.path.join(d, "one"))
    sim.dump_traj(os.path.join(d, "per_tag"), per_tag_files=True)
    one = tracers.read_traj_dir(os.path.join(d, "one"), "e_tracer")
    per = tracers.read_traj_dir(os.path.join(d, "per_tag"), "e_tracer")
    if sorted(one) != list(range(1, n_tags + 1)) or sorted(per) != \
            sorted(one):
        raise AssertionError(f"trecon tracers: tags {len(one)}/{len(per)}")
    want_t = (np.arange(steps) * g.dt).astype(np.float32)
    for tag, rows in one.items():
        if rows.shape != (steps, 8) or not np.array_equal(rows[:, 0],
                                                           want_t):
            raise AssertionError(f"tag {tag}: rows {rows.shape}, one per "
                                 f"step expected")
        if not np.array_equal(rows, per[tag]):
            raise AssertionError(f"tag {tag}: per-tag file differs")
        x, y, z = tracers.global_positions(g, rows)
        if not (np.all((x >= g.gx0) & (x <= g.gx1))
                and np.all((z >= g.gz0) & (z <= g.gz1))):
            raise AssertionError(f"tag {tag}: a position outside the box")
    if importlib.util.find_spec("h5py") is None:
        h5 = "not written: h5py is not installed here"
    else:
        import h5py
        path = sim.dump_tracers_h5part(os.path.join(d, "tracers.h5part"),
                                       "e_tracer")
        with h5py.File(path, "r") as f:
            if len(f.keys()) != steps or set(np.asarray(
                    f[f"Step#{steps - 1}"]["q"])) != set(range(1,
                                                               n_tags + 1)):
                raise AssertionError("trecon tracers: H5Part steps or tags")
        h5 = "written and read back"
    acc = sim._traj
    rec = acc.records("e_tracer").copy()
    mark = dict(acc._flushed)
    ck = os.path.join(tmp, "traj_ck", "restart")
    sim.checkpoint(ck)
    sim._traj = None
    sim.restore(ck)
    if not (np.array_equal(sim._traj.records("e_tracer"), rec)
            and sim._traj._flushed == mark == {"e_tracer": rec.shape[0]}):
        raise AssertionError("trecon tracers: the checkpoint lost records "
                             "or the watermark")
    collect_ms = timed_call(sim.collect_trajectories)
    log(f"  trecon tracers: {n_tags} tags x {steps} steps in both layouts "
        f"read back (one row per tag and step, inside the box, per-tag "
        f"files equal to the consolidated one); H5Part {h5}; the .traj.npz "
        f"sidecar kept {rec.shape[0]} records and the watermark; one "
        f"collect_trajectories {collect_ms:.3f} ms")
    return collect_ms


def recon_cli(name, tmp):
    """The CLI in a process of its own at full size for RECON_STEPS steps
    with the deck's dumps on, then again from its step-RECON_RESTART
    checkpoint: every step-RECON_STEPS dump byte for byte the first run's,
    the energies of the last step equal.  Returns the two runs' seconds."""
    spec = RECON[name]
    deck = f"vpic_tpu_torch/decks/{name}.py"
    first, second = (os.path.join(tmp, name, run)
                     for run in ("first", "second"))
    # the rotating checkpoints: restart1 holds step RECON_RESTART
    ck = (os.path.join(first, "restart") if spec["cli_checkpoints"]
          else first)
    secs = []
    for out, args in ((first, []), (second, [
            "--restart", os.path.join(ck, "restart1", "restart")])):
        if spec["cli_checkpoints"]:
            args += ["--checkpoint-dir", os.path.join(out, "restart"),
                     "--checkpoint-interval", str(RECON_RESTART)]
        env = dict(spec["full"], **spec["diag"], **{spec["out"]: out})
        secs.append(deck_cli(deck, env, RECON_STEPS, *args))
    t1, t2 = secs
    tag = f".{RECON_STEPS}.0"
    dumps = sorted(os.path.relpath(os.path.join(d, f), first)
                   for d, _, files in os.walk(first) for f in files
                   if f.endswith(tag)
                   or os.path.basename(d) == f"T.{RECON_STEPS}")
    kinds = collections.Counter(p.split(os.sep)[0] for p in dumps)
    if kinds != spec["dumps"]:
        raise AssertionError(f"{name}: step-{RECON_STEPS} dumps "
                             f"{dict(kinds)}, expected {spec['dumps']}")
    nbytes = 0
    for rel in dumps:
        a = open(os.path.join(first, rel), "rb").read()
        if a != open(os.path.join(second, rel), "rb").read():
            raise AssertionError(f"{name} {rel}: the restarted run's bytes "
                                 "differ")
        nbytes += len(a)
    en = [read_energies(os.path.join(r, spec["energies"])) for r in
          (first, second)]
    if en[0][RECON_STEPS] != en[1][RECON_STEPS] or min(en[1]) <= \
            RECON_RESTART:
        raise AssertionError(f"{name}: the energies of step {RECON_STEPS} "
                             "differ, or the restart did not continue from "
                             f"step {RECON_RESTART}")
    log(f"  {name} CLI: {RECON_STEPS} steps {t1:.2f} s, restart "
        f"{RECON_RESTART}->{RECON_STEPS} {t2:.2f} s; all {len(dumps)} step-"
        f"{RECON_STEPS} dumps ({dict(kinds)}, {nbytes} bytes) and the "
        "energies byte-identical")
    return t1, t2


def phase_recon(device, card):
    """Phase 12: trecon, sigma and turbulence_fan at full size.  Returns
    the push kernel's per-deck fields of the kernels' record, and logs the
    rest."""
    import shutil
    import tempfile
    import torch
    from vpic_tpu_torch.engine.step import CORE_PHASES
    fields = {}
    for name in RECON:
        tmp = tempfile.mkdtemp(prefix=f"{name}_smoke_")
        try:
            sim = port_deck(name, device, RECON[name]["full"])
            g = sim.grid
            log(f"  {name}: {g.nx}x{g.ny}x{g.nz} cells, nv {g.nv}, species "
                + ", ".join(f"{sp.name} {int(sp.np)}/{sp.max_np}"
                            for sp in sim.state.species)
                + f", field faces {g.fbc}, particle faces {g.pbc}")
            err, quantum, t = recon_kernel(name, sim)
            drift, nm = recon_drift(name, sim)
            # the timed windows start on a sort super-cycle, as phase 5's
            sim.advance_steps(-sim.step_count % (sim.opts.resort_interval * 4))
            launches, step_s = push_only_windows(sim, name)
            trace = phase_trace(sim, step_s, f"{name} path")
            read_ms = recon_readers(name, sim, tmp)
            collect_ms = (recon_tracers(sim, tmp) if name == "trecon"
                          else None)
            del sim
            torch.cuda.empty_cache()
            t1, t2 = recon_cli(name, tmp)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        parts = trace["parts"]
        log(f"{name} path ({card}): step {step_s * 1e3:.4f} ms (median of "
            f"{WINDOWS} windows of {STEPS} steps), device busy "
            f"{trace['busy_ms']:.4f} ms/step, {trace['ops']:.1f} ops/step, "
            f"idle share {1 - trace['busy_ms'] / (step_s * 1e3):.4f}; sort / "
            f"push / field busy " + " / ".join(
                f"{parts[k]['busy_ms']:.4f}" for k in CORE_PHASES)
            + f" ms; push kernel on the electrons {t['kernel_ms']:.4f} ms "
            f"alone against a {t['bound_ms']:.4f} ms bound; drift "
            f"{drift:.4e} over {RECON_DRIFT_STEPS} steps; dropped movers "
            f"{nm}; CLI {t1:.2f} s and {t2:.2f} s")
        fields.update({
            f"{name}_launches": launches["push_walk"],
            f"{name}_launches_per_step": launches["push_walk"]
            / (WINDOWS * STEPS),
            f"{name}_max_abs_err": err,
            f"{name}_quantum_species": quantum,
            f"{name}_step_ms": step_s * 1e3,
            f"{name}_busy_ms": trace["busy_ms"],
            f"{name}_ops_per_step": trace["ops"],
            f"{name}_dropped_movers": sum(nm.values()),
            **{f"{name}_{k}": v for k, v in t.items()},
            **{f"{name}_{k.replace('.', '_')}_ms": v
               for k, v in read_ms.items()},
        })
        if collect_ms is not None:
            fields["trecon_collect_trajectories_ms"] = collect_ms
    return fields


# -- phase 13: open particle boundaries --------------------------------------

# tests/test_boundary_emit.py:drifting_box at production size: 2D 256^2
# cells, 64 per cell (4 194 304 electrons in 1.25x the slots), ut 0.3 and a
# drift of 0.5 along x; absorbing fields on the x faces, y and z periodic.
# Its 16^2 version (16 per cell) runs on the card and on the CPU.
OPEN_FULL = dict(nx=256, ppc=64)
OPEN_SMALL = dict(nx=16, ppc=16)
OPEN_VARIANTS = ("absorb", "tally", "reflux", "link", "emitter", "injector")
OPEN_WARM, OPEN_SMALL_STEPS, OPEN_RESTART = 25, 12, 10
# the collisions deck at its defaults (32^2, 64 per cell) and at 256^2;
# the CLI runs it at its defaults
COLL_SIZES = {"32^2": {}, "256^2": {"COLL_NX": "256"}}
COLL_DECK, COLL_CLI_STEPS = "vpic_tpu_torch/decks/collisions.py", 50


def open_box(device, variant, nx, ppc):
    """The open box with the x faces of ``variant``: "absorb" (both x faces
    absorbing), "tally" (AbsorbTally), "reflux" (MaxwellianReflux, ut 0.2
    both ways), "link" (LinkBoundary), "emitter" (absorbing, the uniform
    ex = -0.1 of tests/test_boundary_emit.py:_emitter_sim and a
    ChildLangmuir emitter of 2 lanes per cell on the low x face) or
    "injector" (absorbing, and the user_particle_injection hook refilling
    the low x cells with 8 nx lanes per step through ``make_injector``,
    rhob updated, positions, momenta and ages drawn from the state's
    random state)."""
    import dataclasses
    from vpic_tpu_torch import Simulation
    from vpic_tpu_torch.boundary.models import (AbsorbTally, LinkBoundary,
                                                MaxwellianReflux)
    from vpic_tpu_torch.core import random as rnd
    from vpic_tpu_torch.core.types import PERIODIC_FIELDS
    from vpic_tpu_torch.emit.models import ChildLangmuir
    sim = Simulation(seed=2, device=device)
    sim.define_units(1.0, 1.0)
    L = 1.0
    sim.define_timestep(0.7 * sim.courant_length(L, L, L, nx, nx, 1))
    sim.define_absorbing_grid(0, 0, 0, L, L, L, nx, nx, 1)
    for face in (1, 2, 4, 5):
        sim.set_domain_field_bc(face, PERIODIC_FIELDS)
        sim.set_domain_particle_bc(face, "periodic")
    n = nx * nx * ppc
    e = sim.define_species("electron", -1.0, int(1.25 * n))
    sim.inject_particle(
        e, sim.uniform(n, 0.05, 0.95), sim.uniform(n, 0, L),
        sim.uniform(n, 0, L), sim.maxwellian(n, 0.3) + 0.5,
        sim.maxwellian(n, 0.3), sim.maxwellian(n, 0.3), q=-1.0 / n)
    handler = dict(tally=AbsorbTally(n_species=1),
                   reflux=MaxwellianReflux(ut_para=(0.2,), ut_perp=(0.2,)),
                   link=LinkBoundary(capacity=65536)).get(variant)
    if handler is not None:
        sim.define_boundary(handler)
        for face in (0, 3):
            sim.set_domain_particle_bc(face, handler)
    hooks = {}
    if variant == "emitter":
        sim.set_field("ex", lambda x, y, z: -0.1)
        sim.define_surface_emitter(ChildLangmuir(
            sid=0, q_m=-1.0, components=((), ()), n_emit_per_face=2,
            ut_para=0.05, ut_perp=0.05), face=0)
    if variant == "injector":
        inj = sim.make_injector(e)
        K, dx = 8 * nx, sim.grid.dx

        def refill(state, acc, f):
            rng, sub = rnd.split(state.rng)
            state = dataclasses.replace(state, rng=rng)
            ks = rnd.split(sub, 7)
            u = lambda k, hi: rnd.uniform(ks[k], K, 0.0, hi).double()
            m = lambda k: 0.3 * rnd.normal(ks[k], K)
            return inj(state, acc, f, x=u(0, dx), y=u(1, L), z=u(2, L),
                       ux=m(3) + 0.5, uy=m(4), uz=m(5), q=-1.0 / n,
                       age=rnd.uniform(ks[6], K), update_rhob=True)

        hooks["user_particle_injection"] = refill
    sim.finalize(**hooks)
    return sim


def alive_count(sim):
    return int(sim.state.species[0].alive.sum())


def open_counts(sim, variant, n0):
    """The variant's particle counts: live lanes, lanes gone since
    finalize, and the tally or the link ring's count."""
    out = dict(alive=alive_count(sim), gone=n0 - alive_count(sim),
               dropped=sim.mover_counts()["electron"])
    if variant == "tally":
        out["tally"] = int(sim.boundary_tallies(0)[0])
    if variant == "link":
        out["ring"] = int(sim.boundary_tallies(0)["count"])
    return out


def open_windows(sim, label, unfused=False, e_refs=None):
    """WINDOWS timed windows of STEPS steps with the launch counts set to 0
    just before and read just after: per step one push launch (unfused:
    one deposit launch and one walk_only launch) and num_comm_round
    walk_only launches, finite energies, no dropped movers; with
    ``e_refs`` the energies at the end of each window equal them to 1e-6.
    Returns (launches, median step s, the energies of each window)."""
    import math
    import statistics
    import torch
    from vpic_tpu_torch.particles import deposit_cuda, push_cuda, sort_cuda
    for mod in (push_cuda, deposit_cuda, sort_cuda):
        mod.reset_launch_counts()
    step_s, energies = [], []
    for w in range(WINDOWS):
        nm0 = sim.mover_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sim.advance_steps(STEPS)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        e1, nm1 = sim.energies(), sim.mover_counts()
        if not all(math.isfinite(v) for v in e1.values()):
            raise AssertionError(f"{label}: non-finite energies {e1}")
        drops = {k: nm1[k] - nm0[k] for k in nm1}
        if any(drops.values()):
            raise AssertionError(f"{label}: dropped movers {drops}")
        if e_refs is not None:
            for k, v in e_refs[w].items():
                if abs(e1[k] - v) > 1e-6 * abs(v) + 1e-12:
                    raise AssertionError(f"{label}: energy {k} {e1[k]!r} vs "
                                         f"the fused path's {v!r}")
        energies.append(e1)
        step_s.append(dt / STEPS)
        log(f"  {label} window {w + 1}/{WINDOWS} (steps "
            f"{sim.step_count - STEPS}-{sim.step_count}): {dt:.4f} s, "
            f"{dt / STEPS * 1e3:.4f} ms/step, live {alive_count(sim)}"
            + (", energies equal the fused path's to 1e-6"
               if e_refs is not None else ""))
    launches = dict(push_walk=push_cuda.launches["push"],
                    walk_only=push_cuda.launches["walk_only"],
                    deposit_sorted=deposit_cuda.launches["deposit_sorted"],
                    **sort_cuda.launches)
    steps = WINDOWS * STEPS
    rounds = sim.opts.num_comm_round
    want = dict(push_walk=0 if unfused else steps,
                walk_only=steps * (rounds + int(unfused)),
                deposit_sorted=steps if unfused else 0)
    if any(launches[k] != v for k, v in want.items()) or sum(
            launches.values()) != sum(want.values()):
        raise AssertionError(f"{label} launches {launches}, expected {want}")
    med = statistics.median(step_s)
    log(f"  {label}: median {med * 1e3:.4f} ms/step (min "
        f"{min(step_s) * 1e3:.4f}, max {max(step_s) * 1e3:.4f}), kernel "
        f"launches {launches}")
    return launches, med, energies


def walk_traffic(st, nb, g, seg_cap):
    """The plain walk from WalkState ``st``: (lane, segment) pairs, the
    distinct voxels whose neighbor table a crossing reads, and the
    distinct voxels a segment deposits into."""
    import torch
    from vpic_tpu_torch.particles import push
    pairs, crossed, deposited = 0, [], []
    for _ in range(seg_cap):
        if not bool(st.active.any()):
            break
        pairs += int(st.active.sum())
        before = st
        st, dep_vox, _ = push.walk_segment(st, nb, g)
        deposited.append(dep_vox[before.active])
        # a lane that walks on or stops read its voxel's neighbor entry;
        # one that ends its streak in the voxel read none
        read = before.active & (st.active | (st.pcode != before.pcode))
        crossed.append(before.vox[read])
    distinct = lambda v: int(torch.unique(torch.cat(v)).numel()) if v else 0
    return pairs, distinct(crossed), distinct(deposited)


def time_walk(label, st, nb, g, n_iter):
    """The walk_only entry on ``st``: the wrapper (CUDA events), the kernel
    alone (profiler) and the plain version, each against the bound of
    what it must move.  The kernel: per lane x, y, z, vox, ux, uy, uz, q,
    rx, ry, rz, pcode and active read and the 11 words of its state
    written, one neighbor entry of each voxel a crossing leaves, the 12
    fixed-point words (int64) of each voxel it deposits into written.
    The wrapper (the function ``acc -> acc + deposits``): the lanes and
    neighbor entries, the (nv, 12) float32 accumulator read and written.
    SEGMENT_OPS per walked segment.  Fails where a time beats its
    bound."""
    import torch
    from vpic_tpu_torch.particles import push, push_cuda
    acc0 = torch.zeros((g.nv, 12), dtype=torch.float32, device=st.x.device)
    run_k = lambda: push_cuda.streak_walk(st, acc0, nb, g, n_iter)
    run_p = lambda: push.streak_walk(st, acc0, nb, g, n_iter)
    p1, k1, k2, p2 = (cuda_ms(run_p, 5), cuda_ms(run_k, 20),
                      cuda_ms(run_k, 20), cuda_ms(run_p, 5))
    kernel_ms, ops = profiled_ms(run_k, 20, ("push_walk_kernel",), 1)
    n = st.x.shape[0]
    pairs, crossed, deposited = walk_traffic(st, nb, g, 4 * n_iter + 8)
    lanes = n * (12 * 4 + 1 + 11 * 4) + crossed * 4
    bound_ms, bound_by = bound(lanes + deposited * 12 * 8,
                               SEGMENT_OPS * pairs)
    wrapper_bound_ms, _ = bound(lanes + g.nv * 12 * 4 * 2,
                                SEGMENT_OPS * pairs)
    held_to_bound(f"{label}: the walk kernel alone", kernel_ms, bound_ms)
    held_to_bound(f"{label}: the walk wrapper", min(k1, k2),
                  wrapper_bound_ms)
    log(f"  timing, {label} ({int(st.active.sum())} active of {n} lanes, "
        f"{pairs} (lane, segment) pairs, {crossed} voxels crossed out of, "
        f"{deposited} deposited into): wrapper {k1:.4f} / {k2:.4f} ms "
        f"({ops:.1f} device ops per call; bound {wrapper_bound_ms:.4f} ms), "
        f"kernel alone {kernel_ms:.4f} ms, plain {p1:.4f} / {p2:.4f} ms; "
        f"the kernel's bound {bound_ms:.4f} ms ({bound_by}), the kernel at "
        f"{bound_ms / kernel_ms:.4f} of it")
    return dict(ms=min(k1, k2), kernel_ms=kernel_ms, plain_ms=min(p1, p2),
                bound_ms=bound_ms, bound_by=bound_by,
                wrapper_bound_ms=wrapper_bound_ms)


def open_push(sim):
    """The step's push of the open box's sorted electrons (the kernel,
    pending lanes left to the rounds): (sorted species, pushed species,
    interpolator, neighbor table, n_walk)."""
    import torch
    from vpic_tpu_torch.engine.step import walk_segments
    from vpic_tpu_torch.particles import aux, push_cuda
    st, g = sim.state, sim.grid
    nb, interp = st.grid_arrays.neighbor, st.interpolator
    n_walk = walk_segments(g, sim.opts)
    sp = aux.sort_p(st.species[0])
    acc0 = torch.zeros((g.nv, 12), dtype=torch.float32, device=sp.dx.device)
    pushed, _ = push_cuda.advance_p(sp, interp, acc0, nb, g, n_walk=n_walk,
                                    count_pending=False)
    return sp, pushed, interp, nb, n_walk


def open_kernel_push(sim, variant):
    """The push entry with count_pending=False on the open box after its
    timed windows, against its plain version and twin: lanes stopped on
    the x faces with NEIGHBOR_ABSORB (absorb) or their handler's codes
    (tally).  Returns (max abs err, timing dict)."""
    from vpic_tpu_torch.core.types import NEIGHBOR_ABSORB
    sp, pushed, interp, nb, n_walk = open_push(sim)
    pc = pushed.pc
    codes = int((pc == NEIGHBOR_ABSORB).sum()) if variant == "absorb" \
        else int((pc <= -9).sum())
    if not codes:
        raise AssertionError(f"open {variant}: the push stopped no lane on "
                             "an x face")
    label = (f"open {variant} {sim.grid.nx}^2 ({codes} lanes stopped on the x "
             "faces)")
    err, quantum = check_bar(check_push, label, sp, interp, nb, sim.grid,
                             n_walk, count_pending=False)
    t = {}
    if variant == "absorb":
        c = walk_counts(sp, interp, nb, sim.grid, n_walk)
        t = time_push(f"open absorb {sim.grid.nx}^2 sorted electrons", sp,
                      interp, nb, sim.grid, n_walk, c["pairs"])
    return err, dict(t, quantum=quantum)


def open_kernel_walk(sim):
    """One round's walk_only launch on its max_inj buffer, on the reflux
    box after its timed windows: the pending lanes of the step's push
    compacted, the reflux handler applied (its lanes walk on with new
    momenta), against the plain walk and twin, and timed.  Returns (max
    abs err, timing dict)."""
    from vpic_tpu_torch.core import random as rnd
    from vpic_tpu_torch.particles import boundary
    _, pushed, _, nb, n_walk = open_push(sim)
    st = sim.state
    sel, valid, b = boundary.pending_buffer(pushed, sim.opts.max_inj)
    b, live, _, _ = boundary.resolve_buffer(
        b, valid, st.field, sim.grid, 0, tuple(sim._boundary_handlers),
        st.boundary_state, rnd.split(st.rng)[1], st.step)
    walk, walkable = boundary.buffer_walk_state(b, live)
    n = int(walkable.sum())
    if not n:
        raise AssertionError("open reflux: no lane to walk in the round")
    label = (f"open reflux round buffer ({int(valid.sum())} pending, {n} "
             f"refluxed, {walk.x.shape[0]} lanes)")
    err, quantum = check_bar(check_walk, label, walk, nb, sim.grid, n_walk)
    return err, dict(time_walk(label, walk, nb, sim.grid, n_walk),
                     quantum=quantum)


def open_small(device):
    """Each variant's 16^2 box for OPEN_SMALL_STEPS steps on the card and
    on the CPU: energies to 1e-6 and equal counts (the card's threefry
    kernel draws the CPU's numbers: uniforms bitwise, normals within a few
    ulps), finite, and no dropped mover, but in the injector box.  That box refills
    8 nx lanes a step into 1.25 n slots and fills them by step 11 or so:
    the lanes that do not fit are dropped and counted, and a step may
    drop lanes only where it leaves the species full."""
    import math
    for variant in OPEN_VARIANTS:
        runs = []
        for dev in (device, "cpu"):
            sim = open_box(dev, variant, **OPEN_SMALL)
            n0 = alive_count(sim)
            for step in range(OPEN_SMALL_STEPS):
                nm0 = sim.mover_counts()["electron"]
                sim.advance_steps(1)
                sp = sim.state.species[0]
                if (sim.mover_counts()["electron"] > nm0
                        and (variant != "injector"
                             or int(sp.np) != sp.max_np)):
                    raise AssertionError(
                        f"open {variant} 16^2 on {dev}: step {step + 1} "
                        f"dropped movers with np {int(sp.np)} of "
                        f"{sp.max_np}")
            runs.append((sim.energies(), open_counts(sim, variant, n0)))
        (eg, cg), (ec, cc) = runs
        if not all(math.isfinite(v) for v in (*eg.values(), *ec.values())):
            raise AssertionError(f"open {variant} 16^2: energies {eg} {ec}")
        worst = max(abs(eg[k] - ec[k]) / abs(ec[k]) for k in ec if ec[k])
        for k in ec:
            if abs(eg[k] - ec[k]) > 1e-6 * abs(ec[k]) + 1e-12:
                raise AssertionError(f"open {variant} 16^2: energy {k} "
                                     f"{eg[k]!r} vs CPU {ec[k]!r}")
        if cg != cc:
            raise AssertionError(f"open {variant} 16^2: counts {cg} vs "
                                 f"CPU {cc}")
        log(f"  open {variant} 16^2, {OPEN_SMALL_STEPS} steps: card {cg}, "
            f"CPU {cc}, largest relative energy difference {worst:.3e} "
            "(within 1e-6)")


def open_variant(device, variant, card, unfused=False, e_refs=None):
    """A variant at full size: OPEN_WARM steps from finalize, then to a
    step that is a multiple of 4 and WINDOWS timed windows of STEPS steps;
    a trace on the unfused path only (phase 19 traces the fused variants,
    graphed and op by op).  Returns (sim, record, window energies)."""
    import math
    label = f"open {variant}" + (" fused_push=False" if unfused else "")
    t0 = time.perf_counter()
    sim = open_box(device, variant, **OPEN_FULL)
    if unfused:
        sim.modify_runparams(fused_push=False)
    n0 = alive_count(sim)
    log(f"  {label}: {sim.grid.nx}x{sim.grid.ny} cells, {n0} electrons in "
        f"{sim.state.species[0].max_np} slots, particle faces "
        f"{sim.grid.pbc}, built in {time.perf_counter() - t0:.2f} s")
    sim.advance_steps(OPEN_WARM)
    e = sim.energies()
    if not all(math.isfinite(v) for v in e.values()):
        raise AssertionError(f"{label}: energies {e} after {OPEN_WARM} steps")
    c = open_counts(sim, variant, n0)
    log(f"  {label} after {OPEN_WARM} steps: {c}, total energy "
        f"{sum(e.values()):.6e}")
    sim.advance_steps(-sim.step_count % 4)
    launches, step_s, energies = open_windows(sim, label, unfused, e_refs)
    # the counts at the end of the windows: a trace that the profiler
    # takes again runs more steps
    c, at = open_counts(sim, variant, n0), sim.step_count
    check_books(label, variant, c)
    rec = dict(step_ms=step_s * 1e3, push_launches=launches["push_walk"],
               push_launches_per_step=launches["push_walk"]
               / (WINDOWS * STEPS),
               walk_only_launches_per_step=launches["walk_only"]
               / (WINDOWS * STEPS), **c)
    trace = ""
    if unfused:
        # the unfused push sorts at 256^2 only on the species' own
        # interval (sorted_deposit is off above nv = 120 000), which this
        # deck leaves 0
        t = phase_trace(sim, step_s, f"{label} path",
                        ("step.push", "step.field", "step.boundary"))
        p = t["parts"]
        rec.update(busy_ms=t["busy_ms"], ops_per_step=t["ops"],
                   idle_share=1 - t["busy_ms"] / (step_s * 1e3),
                   host_reads_per_step=t["reads"],
                   boundary_busy_ms=p["step.boundary"]["busy_ms"])
        trace = (f", device busy {t['busy_ms']:.4f} ms/step, "
                 f"{t['ops']:.1f} ops/step, idle share "
                 f"{rec['idle_share']:.4f}, host reads {t['reads']:.1f}/"
                 "step; busy ms " + ", ".join(
                     f"{k} {v['busy_ms']:.4f}" for k, v in p.items()))
    log(f"{label} path ({card}): step {step_s * 1e3:.4f} ms" + trace
        + f"; launches per step: push {rec['push_launches_per_step']}, "
        f"walk_only {rec['walk_only_launches_per_step']}; counts at step "
        f"{at} {c}")
    return sim, rec, energies


def open_restart(device, variant, tmp):
    """Two builds from one seed (equal checksum_fields); the first runs
    OPEN_RESTART steps, a checkpoint and OPEN_RESTART more, the second is
    restored from the checkpoint and runs OPEN_RESTART steps: every array
    of the two states (fields, particles, rng, boundary_state) bitwise
    equal."""
    import numpy as np
    import torch
    from vpic_tpu_torch.interop import state_to_numpy
    a = open_box(device, variant, **OPEN_FULL)
    b = open_box(device, variant, **OPEN_FULL)
    if a.checksum_fields() != b.checksum_fields():
        raise AssertionError(f"open {variant}: two builds from one seed "
                             "differ")
    a.advance_steps(OPEN_RESTART)
    path = os.path.join(tmp, f"open_{variant}")
    t0 = time.perf_counter()
    a.checkpoint(path)
    save_s = time.perf_counter() - t0
    a.advance_steps(OPEN_RESTART)
    first = state_to_numpy(a.state)
    del a
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    b.restore(path)
    load_s = time.perf_counter() - t0
    b.advance_steps(OPEN_RESTART)
    second = state_to_numpy(b.state)
    same = lambda x, y: (x.dtype == y.dtype and x.shape == y.shape
                         and x.tobytes() == y.tobytes())
    bad = [k for k in first if k not in second or not same(
        np.asarray(first[k]), np.asarray(second[k]))]
    if set(first) != set(second) or bad:
        raise AssertionError(f"open {variant}: the restarted run differs in "
                             f"{bad[:8]}")
    log(f"  open {variant} restart: checksum_fields of two builds equal "
        f"({b.checksum_fields()[:16]}...), step {2 * OPEN_RESTART} of the "
        f"restored run bitwise the first run's ({len(first)} arrays: fields,"
        f" particles, rng {first['rng'].tolist()}, boundary_state); save "
        f"{save_s:.2f} s, restore {load_s:.2f} s")


def phase_collisions(device, card):
    """The collisions deck on the card at its defaults and at 256^2: the
    hook alone keeps sum |u|^2 to float roundoff, and over WARM_STEPS +
    WINDOWS * STEPS graphed steps the anisotropy falls with no dropped
    mover and finite energies (phase 19 times both sizes, graphed and op
    by op, and traces them); then the deck at its defaults through the
    CLI in a process of its own for COLL_CLI_STEPS steps.  Returns the
    record's fields."""
    import importlib
    import math
    import torch
    fields = {}
    mod = importlib.import_module("vpic_tpu_torch.decks.collisions")
    for name, size in COLL_SIZES.items():
        sim = _coll_graph_deck(size)(device)
        if not sim.graphed:
            raise AssertionError(f"collisions {name}: not graphed")
        sp = sim.state.species[0]
        u2 = lambda s: float((s.ux.double() ** 2 + s.uy.double() ** 2
                              + s.uz.double() ** 2)[s.alive].sum())
        hook = sim._hooks["user_particle_collisions"]
        k0, k1 = u2(sp), u2(hook(sim.state).species[0])
        if not abs(k1 - k0) <= 1e-6 * k0:
            raise AssertionError(f"collisions {name}: the hook changed "
                                 f"sum |u|^2 by {(k1 - k0) / k0:.3e}")
        a0 = mod.anisotropy(sim)
        sim.advance_steps(WARM_STEPS + WINDOWS * STEPS)
        a1, e1 = mod.anisotropy(sim), sim.energies()
        if not a1 < a0:
            raise AssertionError(f"collisions {name}: anisotropy {a0} -> "
                                 f"{a1}")
        if sim.mover_counts()["electron"] or not all(
                math.isfinite(v) for v in e1.values()):
            raise AssertionError(f"collisions {name}: movers "
                                 f"{sim.mover_counts()}, energies {e1}")
        log(f"collisions {name} ({card}): {int(sp.np)} electrons; the "
            f"hook alone changes sum |u|^2 by {(k1 - k0) / k0:.3e}; "
            f"anisotropy {a0:.4f} -> {a1:.4f} over {sim.step_count} graphed "
            "steps, no dropped mover (timed in phase 19)")
        key = f"collisions_{name.replace('^2', 'sq')}"
        fields[f"{key}_hook_u2_change"] = (k1 - k0) / k0
        del sim
        torch.cuda.empty_cache()
    cli_s = deck_cli(COLL_DECK, {}, COLL_CLI_STEPS)
    log(f"collisions CLI ({card}): {COLL_DECK} --num-step {COLL_CLI_STEPS} "
        f"in {cli_s:.2f} s")
    fields["collisions_cli_s"] = cli_s
    return fields


def phase_open(device, card):
    """Phase 13: the open box's variants at full size, the kernels on its
    open faces, the 16^2 boxes on card and CPU, the restarts, and the
    collisions deck.  Returns the push record's open_* and collisions_*
    fields."""
    import shutil
    import tempfile
    import torch
    open_small(device)
    fields, errs = {}, []
    refs = None
    for variant in OPEN_VARIANTS:
        sim, rec, energies = open_variant(device, variant, card)
        if variant == "absorb":
            refs = energies
            fields["open_launches"] = rec["push_launches"]
            fields["open_walk_only_launches_per_step"] = rec[
                "walk_only_launches_per_step"]
        if variant in ("absorb", "tally"):
            err, t = open_kernel_push(sim, variant)
            errs.append(err)
            fields[f"open_{variant}_quantum"] = t.pop("quantum")
            fields.update({f"open_{k}": v for k, v in t.items()})
        if variant == "reflux":
            err, t = open_kernel_walk(sim)
            errs.append(err)
            fields.update({f"open_walk_{k}": v for k, v in t.items()})
        fields.update({f"open_{variant}_{k}": v for k, v in rec.items()})
        del sim
        torch.cuda.empty_cache()
    if fields["open_absorb_gone"] != fields["open_tally_tally"]:
        raise AssertionError(
            f"open: absorb lost {fields['open_absorb_gone']} lanes, the "
            f"tally counted {fields['open_tally_tally']}")
    log(f"  open: absorbed {fields['open_absorb_gone']} = tally "
        f"{fields['open_tally_tally']} = n0 - alive of the tally run, at "
        "the end of the windows")
    sim, rec, _ = open_variant(device, "absorb", card, unfused=True,
                               e_refs=refs)
    fields.update({f"open_absorb_unfused_{k}": v for k, v in rec.items()})
    del sim
    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="open_smoke_")
    try:
        for variant in ("reflux", "emitter"):
            open_restart(device, variant, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    fields["open_max_abs_err"] = max(errs)
    fields.update(phase_collisions(device, card))
    return fields


# -- phase 14: materials -----------------------------------------------------

# the material box: tests/test_materials_diag.py:wave_box's fields and
# materials in the bench deck's plasma (vpic_tpu_torch/decks/bench_deck.py),
# 2D 256^2, 32 per cell: 2 097 152 electrons and as many ions; copper
# (sigma 5) on x > 0.75, a dielectric (eps 2, 3, 4, mu 1.5) on 0.25 < y <
# 0.5 defined after it, so that it wins where they overlap.  The 32^2
# version (8 per cell) runs on the card and on the CPU.
MAT_FULL = dict(nx=256, ppc=32)
MAT_SMALL = dict(nx=32, ppc=8)
MAT_SMALL_STEPS, MAT_STEPS, MAT_CKPT = 16, 25, 10
# the JAX test's damping run: 20 steps at 16^2 and 0.6 Courant is the
# physical time of 320 steps at 256^2
WAVE_NX, WAVE_STEPS, WAVE_BAR = 256, 320, 0.75


def material_box(device, nx, ppc, vacuum=False, seed=0):
    """The material box on ``device`` (``vacuum``: the same deck with one
    vacuum material and no region)."""
    import dataclasses
    import numpy as np
    from vpic_tpu_torch import Simulation
    sim = Simulation(seed=seed, device=device)
    sim.opts = dataclasses.replace(sim.opts, resort_interval=2)
    sim.define_units(1.0, 1.0)
    L = 1.0
    sim.define_timestep(0.9 * sim.courant_length(L, L, L, nx, nx, 1))
    sim.define_periodic_grid(0, 0, 0, L, L, L, nx, nx, 1)
    sim.define_material("vacuum")
    if not vacuum:
        copper = sim.define_material("copper", sigma=5.0)
        diel = sim.define_material("dielectric", eps=(2.0, 3.0, 4.0),
                                   mu=1.5)
        sim.set_region_material(lambda x, y, z: x > 0.75, copper)
        sim.set_region_material(lambda x, y, z: (y > 0.25) & (y < 0.5),
                                diel)
    npart = nx * nx * ppc
    e = sim.define_species("electron", -1.0, int(npart * 1.0625))
    i = sim.define_species("ion", 1.0 / 25.0, int(npart * 1.0625),
                           sort_interval=8)
    rng = np.random.default_rng(seed + 1)
    x, y, z = (rng.uniform(0, L, npart) for _ in range(3))
    for sp, sgn, ut in ((e, -1.0, 0.2), (i, 1.0, 0.04)):
        sim.inject_particle(sp, x, y, z, *(rng.normal(0, ut, npart)
                                           for _ in range(3)),
                            q=sgn / npart)
    sim.set_field("ey", lambda x, y, z: 0.1 * np.sin(2 * np.pi * x))
    sim.set_field("cbz", lambda x, y, z: 0.1 * np.sin(2 * np.pi * x))
    sim.finalize()
    return sim


def wave_box(device, conductor, nx):
    """tests/test_materials_diag.py:wave_box at ``nx``^2 on ``device``:
    no particles, ey = cbz = 0.1 sin(2 pi x), copper on x > 0.5."""
    import numpy as np
    from vpic_tpu_torch import Simulation
    sim = Simulation(seed=4, device=device)
    sim.define_units(1.0, 1.0)
    L = 1.0
    sim.define_timestep(0.6 * sim.courant_length(L, L, L, nx, nx, 1))
    sim.define_periodic_grid(0, 0, 0, L, L, L, nx, nx, 1)
    sim.define_material("vacuum")
    if conductor:
        copper = sim.define_material("copper", eps=1.0, sigma=5.0)
        sim.set_region_material(lambda x, y, z: x > 0.5, copper)
    sim.set_field("ey", lambda x, y, z: 0.1 * np.sin(2 * np.pi * x))
    sim.set_field("cbz", lambda x, y, z: 0.1 * np.sin(2 * np.pi * x))
    sim.finalize()
    return sim


def material_arrays(sim):
    """The state's id grids and coefficient table as numpy arrays."""
    from vpic_tpu_torch.interop import state_to_numpy
    return {k: v for k, v in state_to_numpy(sim.state).items()
            if k.startswith(("material_grid/", "materials/"))}


def material_small(device):
    """The 32^2 material box on the card and on the CPU for
    MAT_SMALL_STEPS steps: ids and coefficient table bitwise equal,
    energies to 1e-6, finite, no dropped mover.  Returns the largest
    relative energy difference."""
    import math
    import numpy as np
    runs = []
    for dev in (device, "cpu"):
        sim = material_box(dev, **MAT_SMALL)
        arrays = material_arrays(sim)
        sim.advance_steps(MAT_SMALL_STEPS)
        runs.append((arrays, sim.energies(), sim.mover_counts()))
    (ag, eg, ng), (ac, ec, nc) = runs
    if set(ag) != set(ac) or not all(
            ag[k].dtype == ac[k].dtype and np.array_equal(ag[k], ac[k])
            for k in ac):
        raise AssertionError("material box 32^2: ids or table differ "
                             "between card and CPU")
    if not all(math.isfinite(v) for v in (*eg.values(), *ec.values())):
        raise AssertionError(f"material box 32^2: energies {eg} {ec}")
    for k in ec:
        if abs(eg[k] - ec[k]) > 1e-6 * abs(ec[k]) + 1e-12:
            raise AssertionError(f"material box 32^2: energy {k} {eg[k]!r} "
                                 f"vs CPU {ec[k]!r}")
    if any(ng.values()) or any(nc.values()):
        raise AssertionError(f"material box 32^2: dropped movers {ng} {nc}")
    worst = max(abs(eg[k] - ec[k]) / abs(ec[k]) for k in ec if ec[k])
    log(f"  material box 32^2, {MAT_SMALL_STEPS} steps: {len(ac)} id and "
        f"table arrays bitwise equal on card and CPU, energies within 1e-6 "
        f"(largest relative difference {worst:.3e}), no dropped movers")
    return worst


def material_kernel(sim):
    """The push kernel on both species of the material box, voxel-sorted as
    the step sorts them, against its plain version and twin; the electrons
    timed against the bound.  Returns (max abs err, the species that
    needed the quantum allowance, timing dict)."""
    from vpic_tpu_torch.engine.step import walk_segments
    from vpic_tpu_torch.particles import aux
    st, g = sim.state, sim.grid
    nb, interp = st.grid_arrays.neighbor, st.interpolator
    n_walk = walk_segments(g, sim.opts)
    errs, quantum, species = [], [], []
    for sp in st.species:
        sp = aux.sort_p(sp)
        err, q = check_bar(check_push, f"material box {sp.name} (n_walk "
                           f"{n_walk})", sp, interp, nb, g, n_walk)
        errs.append(err)
        if q:
            quantum.append(sp.name)
        species.append(sp)
    log(f"  material box: the float bar needed the quantum allowance for "
        f"{quantum or 'no species'}")
    c = walk_counts(species[0], interp, nb, g, n_walk)
    t = time_push("material box electrons", species[0], interp, nb, g,
                  n_walk, c["pairs"])
    return max(errs), quantum, t


def rms_div_e(state, g, comm):
    """The rms div E error of ``state`` with rho accumulated from its
    particles, as the interval clean measures it."""
    from vpic_tpu_torch.engine.step import _rms
    from vpic_tpu_torch.field import stencil, sync
    from vpic_tpu_torch.particles import aux
    from vpic_tpu_torch.sf import interp as sfi
    f = sfi.clear_rhof(state.field, g)
    for sp in state.species:
        f = aux.accumulate_rho_p(f, sp, g)
    f = sync.synchronize_rho(f, g, comm)
    f = stencil.compute_div_e_err(f, g, state.materials, state.material_grid,
                                  comm)
    return float(_rms(g, comm, stencil.local_rms_div_e_err(f, g)))


def material_run(device, tmp):
    """MAT_STEPS steps from finalize with a checkpoint at step MAT_CKPT:
    finite energies, no dropped mover; a second build restored from the
    checkpoint and run to MAT_STEPS bitwise equal in every array; the rms
    div E error after the interval clean no larger than before it; the
    ids of dump_fields read back equal to the state's.  Returns (sim,
    record)."""
    import dataclasses
    import math
    import numpy as np
    import torch
    from vpic_tpu_torch.engine.step import clean_div_e
    from vpic_tpu_torch.interop import state_to_numpy
    from vpic_tpu_torch.io import readers
    from vpic_tpu_torch.core.types import MATERIAL_ID_FIELDS
    t0 = time.perf_counter()
    a = material_box(device, **MAT_FULL)
    g, st = a.grid, a.state
    mg = st.material_grid
    log(f"  material box: {g.nx}x{g.ny} cells, species "
        + ", ".join(f"{sp.name} {int(sp.np)}/{sp.max_np}"
                    for sp in st.species)
        + f", {st.materials.decayx.numel()} materials, cells by material "
        f"{torch.bincount(mg.cmat[1:-1, 1:-1, 1:-1].reshape(-1)).tolist()}, "
        f"built in {time.perf_counter() - t0:.2f} s")
    e0 = sum(a.energies().values())
    a.advance_steps(MAT_CKPT)
    path = os.path.join(tmp, "materials")
    a.checkpoint(path)
    a.advance_steps(MAT_STEPS - MAT_CKPT)
    e1, nm = a.energies(), a.mover_counts()
    if not all(math.isfinite(v) for v in e1.values()):
        raise AssertionError(f"material box: energies {e1}")
    if any(nm.values()):
        raise AssertionError(f"material box: dropped movers {nm}")
    first = state_to_numpy(a.state)
    before = rms_div_e(a.state, g, a.comm)
    after = rms_div_e(dataclasses.replace(
        a.state, field=clean_div_e(a.state, g, a.comm)), g, a.comm)
    if not after <= before:
        raise AssertionError(f"material box: rms div E error {before!r} -> "
                             f"{after!r} across a clean")
    t0 = time.perf_counter()
    fpath, = a.dump_fields(os.path.join(tmp, "fields"))
    _, out = readers.read_fields(fpath)
    dump_ms = (time.perf_counter() - t0) * 1e3
    for k, name in enumerate(MATERIAL_ID_FIELDS):
        if not np.array_equal(out["materials"][..., k],
                              first[f"material_grid/{name}"]):
            raise AssertionError(f"material box: dumped {name} differs from "
                                 "the state's")
    b = material_box(device, **MAT_FULL)
    b.restore(path)
    b.advance_steps(MAT_STEPS - MAT_CKPT)
    second = state_to_numpy(b.state)
    del b
    torch.cuda.empty_cache()
    same = lambda x, y: (x.dtype == y.dtype and x.shape == y.shape
                         and x.tobytes() == y.tobytes())
    bad = [k for k in first if k not in second or not same(
        np.asarray(first[k]), np.asarray(second[k]))]
    if set(first) != set(second) or bad:
        raise AssertionError(f"material box: the restarted run differs in "
                             f"{bad[:8]}")
    drift = (sum(e1.values()) - e0) / e0
    log(f"  material box: {MAT_STEPS} steps, total energy {e0!r} -> "
        f"{sum(e1.values())!r} ({drift:.4e}), dropped movers {nm}; rms div "
        f"E error {before:.6e} before the clean, {after:.6e} after; "
        f"dump_fields + read_fields {dump_ms:.1f} ms, the eight id planes "
        f"equal the state's; restored from step {MAT_CKPT} and run to step "
        f"{MAT_STEPS}: {len(first)} arrays bitwise the first run's")
    return a, dict(drift=drift, dropped_movers=sum(nm.values()),
                   rms_div_e_before=before, rms_div_e_after=after)


def material_damping(device):
    """The particle-free wave box at WAVE_NX^2, vacuum against copper, for
    WAVE_STEPS steps: the copper run's E energy below WAVE_BAR of the
    vacuum run's (tests/test_materials_diag.py's bar).  Returns the
    ratio."""
    import math
    import torch
    ee = {}
    for conductor in (False, True):
        sim = wave_box(device, conductor, WAVE_NX)
        sim.advance_steps(WAVE_STEPS)
        e = sim.energies()
        ee[conductor] = e["ex"] + e["ey"] + e["ez"]
        del sim
        torch.cuda.empty_cache()
    ratio = ee[True] / ee[False]
    if not (math.isfinite(ratio) and ratio < WAVE_BAR):
        raise AssertionError(f"wave box {WAVE_NX}^2: copper E energy "
                             f"{ee[True]!r} vs vacuum {ee[False]!r}")
    log(f"  wave box {WAVE_NX}^2, {WAVE_STEPS} steps: E energy copper "
        f"{ee[True]!r}, vacuum {ee[False]!r}, ratio {ratio:.4f} (bar "
        f"{WAVE_BAR})")
    return ratio


def material_timing(device, vacuum):
    """A fresh material box (``vacuum``: its one-vacuum twin) after
    WARM_STEPS steps: WINDOWS timed windows of STEPS steps (one push
    launch per species per step) and a trace split by step part.  Returns
    (launches, median step s, trace, the total energy at the end of the
    windows over the one at their start)."""
    import torch
    label = "material box" + (", one vacuum material" if vacuum else "")
    sim = material_box(device, vacuum=vacuum, **MAT_FULL)
    sim.advance_steps(WARM_STEPS)
    e0 = sum(sim.energies().values())
    launches, step_s = push_only_windows(sim, label)
    growth = sum(sim.energies().values()) / e0
    trace = phase_trace(sim, step_s, f"{label} path")
    del sim
    torch.cuda.empty_cache()
    return launches, step_s, trace, growth


def phase_materials(device, card):
    """Phase 14: the material box.  Returns the push record's materials_*
    fields."""
    import shutil
    import tempfile
    import torch
    small = material_small(device)
    tmp = tempfile.mkdtemp(prefix="materials_smoke_")
    try:
        sim, rec = material_run(device, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    err, quantum, t = material_kernel(sim)
    del sim
    torch.cuda.empty_cache()
    launches, step_s, trace, growth = material_timing(device, False)
    _, vstep_s, vtrace, vgrowth = material_timing(device, True)
    ratio = material_damping(device)
    field, vfield = trace["parts"]["step.field"], vtrace["parts"][
        "step.field"]
    log(f"material box path ({card}): step {step_s * 1e3:.4f} ms, device "
        f"busy {trace['busy_ms']:.4f} ms/step, {trace['ops']:.1f} ops/step, "
        f"idle share {1 - trace['busy_ms'] / (step_s * 1e3):.4f}; step.field "
        f"{field['busy_ms']:.4f} ms ({field['ops']:.1f} ops) against "
        f"{vfield['busy_ms']:.4f} ms ({vfield['ops']:.1f} ops) with one "
        f"vacuum material (step {vstep_s * 1e3:.4f} ms, busy "
        f"{vtrace['busy_ms']:.4f} ms/step); push kernel on the electrons "
        f"{t['kernel_ms']:.4f} ms alone against a {t['bound_ms']:.4f} ms "
        f"bound; total energy over the timed windows x{growth:.4e} (one "
        f"vacuum material x{vgrowth:.4e})")
    return {
        "materials_launches": launches["push_walk"],
        "materials_launches_per_step": launches["push_walk"]
        / (WINDOWS * STEPS),
        "materials_max_abs_err": err,
        "materials_quantum_species": quantum,
        **{f"materials_{k}": v for k, v in t.items()},
        "materials_step_ms": step_s * 1e3,
        "materials_busy_ms": trace["busy_ms"],
        "materials_ops_per_step": trace["ops"],
        "materials_idle_share": 1 - trace["busy_ms"] / (step_s * 1e3),
        "materials_field_busy_ms": field["busy_ms"],
        "materials_field_ops": field["ops"],
        "materials_vacuum_step_ms": vstep_s * 1e3,
        "materials_vacuum_busy_ms": vtrace["busy_ms"],
        "materials_vacuum_field_busy_ms": vfield["busy_ms"],
        "materials_vacuum_field_ops": vfield["ops"],
        "materials_window_energy_ratio": growth,
        "materials_vacuum_window_energy_ratio": vgrowth,
        "materials_damping_ratio": ratio,
        "materials_small_max_rel_energy_diff": small,
        **{f"materials_{k}": v for k, v in rec.items()},
    }


# -- phase 15: several shards on one card ------------------------------------

# the bench deck of __graft_entry__._build at full width, four shards of
# 64^2 on the one card (capacity 1.25 per species, as _build gives sharded
# runs); the one-shard run of the same deck is its reference
SHARD_DECK = dict(nx=128, ny=128, nz=1, npart=2_097_152)
SHARD_MESH = dict(px=2, py=2)
SHARD_STEPS = 25
# tests/multi_device/test_shard.py:test_two_shard_equivalence's bars
SHARD_RTOL, SHARD_ATOL, SHARD_E_RTOL = 2e-4, 2e-5, 1e-4
SHARD_FIELDS = ("ex", "ey", "ez", "cbx", "cby", "cbz", "jfx", "jfy", "jfz")
SHARD_UNFUSED_STEPS = 4
# the turbulence deck at its default size with its z axis (PEC walls) on
# two shards
TURB_SHARDED = dict(TURB_FULL, TURB_PZ="2")


def shard_bench(device, **mesh):
    from vpic_tpu_torch.decks import bench_deck
    return bench_deck.build(**SHARD_DECK, **mesh, device=device)


def shard_launch_counts():
    from vpic_tpu_torch.particles import deposit_cuda, push_cuda, sort_cuda
    return dict(push_walk=push_cuda.launches["push"],
                walk_only=push_cuda.launches["walk_only"],
                deposit_sorted=deposit_cuda.launches["deposit_sorted"],
                **sort_cuda.launches)


def reset_launch_counts():
    from vpic_tpu_torch.particles import deposit_cuda, push_cuda, sort_cuda
    for mod in (push_cuda, deposit_cuda, sort_cuda):
        mod.reset_launch_counts()


def shard_round_walks(sims):
    """One step of each of ``sims``, taken op by op (``advance_eager``: a
    graph's capture would record tensors that hold no values yet), with
    push_cuda.streak_walk recording its input: per rank of the sharded
    deck ``sims[-1]``, the walk states of its rounds (round, species
    order).  The recording is taken off before returning."""
    from vpic_tpu_torch.particles import push_cuda
    rec, orig = collections.defaultdict(list), push_cuda.streak_walk
    # each shard walks through its own neighbor table
    rank_of = {st.grid_arrays.neighbor.data_ptr(): r
               for r, st in enumerate(sims[-1].states)}

    def recording(st, acc, nb, g, n_iter):
        r = rank_of.get(nb.data_ptr())
        if r is not None:
            rec[r].append((st, nb, n_iter))
        return orig(st, acc, nb, g, n_iter)

    push_cuda.streak_walk = recording
    try:
        for sim in sims:
            sim.advance_eager(1)
    finally:
        push_cuda.streak_walk = orig
    return rec


def shard_kernels(one, four):
    """The push kernel on every shard's species at finalize, voxel-sorted
    as the step sorts them, its stopped lanes (migrate codes) left to the
    rounds as the step leaves them, and its walk_only entry on each
    shard's first round of the electrons (the buffer and the lanes
    received from the neighbor shards), against the plain version and the
    fixed-point twin; the push on shard 0's sorted electrons and the walk
    on shard 0's round timed.  Steps ``one`` and ``four`` once.  Returns
    (max abs err, species that needed the quantum allowance, the push's
    timing, the walk's timing)."""
    from vpic_tpu_torch.engine.step import walk_segments
    from vpic_tpu_torch.particles import aux
    g = four.grid
    n_walk = walk_segments(g, four.opts)
    errs, quantum = [], []
    for r, st in enumerate(four.states):
        for sp in st.species:
            err, q = check_bar(check_push, f"shard {r} {sp.name}",
                               aux.sort_p(sp), st.interpolator,
                               st.grid_arrays.neighbor, g, n_walk,
                               count_pending=False)
            errs.append(err)
            if q:
                quantum.append(f"shard {r} {sp.name}")
    st = four.states[0]
    sp = aux.sort_p(st.species[0])
    c = walk_counts(sp, st.interpolator, st.grid_arrays.neighbor, g, n_walk)
    push_t = time_push(f"shard 0 of {g.n_shards} sorted electrons", sp,
                       st.interpolator, st.grid_arrays.neighbor, g, n_walk,
                       c["pairs"])
    del st, sp
    rec = shard_round_walks([one, four])
    buf = min(four.opts.max_inj, four.states[0].species[0].max_np)
    timing = None
    for r in range(g.n_shards):
        walk, nb, n_iter = rec[r][0]
        got = int(walk.active[buf:].sum())
        if not got:
            raise AssertionError(f"shard {r}: the first round received no "
                                 "lane to walk")
        label = (f"shard {r} round 1 electrons ({int(walk.active[:buf].sum())}"
                 f" buffer lanes and {got} received of {walk.x.shape[0]})")
        err, q = check_bar(check_walk, label, walk, nb, g, n_iter)
        errs.append(err)
        if q:
            quantum.append(f"shard {r} walk")
        if r == 0:
            timing = time_walk(label, walk, nb, g, n_iter)
    return max(errs), quantum, push_t, timing


def count_migrants():
    """A patch of particles.boundary.received_lanes that adds each round's
    received lanes into a device counter per device (no host read in the
    step); returns (counters, undo).  It counts steps taken op by op
    (``advance_eager``): a graph's replay runs no Python."""
    import torch
    from vpic_tpu_torch.particles import boundary
    orig, total = boundary.received_lanes, {}

    def counting(recv):
        cols, valid = orig(recv)
        got = valid.sum(dtype=torch.int64)
        total[got.device] = total.get(got.device, 0) + got
        return cols, valid

    boundary.received_lanes = counting

    def undo():
        boundary.received_lanes = orig
    return total, undo


def shard_compare(one, four):
    """The four-shard deck against the one-shard deck at the same step:
    the owned fields over the global box to rtol SHARD_RTOL / atol
    SHARD_ATOL, energies to SHARD_E_RTOL, each species' alive count
    exact, no dropped mover on either."""
    import numpy as np
    from vpic_tpu_torch.engine.distributed import alive_count, global_field
    worst = {}
    for comp in SHARD_FIELDS:
        a, b = global_field(one, comp), global_field(four, comp)
        if not np.allclose(b, a, rtol=SHARD_RTOL, atol=SHARD_ATOL):
            raise AssertionError(f"4 shards against 1: {comp} beyond rtol "
                                 f"{SHARD_RTOL} atol {SHARD_ATOL} (max "
                                 f"{float(np.abs(a - b).max())!r})")
        worst[comp] = float(np.abs(a - b).max())
    e1, e4 = one.energies(), four.energies()
    for k in e1:
        if abs(e4[k] - e1[k]) > SHARD_E_RTOL * abs(e1[k]) + 1e-9:
            raise AssertionError(f"4 shards against 1: energy {k} "
                                 f"{e4[k]!r} vs {e1[k]!r}")
    alive = [(alive_count(one, k), alive_count(four, k))
             for k in range(len(one._species))]
    if any(a != b for a, b in alive):
        raise AssertionError(f"alive counts (1 shard, 4 shards) {alive}")
    nm = (one.mover_counts(), four.mover_counts())
    if any(v for m in nm for v in m.values()):
        raise AssertionError(f"dropped movers (1 shard, 4 shards) {nm}")
    erel = max(abs(e4[k] - e1[k]) / abs(e1[k]) for k in e1)
    log(f"  step {four.step_count}: 4 shards against 1 shard, fields max "
        f"abs diff {max(worst.values())!r} ({max(worst, key=worst.get)}), "
        f"energies within {erel:.3e} relative, alive {alive}, dropped "
        f"movers {nm[1]}")
    return dict(field_diff=max(worst.values()), energy_rel=erel)


def shard_windows(sim, label):
    """WINDOWS timed windows of STEPS steps through ``advance`` (graphed
    where the deck is), the launch counts set to 0 just before and read
    just after: per shard and step one push launch per species and
    num_comm_round walk_only launches per species, no other kernel (a
    replay adds its graph's launches); finite energies, bounded drift, no
    dropped mover.  Returns (launches, median step s, min, max)."""
    import math
    import statistics
    import torch
    n = sim.grid.n_shards
    nsp = len(sim._species)
    reset_launch_counts()
    step_s = []
    for w in range(WINDOWS):
        e0, nm0 = sim.energies(), sim.mover_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sim.advance_steps(STEPS)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        e1, nm1 = sim.energies(), sim.mover_counts()
        if not all(math.isfinite(v) for v in e1.values()):
            raise AssertionError(f"{label}: non-finite energies {e1}")
        drops = {k: nm1[k] - nm0[k] for k in nm1}
        if any(drops.values()):
            raise AssertionError(f"{label}: dropped movers {drops}")
        drift = (sum(e1.values()) - sum(e0.values())) / sum(e0.values())
        if not abs(drift) < DRIFT_LIMIT:
            raise AssertionError(f"{label}: energy drift {drift:.3e}")
        step_s.append(dt / STEPS)
        log(f"  {label} window {w + 1}/{WINDOWS} (steps "
            f"{sim.step_count - STEPS}-{sim.step_count}): {dt:.4f} s, "
            f"{dt / STEPS * 1e3:.4f} ms/step, energy drift {drift:.3e}")
    launches = shard_launch_counts()
    steps = WINDOWS * STEPS
    want = dict(push_walk=steps * nsp * n,
                walk_only=steps * nsp * n * sim.opts.num_comm_round
                if n > 1 else 0)
    if any(launches[k] != v for k, v in want.items()) or \
            sum(launches.values()) != sum(want.values()):
        raise AssertionError(f"{label}: launches {launches}, expected "
                             f"{want} and no other kernel")
    med = statistics.median(step_s)
    log(f"  {label}: median {med * 1e3:.4f} ms/step (min "
        f"{min(step_s) * 1e3:.4f}, max {max(step_s) * 1e3:.4f}; "
        f"{'graphed' if sim.graphed else 'op by op'}), launches "
        f"{launches}")
    return launches, med, min(step_s), max(step_s)


def record_deposits(n_calls):
    """A patch of deposit_cuda.deposit_sorted_into that keeps a copy of
    the inputs of its first ``n_calls`` calls, with the calling thread's
    name (each shard steps in a thread of its own); returns (records,
    undo)."""
    import threading
    from vpic_tpu_torch.particles import deposit_cuda
    orig, rec = deposit_cuda.deposit_sorted_into, []

    def recording(acc, vox, cols, valid, nv):
        if len(rec) < n_calls:
            rec.append((threading.current_thread().name, acc.clone(),
                        vox.clone(), tuple(c.clone() for c in cols),
                        valid.clone(), nv))
        return orig(acc, vox, cols, valid, nv)

    deposit_cuda.deposit_sorted_into = recording

    def undo():
        deposit_cuda.deposit_sorted_into = orig
    return rec, undo


def shard_unfused(device, twin):
    """The four-shard deck ``twin`` on the unfused push: one step taken op
    by op (``advance_eager``) whose deposit inputs are recorded (a graph's
    capture would record tensors that hold no values yet), then
    SHARD_UNFUSED_STEPS steps through ``advance`` (graphed), the launch
    counts set to 0 just before and read just after: one deposit launch
    per shard, species and step and no push launch.  The deposit kernel
    against its plain version on each shard's recorded inputs (each
    species, voxel-sorted, as the step handed them to the kernel); then
    the same steps of a one-shard deck brought to the same step on the
    fused path, and ``twin`` held to it (shard_compare: fields, energies,
    exact alive counts, no dropped mover).  Returns (launches, the
    deposit's max abs error, the comparison)."""
    import torch
    g, nsp = twin.grid, len(twin._species)
    one = shard_bench(device)
    one.advance_steps(twin.step_count)
    for sim in (one, twin):
        sim.modify_runparams(fused_push=False)
    rec, undo = record_deposits(g.n_shards * nsp)
    try:
        twin.advance_eager(1)
    finally:
        undo()
    reset_launch_counts()
    e0 = sum(twin.energies().values())
    twin.advance_steps(SHARD_UNFUSED_STEPS)
    unfused = shard_launch_counts()
    want = SHARD_UNFUSED_STEPS * nsp * g.n_shards
    if unfused["deposit_sorted"] != want or unfused["push_walk"] != 0:
        raise AssertionError(f"unfused window launches {unfused}, expected "
                             f"{want} deposit launches and no push launch")
    e1 = sum(twin.energies().values())
    log(f"  unfused push on {g.n_shards} shards: deposit inputs recorded on "
        f"step {twin.step_count - SHARD_UNFUSED_STEPS - 1} (op by op), then "
        f"{SHARD_UNFUSED_STEPS} steps {'graphed' if twin.graphed else ''}: "
        f"launches {unfused}, energy change {(e1 - e0) / e0:.3e}")
    threads = sorted({r[0] for r in rec})
    if len(rec) != g.n_shards * nsp or len(threads) != g.n_shards:
        raise AssertionError(f"the unfused step's first deposits came from "
                             f"{threads} ({len(rec)} calls)")
    errs, quantum = [], []
    for k, (name, acc, vox, cols, valid, nv) in enumerate(rec):
        label = (f"{name} deposit {k % nsp + 1}/{nsp} (n={vox.shape[0]}, "
                 f"nv={nv})")
        err, q = check_bar(check_deposit, label, acc, vox, cols, valid, nv)
        errs.append(err)
        if q:
            quantum.append(label)
    del rec
    one.advance_steps(1 + SHARD_UNFUSED_STEPS)
    cmp = shard_compare(one, twin)
    del one
    torch.cuda.empty_cache()
    return unfused, max(errs), dict(cmp, deposit_quantum=quantum)


def shard_bench_phase(device, card):
    """The bench deck on four shards of the card against its one-shard
    run.  Returns the push, walk_only and deposit records of this path."""
    import torch
    t0 = time.perf_counter()
    one, four, twin = (shard_bench(device), shard_bench(device, **SHARD_MESH),
                       shard_bench(device, **SHARD_MESH))
    torch.cuda.synchronize()
    g = four.grid
    log(f"  decks built in {time.perf_counter() - t0:.2f} s: {g.gpx}x{g.gpy} "
        f"shards of {g.nx}x{g.ny} on {[str(d) for d in four.mesh]}, per "
        "shard " + "; ".join(
            ", ".join(f"{sp.name} {int(sp.np)}/{sp.max_np}"
                      for sp in st.species) for st in four.states))
    err, quantum, push_t, walk_t = shard_kernels(one, four)
    twin.advance_steps(1)
    for sim in (one, twin):
        sim.advance_steps(SHARD_STEPS - 1)
    rv = four.comms[0].rv
    migrants, undo = count_migrants()
    wait0 = sum(rv.wait_s)
    try:
        four.advance_eager(SHARD_STEPS - 1)
    finally:
        undo()
    mig = sum(int(v) for v in migrants.values()) / (SHARD_STEPS - 1)
    barrier = (sum(rv.wait_s) - wait0) / g.n_shards / (SHARD_STEPS - 1)
    log(f"  migrated lanes: {mig:.1f} per step over {g.n_shards} shards; "
        f"host wait for the other shards' turns {barrier * 1e3:.4f} "
        f"ms/step per shard (steps 1-{SHARD_STEPS} taken op by op, "
        "advance_eager: a replay meets no rendezvous; both species)")
    cmp = shard_compare(one, four)
    # the timed windows and traces start on a sort super-cycle, after one
    # untimed super-cycle that captures its graph
    pad = -four.step_count % (four.opts.resort_interval * 4)
    for sim in (one, four, twin):
        sim.advance_steps(pad + four.opts.resort_interval * 4)
    sums = [(s.checksum_fields(), s.checksum_species("electron"),
             s.checksum_species("ion")) for s in (four, twin)]
    if sums[0] != sums[1]:
        raise AssertionError(f"two four-shard runs from one seed differ: "
                             f"{sums}")
    log(f"  two four-shard runs from one seed, step {four.step_count} "
        f"(steps 1-{SHARD_STEPS} op by op on one, graphed on the other): "
        f"checksums equal (fields {sums[0][0][:12]}..., electrons "
        f"{sums[0][1][:12]}..., ions {sums[0][2][:12]}...)")

    # the main path of this phase: the four-shard deck's timed windows
    launches, med4, lo4, hi4 = shard_windows(four, "4 shards")
    _, med1, lo1, hi1 = shard_windows(one, "1 shard")
    trace4 = phase_trace(four, med4, "4-shard path", parts=())
    trace1 = phase_trace(one, med1, "1-shard path")
    del one, four
    torch.cuda.empty_cache()

    # the unfused push on the shards (the deposit kernel), held to the
    # one-shard deck's unfused run from the same step
    unf, deposit_err, unfused_cmp = shard_unfused(device, twin)
    del twin
    torch.cuda.empty_cache()
    log(f"sharded bench deck ({card}; {SHARD_DECK['nx']}^2, 2 x "
        f"{SHARD_DECK['npart']}, {g.n_shards} shards of {g.nx}^2 on one "
        f"card): step {med4 * 1e3:.4f} ms (min "
        f"{lo4 * 1e3:.4f}, max {hi4 * 1e3:.4f}) against 1 shard "
        f"{med1 * 1e3:.4f} ms (min {lo1 * 1e3:.4f}, max {hi1 * 1e3:.4f}); "
        f"device busy {trace4['busy_ms']:.4f} ms/step, "
        f"{trace4['ops']:.1f} ops/step, idle share "
        f"{1 - trace4['busy_ms'] / (med4 * 1e3):.4f} (1 shard: "
        f"{trace1['busy_ms']:.4f} ms, {trace1['ops']:.1f} ops, "
        f"{1 - trace1['busy_ms'] / (med1 * 1e3):.4f}); op by op, host "
        f"wait for the other shards' turns "
        f"{barrier * 1e3:.4f} ms/step per shard; {mig:.1f} migrated lanes "
        "per step (op by op)")
    steps = WINDOWS * STEPS
    push = dict(shards_launches=launches["push_walk"],
                shards_launches_per_step=launches["push_walk"] / steps,
                shards_max_abs_err=err, shards_quantum=quantum,
                shards_step_ms=med4 * 1e3, shards_one_shard_step_ms=med1 * 1e3,
                shards_busy_ms=trace4["busy_ms"], shards_ops=trace4["ops"],
                shards_barrier_ms=barrier * 1e3,
                shards_migrated_per_step=mig, **{
                    f"shards_{k}": v for k, v in cmp.items()}, **{
                    f"shards_push_{k}": v for k, v in push_t.items()})
    walk = dict(shards_walk_only_launches=launches["walk_only"],
                **{f"shards_walk_{k}": v for k, v in walk_t.items()})
    deposit = dict(shards_launches=unf["deposit_sorted"],
                   shards_max_abs_err=deposit_err,
                   shards_quantum=unfused_cmp.pop("deposit_quantum"), **{
                       f"shards_unfused_{k}": v
                       for k, v in unfused_cmp.items()})
    return push, walk, deposit


def shard_turb_cli(tmp):
    """The turbulence deck at its default size with TURB_PZ=2 through the
    CLI for TURB_STEPS steps with its diagnostics, then again from its
    step-TURB_RESTART restart: every step-TURB_STEPS dump of both ranks
    byte for byte the first run's, per-rank dumps of every kind, the
    hydro dumps' shared node plane equal on both ranks (synchronized
    faces), finite energies, no dropped mover.  Returns the two runs'
    seconds."""
    import numpy as np
    from vpic_tpu_torch.io import readers
    env = lambda out: dict(TURB_SHARDED, **TURB_DIAG, TURB_OUT=str(out))
    first, second = os.path.join(tmp, "first"), os.path.join(tmp, "second")
    t1 = deck_cli(TURB_DECK, env(first), TURB_STEPS)
    t2 = deck_cli(TURB_DECK, env(second), TURB_STEPS, "--restart",
                  os.path.join(first, "restart1", "restart"))
    tags = tuple(f".{TURB_STEPS}.{r}" for r in range(2))
    dumps = sorted(os.path.relpath(os.path.join(d, f), first)
                   for d, _, files in os.walk(first) for f in files
                   if f.endswith(tags) or os.path.basename(d)
                   == f"T.{TURB_STEPS}")
    kinds = collections.Counter(p.split(os.sep)[0] for p in dumps)
    want = {"fields": 2, "hydro": 12, "particle": 8, "tracer": 4,
            "spectra": 16}
    ranks = collections.Counter(p.rsplit(".", 1)[1] for p in dumps
                                if not p.startswith("spectra"))
    if kinds != want or ranks != {"0": 13, "1": 13}:
        raise AssertionError(f"step-{TURB_STEPS} dumps {dict(kinds)} by "
                             f"rank {dict(ranks)}, expected {want}")
    for rel in dumps:
        a = open(os.path.join(first, rel), "rb").read()
        if a != open(os.path.join(second, rel), "rb").read():
            raise AssertionError(f"{rel}: the restarted run's bytes differ")
    log(f"  TURB_PZ=2: restart from step {TURB_RESTART}: all {len(dumps)} "
        f"step-{TURB_STEPS} dumps ({dict(kinds)}, ranks {dict(ranks)}) "
        "byte-identical to the first run's")
    planes = 0
    for name in ("eT", "eB", "iT", "iB"):
        base = os.path.join(first, "hydro", f"{name}hydro.{TURB_STEPS}")
        (h0, lo), (h1, hi) = (readers.read_hydro(f"{base}.{r}")
                              for r in range(2))
        nz = h0["nz"]
        for k, v in lo.items():
            a, b = v[nz + 1, 1:, 1:], hi[k][1, 1:, 1:]
            if not np.array_equal(a, b):
                raise AssertionError(f"{name} hydro {k}: the shared node "
                                     "plane differs between the ranks")
        if not np.abs(lo["rho"][nz + 1]).max() > 0:
            raise AssertionError(f"{name} hydro: no charge on the shared "
                                 "plane")
        planes += 1
    en = read_energies(os.path.join(first, "rundata", "energies"))
    if not all(np.isfinite(v) for vals in en.values() for v in vals):
        raise AssertionError("non-finite energies in the sharded CLI run")
    ck = os.path.join(first, "restart2", "restart")
    meta = json.load(open(ck + ".json"))
    with np.load(ck + ".npz") as data:
        nm = {s["name"]: int(data[f"species/{k}/nm"].sum())
              for k, s in enumerate(meta["species"])}
    if any(nm.values()):
        raise AssertionError(f"dropped movers in the sharded CLI run {nm}")
    log(f"  TURB_PZ=2: the hydro dumps of {planes} species hold equal "
        f"shared node planes on both ranks; energies finite; dropped "
        f"movers by step {meta['extra']['step_count']} {nm}")
    return t1, t2


def phase_shards(device, card):
    """Phase 15: several shards in one process on one card.  Returns the
    push, walk_only and deposit records of its paths."""
    import shutil
    import tempfile
    push, walk, deposit = shard_bench_phase(device, card)
    tmp = tempfile.mkdtemp(prefix="shard_smoke_")
    try:
        t1, t2 = shard_turb_cli(tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"sharded turbulence deck ({card}; 64x32x32 on 2 z shards with PEC "
        f"z walls): CLI {TURB_STEPS} steps with diagnostics {t1:.2f} s, "
        f"restart {TURB_RESTART}->{TURB_STEPS} {t2:.2f} s")
    return push, walk, deposit


# -- phase 16: the tools path ------------------------------------------------
# the probe kernels of csrc/probes.cu, each at the shapes of the tool it
# replaces, and the drift comparison against the float64 reference

PROBE_SOURCE = "vpic_tpu_torch/csrc/probes.cu"
PROBE_REPLACES = {"vpu_chain": "tools/vpu_layout_probe.py:22",
                  "gather3d": "tools/probe_batched.py:47",
                  "deposit2d": "tools/probe_batched.py:67",
                  "stack8": "tools/probe_batched.py:87",
                  "onehot3d": "tools/probe_batched.py:110",
                  "io4d": "tools/probe_batched.py:125"}
# ragged shapes of the tensor-core probes' plan, (a shape, oh shape):
# a single split, a short last split and column tile, two 16-row tiles
PROBE_RAGGED = {
    "gather3d": [((5, 48), (3, 48, 32)), ((20, 200), (2, 200, 100))],
    "deposit2d": [((7, 3, 32), (3, 40, 32)), ((20, 5, 48), (5, 70, 48))]}
# the chain's ragged cases, (rows, block shape, reps): reps around the
# kernel's 16-rep unroll on rows 3 of (8, 1000), then zeros that start or
# end off a 16-byte boundary (n not a multiple of 4) at 17 reps
CHAIN_RAGGED = ([(3, (8, 1000), r) for r in (0, 1, 7, 17, 1024)]
                + [(5, (5, 130), 17), (3, (8, 1001), 17), (5, (7, 130), 17),
                   (1, (2, 3), 17)])
# io4d's inputs besides the tool's, by name: R*L not a multiple of 4, a
# contiguous slice along dim 0 (840 bytes into its storage), and R*L a
# multiple of 4 from 4 bytes into its storage
IO4D_CASES = {"ragged": (3, 7, 5, 6), "dim-0 slice": (3, 7, 5, 6),
              "4 bytes in": (2, 7, 4, 8)}
# stack8's inputs besides the tool's, by name: (a, w, s, lane), the floats
# win and the ints loc start into their storage, and the plan's (stage,
# width).  loc is drawn on [-w/4, 5w/4), so that every case has lanes
# outside [0, w).
STACK8_CASES = {
    "tool shape": ((32, 512, 8, 128), 0, 0, (1, 4)),
    "lane 6": ((4, 64, 3, 6), 0, 0, (1, 1)),
    "ragged chunk": ((3, 64, 3, 100), 0, 0, (1, 4)),
    "loc 4 bytes in": ((4, 64, 8, 16), 0, 1, (1, 1)),
    "win 4 bytes in": ((4, 64, 8, 16), 1, 0, (0, 4)),
    "one-row window": ((1, 512, 8, 128), 0, 0, (1, 4)),
    "w 13": ((5, 13, 8, 16), 0, 0, (0, 4)),
    "row past 48 KB": ((2, 12288, 8, 128), 0, 0, (0, 4))}
# onehot3d's, by name: (r, w, lane), the ints loc starts into its storage
# and the plan's width; loc drawn on [-2, w + 2)
ONEHOT3D_CASES = {
    "tool shape": ((8, 512, 128), 0, 4),
    "lane 6": ((3, 7, 6), 0, 1),
    "loc 4 bytes in": ((2, 40, 8), 1, 1),
    "w 13": ((4, 13, 16), 0, 4),
    "one row": ((1, 512, 128), 0, 4)}
# (steps, particles in all, nx): the tool's defaults, then the bench
# deck's grid with the particles cut to what the float64 host reference
# (about 30 us per particle and step) steps in about 20 s
DRIFT_RUNS = {"16^2": (24, 16_000, 16), "128^2": (8, 65_536, 128)}
DRIFT_EXCESS_BAR = 1e-6     # BASELINE.md's drift bar
# each relative field RMS against the float64 reference: at most 1e-5, or
# twice the JAX package's own where that is larger.  The JAX package's
# figures are tools/drift_compare.py's on the CPU at the same sizes
# (JAX 0.9.0): cby, whose scale is about 1/80 of cbx's, carries the
# float32 roundoff of the larger fields and passes 1e-5 by step 24.
FIELD_RMS_BAR = 1e-5
JAX_FIELD_RMS = {
    "16^2": dict(ex=6.07908632091533e-07, ey=1.0922707902294337e-06,
                 ez=4.4291943421409304e-07, cbx=1.9093514110537682e-07,
                 cby=1.0834232764605484e-05, cbz=1.9263340934129703e-07),
    "128^2": dict(ex=4.1553237325431004e-07, ey=1.9740199642310457e-06,
                  ez=2.3886897376491967e-07, cbx=9.739423841494975e-08,
                  cby=9.199359579177384e-06, cbz=9.429463305199806e-08)}


def check_bitwise(label, out, other, what):
    """``out`` bitwise equal to ``other`` (float32 compared as int32)."""
    import torch
    if out.shape != other.shape:
        raise AssertionError(f"{label}: shape {tuple(out.shape)} against "
                             f"{tuple(other.shape)} of {what}")
    a, b = out.contiguous().view(torch.int32), other.contiguous().view(
        torch.int32)
    if not torch.equal(a, b):
        raise AssertionError(f"{label}: differs from {what} in "
                             f"{int((a != b).sum())} elements")


def check_probe(name, device):
    """Probe ``name``'s kernel on the tool's inputs against its plain
    version on the card: bitwise, and bitwise across two runs, each
    output first NaN in the allocator."""
    import torch
    from vpic_tpu_torch.tools import probe_batched as pb
    args = pb.tool_inputs(name, device)
    k1 = check_twice(f"{name} at the tool's shapes",
                     lambda: pb.PROBES[name](*args), pb.PLAIN[name](*args))
    if not bool(torch.isfinite(k1).all()):
        raise AssertionError(f"{name}: non-finite output")


def check_contraction(name, device, seed=5, shapes=None):
    """gather3d or deposit2d on random float32 operands (not one-hot) at
    ``shapes`` (default: the tool's), against the plain bf16-in,
    float32-sum version: within K * 2^-24 * sum|terms| per output, K the
    contraction depth, the worst case of a float32 sum in any order (the
    tensor cores' order is not the plain version's), and bitwise across a
    rerun.  Returns (max abs err, max err over 2^-24 * sum|terms|)."""
    import numpy as np
    import torch
    from vpic_tpu_torch.tools import probe_batched as pb
    if shapes is None:
        shapes = [a.shape for a in pb.tool_inputs(name, "cpu")]
    rng = np.random.default_rng(seed)
    a, oh = (torch.as_tensor(rng.normal(size=s).astype(np.float32),
                             device=device) for s in shapes)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        plain = pb.PLAIN[name](a, oh)
        mag = pb.PLAIN[name](a.abs(), oh.abs()).double()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    k1, k2 = pb.PROBES[name](a, oh), pb.PROBES[name](a, oh)
    torch.cuda.synchronize()
    check_bitwise(f"{name} on random operands", k1, k2, "a rerun")
    depth = shapes[0][1] if name == "gather3d" else shapes[0][1] * shapes[0][2]
    err = (k1.double() - plain.double()).abs()
    ratio = float((err / (mag * 2.0 ** -24)).max())
    if not ratio <= depth:
        raise AssertionError(f"{name} on random operands: error "
                             f"{ratio:.3f} x 2^-24 sum|terms|, above K = "
                             f"{depth}")
    log(f"  {name} on random operands {tuple(shapes[0])} x "
        f"{tuple(shapes[1])}: max |kernel - plain| "
        f"{float(err.max()):.3e}, at most {ratio:.4f} x 2^-24 sum|terms| "
        f"(bar K = {depth})")
    return float(err.max()), ratio


def nan_cache(shape, device):
    """Leave a NaN-filled block of ``shape`` free in the caching
    allocator, so that the next output of that shape most likely starts
    as NaN: an element a kernel leaves unwritten then shows."""
    import torch
    torch.full(shape, float("nan"), device=device)


def check_twice(what, run, plain):
    """run() twice, each output first NaN in the allocator: bitwise
    ``plain`` and each other.  Returns the first output."""
    nan_cache(plain.shape, plain.device)
    k1 = run()
    nan_cache(plain.shape, plain.device)
    k2 = run()
    check_bitwise(what, k1, plain, "the plain version")
    check_bitwise(what, k1, k2, "a rerun")
    return k1


def check_chain_case(x, rows, reps):
    """The chain kernel on ``x`` against its plain version and its rerun,
    bitwise, each output first NaN in the allocator; the rows past
    ``rows`` zeros."""
    from vpic_tpu_torch.tools import vpu_layout_probe as vp
    what = f"vpu chain {tuple(x.shape)} rows {rows}, {reps} reps"
    k1 = check_twice(what, lambda: vp.chain(x, rows, reps),
                     vp.chain_plain(x, rows, reps))
    if bool(k1[rows:].any()):
        raise AssertionError(f"{what}: rows past the window are not zero")


def check_chains(device):
    """The chain kernel at 1024 reps on every shape of the tool, on its
    input (ones) and on one drawn uniform on [0, 3), then on the ragged
    cases of CHAIN_RAGGED (uniform): bitwise its plain version and its
    rerun, the rows past ``rows`` zeros."""
    import torch
    from vpic_tpu_torch.tools import vpu_layout_probe as vp
    gen = torch.Generator(device=device).manual_seed(16)
    for rows in vp.ROWS:
        shape = vp.block_shape(rows)
        check_chain_case(torch.ones(shape, device=device), rows, vp.REPS)
        check_chain_case(3 * torch.rand(shape, device=device, generator=gen),
                         rows, vp.REPS)
    for rows, shape, reps in CHAIN_RAGGED:
        check_chain_case(3 * torch.rand(shape, device=device, generator=gen),
                         rows, reps)
    log(f"  vpu chain: {vp.REPS} reps on the {len(vp.ROWS)} shapes of the "
        "tool, ones and uniform [0, 3), and the ragged cases (rows, shape, "
        f"reps) {CHAIN_RAGGED}: bitwise the plain version and a rerun")


def io4d_input(name, device):
    """io4d's input ``name`` of IO4D_CASES, drawn with numpy from one
    seed."""
    import numpy as np
    import torch
    shape = IO4D_CASES[name]
    rng = np.random.default_rng(12)
    if name == "dim-0 slice":
        full = rng.normal(size=(shape[0] + 1, *shape[1:]))
        return torch.as_tensor(full.astype(np.float32), device=device)[1:]
    skip = 1 if name == "4 bytes in" else 0
    flat = rng.normal(size=skip + int(np.prod(shape))).astype(np.float32)
    return torch.as_tensor(flat, device=device)[skip:].view(shape)


def check_io4d(device):
    """The io4d kernel on each input of IO4D_CASES, all on its one-float
    path: bitwise its plain version and its rerun.  (The tool's input,
    on the 16-byte path, is check_probe's.)"""
    import torch
    from vpic_tpu_torch.tools import probe_batched as pb
    for name in IO4D_CASES:
        ps = io4d_input(name, device)
        plan = pb.io4d_plan(ps.shape[0], ps.shape[2] * ps.shape[3],
                            ps.data_ptr() % 16 == 0)
        if plan.width != 1:
            raise AssertionError(f"io4d {name}: plan {plan}, expected the "
                                 "one-float path")
        check_twice(f"io4d {name} {tuple(ps.shape)}", lambda: pb.io4d(ps),
                    pb.io4d_plain(ps))
    torch.cuda.synchronize()
    log(f"  io4d on {list(IO4D_CASES)}: bitwise the plain version and a "
        "rerun")


def _offset(flat, skip, shape):
    """``flat[skip:]`` viewed as ``shape``: contiguous, ``skip`` elements
    into its storage."""
    return flat[skip:].view(shape)


def stack8_input(name, device):
    """stack8's (win, loc) of STACK8_CASES[name], drawn with numpy."""
    import numpy as np
    import torch
    (a, w, s, lane), win_skip, loc_skip, _ = STACK8_CASES[name]
    rng = np.random.default_rng(13)
    win = rng.normal(size=win_skip + a * w).astype(np.float32)
    loc = rng.integers(-(w // 4), w + w // 4 + 1,
                       size=loc_skip + s * lane).astype(np.int32)
    return (_offset(torch.as_tensor(win, device=device), win_skip, (a, w)),
            _offset(torch.as_tensor(loc, device=device), loc_skip, (s, lane)))


def onehot3d_input(name, device):
    """onehot3d's (loc, w) of ONEHOT3D_CASES[name], drawn with numpy."""
    import numpy as np
    import torch
    (r, w, lane), skip, _ = ONEHOT3D_CASES[name]
    loc = np.random.default_rng(14).integers(
        -2, w + 2, size=skip + r * lane).astype(np.int32)
    return _offset(torch.as_tensor(loc, device=device), skip, (r, lane)), w


def check_stack8_onehot3d(device):
    """stack8 on each input of STACK8_CASES and onehot3d on each of
    ONEHOT3D_CASES, on the plan each expects: bitwise the plain version
    and a rerun, each output first NaN in the allocator."""
    import torch
    from vpic_tpu_torch.tools import probe_batched as pb
    for name, (_, _, _, want) in STACK8_CASES.items():
        win, loc = stack8_input(name, device)
        plan = pb.stack8_plan(*win.shape, *loc.shape, win.data_ptr() % 16 == 0,
                              loc.data_ptr() % 16 == 0)
        if (plan.stage, plan.width) != want:
            raise AssertionError(f"stack8 {name}: plan {plan}, expected "
                                 f"(stage, width) {want}")
        check_twice(f"stack8 {name}", lambda: pb.stack8(win, loc),
                    pb.stack8_plain(win, loc))
    for name, (_, _, want) in ONEHOT3D_CASES.items():
        loc, w = onehot3d_input(name, device)
        plan = pb.onehot3d_plan(loc.shape[0], w, loc.shape[1],
                                loc.data_ptr() % 16 == 0)
        if plan.width != want:
            raise AssertionError(f"onehot3d {name}: plan {plan}, expected "
                                 f"width {want}")
        check_twice(f"onehot3d {name}", lambda: pb.onehot3d(loc, w),
                    pb.onehot3d_plain(loc, w))
    torch.cuda.synchronize()
    log(f"  stack8 on {list(STACK8_CASES)} and onehot3d on "
        f"{list(ONEHOT3D_CASES)}: bitwise the plain version and a rerun")


def time_tool_kernel(label, run_k, run_p, kernel_name, bound_ms, bound_by,
                     library=None):
    """The wrapper (CUDA events), the kernel alone (profiler), the plain
    version and the one PyTorch call (where there is one: CUDA events,
    and alone, the sum of its device events per call under the profiler)
    against the bound; fails where the kernel alone beats its bound."""
    p1, k1, k2, p2 = (cuda_ms(run_p, 5), cuda_ms(run_k, 20),
                      cuda_ms(run_k, 20), cuda_ms(run_p, 5))
    kernel_ms, ops = profiled_ms(run_k, 20, (kernel_name,), 1)
    library_ms = library_kernel_ms = None
    lib = ""
    if library is not None:
        library_ms = cuda_ms(library, 20)
        library_kernel_ms = call_profile(library, reps=20)["device_ms"]
        lib = (f", one PyTorch call {library_ms:.4f} ms (alone "
               f"{library_kernel_ms:.4f} ms; the kernel alone over it "
               f"{kernel_ms / library_kernel_ms:.4f})")
    held_to_bound(f"{label}: the kernel alone", kernel_ms, bound_ms)
    log(f"  timing, {label}: wrapper {k1:.4f} / {k2:.4f} ms ({ops:.1f} "
        f"device ops per call), kernel alone {kernel_ms:.4f} ms, plain "
        f"{p1:.4f} / {p2:.4f} ms{lib}; bound {bound_ms:.6f} ms "
        f"({bound_by}), the kernel at {bound_ms / kernel_ms:.4f} of it")
    t = dict(ms=min(k1, k2), kernel_ms=kernel_ms, plain_ms=min(p1, p2),
             bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms)
    if library is not None:
        t["library_kernel_ms"] = library_kernel_ms
    return t


def time_probes(device):
    """Each probe of probe_batched on the tool's inputs; gather3d and
    deposit2d beside torch.einsum on the prepared bf16 operands, stack8
    beside an index of the prepared bf16 window (each through CUDA events
    and alone)."""
    import torch
    from vpic_tpu_torch.tools import probe_batched as pb
    out = {}
    for name in pb.PROBES:
        args = pb.tool_inputs(name, device)
        res = pb.PROBES[name](*args)
        bound_ms, bound_by = pb.probe_bound(name, args, res)
        library = None
        if name in ("gather3d", "deposit2d"):
            a, oh = (t.to(torch.bfloat16) for t in args)
            eq = "aw,rwl->arl" if name == "gather3d" else "krl,rwl->kw"
            library = lambda eq=eq, a=a, oh=oh: torch.einsum(eq, a, oh)
        elif name == "stack8":
            win, loc = args[0].to(torch.bfloat16), args[1].long()
            library = lambda win=win, loc=loc: win[:, loc]
        out[name] = time_tool_kernel(
            name, lambda name=name, args=args: pb.PROBES[name](*args),
            lambda name=name, args=args: pb.PLAIN[name](*args),
            pb.KERNEL_NAMES[name], bound_ms, bound_by, library)
    return out


def time_chains(device):
    """The chain kernel at the tool's dense (8, n) shape (wrapper, alone,
    plain, bound), and through its wrapper and alone (profiler) on each
    of the tool's shapes and on the same window without the block's zero
    rows where it has some: two passes over the shapes in turn, the
    second one kept (the first shape of the first pass may meet the
    card's clocks still rising)."""
    import torch
    from vpic_tpu_torch.tools import vpu_layout_probe as vp
    blocks = {}
    for rows in vp.ROWS:
        shape = vp.block_shape(rows)
        blocks[f"{rows}x{shape[1]}"] = (rows, shape)
        if rows < shape[0]:
            blocks[f"{rows}x{shape[1]} unpadded"] = (rows, (rows, shape[1]))
    passes = []
    for _ in range(2):
        passes.append({})
        for key, (rows, shape) in blocks.items():
            x = torch.ones(shape, device=device)
            passes[-1][key] = cuda_ms(lambda: vp.chain(x, rows), 20)
    per_shape = passes[-1]
    alone = {}
    for key, (rows, shape) in blocks.items():
        x = torch.ones(shape, device=device)
        alone[key] = profiled_ms(lambda: vp.chain(x, rows), 20,
                                 ("vpu_chain_kernel",), 1)[0]
    log("  vpu chain through its wrapper, first pass (ms): " + ", ".join(
        f"{k} {v:.4f}" for k, v in passes[0].items()))
    log("  vpu chain alone (profiler, ms): " + ", ".join(
        f"{k} {v:.4f}" for k, v in alone.items()))
    x = torch.ones(vp.block_shape(8), device=device)
    bound_ms, bound_by = vp.chain_bound(8, x)
    t = time_tool_kernel(f"vpu chain (8, {x.shape[1]}), {vp.REPS} reps",
                         lambda: vp.chain(x, 8),
                         lambda: vp.chain_plain(x, 8), "vpu_chain_kernel",
                         bound_ms, bound_by)
    log("  vpu chain through its wrapper, second pass (ms): " + ", ".join(
        f"{k} {v:.4f}" for k, v in per_shape.items()))
    return dict(t, shapes_ms=per_shape, shapes_kernel_ms=alone)


def phase_drift(device):
    """drift_compare.compare at each size of DRIFT_RUNS, held to the drift
    bar, the field RMS bar and no dropped mover.  Returns the records."""
    from vpic_tpu_torch.tools import drift_compare as dc
    recs = {}
    for label, (steps, npart, nx) in DRIFT_RUNS.items():
        rec = dc.compare(steps, npart, nx, device)
        log(f"  drift_compare {label}: {json.dumps(rec)}")
        if not abs(rec["drift_excess"]) <= DRIFT_EXCESS_BAR:
            raise AssertionError(f"drift_compare {label}: |drift_excess| "
                                 f"{abs(rec['drift_excess']):.3e} above "
                                 f"{DRIFT_EXCESS_BAR}")
        bars = {k: max(FIELD_RMS_BAR, 2 * v)
                for k, v in JAX_FIELD_RMS[label].items()}
        over = {k: (v, bars[k]) for k, v in rec["field_rms"].items()
                if not v <= bars[k]}
        if over:
            raise AssertionError(f"drift_compare {label}: field_rms above "
                                 f"its bar (value, bar): {over}")
        log(f"  drift_compare {label}: field_rms over the JAX package's "
            "own: " + ", ".join(f"{k} {v / JAX_FIELD_RMS[label][k]:.3f}"
                                for k, v in rec["field_rms"].items()))
        if any(rec["dropped_movers"].values()):
            raise AssertionError(f"drift_compare {label}: dropped movers "
                                 f"{rec['dropped_movers']}")
        recs[label] = rec
    return recs


def phase_tools(device, card):
    """Phase 16: the tools' entry points on the card (their main path: the
    launch counts are zeroed before and read after them), each probe
    kernel against its plain version and timed, and the drift comparison.
    Returns the kernels-line entries of the six probe kernels."""
    from vpic_tpu_torch.tools import probe_batched as pb
    from vpic_tpu_torch.tools import vpu_layout_probe as vp
    for counts in (pb.launches, vp.launches):
        for k in counts:
            counts[k] = 0
    t0 = time.perf_counter()
    if pb.main([]) != 0 or vp.main([]) != 0:
        raise AssertionError("a tool's entry point failed")
    launches = dict(vp.launches, **pb.launches)
    log(f"  the tools' entry points: {time.perf_counter() - t0:.2f} s, "
        f"launches {launches}")
    missing = [k for k, v in launches.items() if v < 1]
    if missing:
        raise AssertionError(f"kernels not launched by the tools: {missing}")

    for name in pb.PROBES:
        check_probe(name, device)
    log(f"  {', '.join(pb.PROBES)}: bitwise the plain versions at the "
        "tool's shapes, and bitwise across two runs")
    random_err = {name: check_contraction(name, device)
                  for name in ("gather3d", "deposit2d")}
    for name, cases in PROBE_RAGGED.items():
        for shapes in cases:
            check_contraction(name, device, shapes=shapes)
    check_chains(device)
    check_io4d(device)
    check_stack8_onehot3d(device)
    times = time_probes(device)
    times["vpu_chain"] = time_chains(device)
    t0 = time.perf_counter()
    drift = phase_drift(device)
    log(f"drift_compare ({card}): " + "; ".join(
        f"{k} excess {r['drift_excess']:.3e}, max field_rms "
        f"{max(r['field_rms'].values()):.3e}, port {r['wall_fw']} s, "
        f"reference {r['wall_ref']} s" for k, r in drift.items())
        + f" ({time.perf_counter() - t0:.1f} s)")
    kernels = []
    for name in ("vpu_chain", *pb.PROBES):
        entry = dict(name=name, route="cuda", source=PROBE_SOURCE,
                     replaces=PROBE_REPLACES[name],
                     launches=launches[name], max_abs_err=0.0,
                     **times[name])
        if name in random_err:
            entry["random_max_abs_err"], entry["random_err_over_eps_sum"] = \
                random_err[name]
        kernels.append(entry)
    return kernels, drift


# -- phase 17: the harness tools at full size ---------------------------------

SWEEP_STEPS = 10          # scaling_bench's default
SWEEP_EXTRA_WINDOWS = 2   # windows timed here after the sweep's own
# the sweep's configurations on which the push kernel is checked and
# timed, with the bar: the 3D deck takes check_push's quantum allowance
# (the 3D bar of phase 11); the 2D deck the float bar, the allowance only
# where the float bar cannot be met (check_bar), the species named
SWEEP_PUSH = {(8_000_000, 64, 64, 64): ("64cube", True),
              (16_000_000, 256, 256, 1): ("256sq_8M", False)}


def harness_evidence():
    """The evidence tool twice at its defaults, each on a fresh deck, with
    ``--out`` into a temporary directory: EVIDENCE OK both times, one push
    launch per species and step, and equal checksums.  Returns (the
    records, the push launches of each run)."""
    import shutil
    import tempfile
    from vpic_tpu_torch.particles import push_cuda
    from vpic_tpu_torch.tools import evidence
    tmp = tempfile.mkdtemp(prefix="evidence_smoke_")
    out = os.path.join(tmp, "evidence.jsonl")
    launches = []
    try:
        for run in range(2):
            push_cuda.reset_launch_counts()
            t0 = time.perf_counter()
            if evidence.main(["--out", out]) != 0:
                raise AssertionError(f"evidence run {run + 1}: EVIDENCE "
                                     "SUSPECT")
            launches.append(push_cuda.launches["push"])
            log(f"  evidence run {run + 1}: {time.perf_counter() - t0:.2f} s"
                f", push launches {launches[-1]}")
        with open(out) as fh:
            recs = [json.loads(line) for line in fh.read().splitlines()]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if len(recs) != 2:
        raise AssertionError(f"evidence: {len(recs)} records, not 2")
    for rec, n in zip(recs, launches):
        if n != rec["steps"] * len(rec["species_sha1"]):
            raise AssertionError(f"evidence: {n} push launches in "
                                 f"{rec['steps']} steps")
    for k in ("field_sha1", "species_sha1"):
        if recs[0][k] != recs[1][k]:
            raise AssertionError(f"evidence: {k} differs between two runs "
                                 f"from one seed: {recs[0][k]} vs "
                                 f"{recs[1][k]}")
    log(f"  two evidence runs from one seed: field_sha1 "
        f"{recs[0]['field_sha1']}, species_sha1 {recs[0]['species_sha1']} "
        "equal")
    return recs, launches


def extra_windows(sim, nst):
    """SWEEP_EXTRA_WINDOWS more timed windows of ``nst`` steps; returns
    their step seconds."""
    import torch
    out = []
    for _ in range(SWEEP_EXTRA_WINDOWS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sim.advance_steps(nst)
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) / nst)
    return out


def sweep_push(sim, key, quantum):
    """The push kernel on both species of a sweep deck, voxel-sorted as
    the step sorts them, against the plain push and its twin (the bar of
    SWEEP_PUSH), then on the electrons the walk's counts and the kernel's
    times against its bound.  Returns the push record's ``sweep_<key>_*``
    entries."""
    from vpic_tpu_torch.engine.step import walk_segments
    from vpic_tpu_torch.particles import aux
    st, g = sim.state, sim.grid
    nb, interp = st.grid_arrays.neighbor, st.interpolator
    n_walk = walk_segments(g, sim.opts)
    errs, allowance = [], []
    for sp in st.species:
        sp = aux.sort_p(sp)
        label = f"{key} {sp.name} (n_walk {n_walk})"
        if quantum:
            errs.append(check_push(label, sp, interp, nb, g, n_walk,
                                   quantum=True))
            allowance.append(sp.name)
        else:
            err, q = check_bar(check_push, label, sp, interp, nb, g, n_walk)
            errs.append(err)
            if q:
                allowance.append(sp.name)
        if sp.name == "electron":
            electrons = sp
    c = walk_counts(electrons, interp, nb, g, n_walk)
    log(f"  walk of the sorted {key} electrons (plain, "
        f"{int(electrons.alive.sum())} live lanes in {electrons.max_np} "
        f"slots): {c['pairs']} (lane, segment) pairs, live lanes by "
        f"segments walked {c['lanes_by_segments']}; the quantum allowance "
        f"taken for {allowance or 'no species'}")
    t = time_push(f"{key} electrons", electrons, interp, nb, g, n_walk,
                  c["pairs"])
    return dict({f"sweep_{key}_{k}": v for k, v in t.items()},
                **{f"sweep_{key}_max_abs_err": max(errs),
                   f"sweep_{key}_quantum_species": allowance,
                   f"sweep_{key}_slots": st.species[0].max_np})


def harness_sweep(device, card):
    """scaling_bench.sweep over its seven configurations: per deck one push
    launch per species and step, no dropped mover, finite energies, the
    particle count conserved, two more timed windows and a trace; the push
    kernel checked and timed on the decks of SWEEP_PUSH.  Returns (rows,
    the push launches of the sweep's own steps, the push record's
    entries)."""
    import math
    import statistics
    import torch
    from vpic_tpu_torch.particles import push_cuda
    from vpic_tpu_torch.tools import scaling_bench as sb
    rows, push, launches = [], {}, 0
    push_cuda.reset_launch_counts()
    for (npart, nx, ny, nz), (row, sim) in zip(
            sb.CONFIGS, sb.sweep(sb.CONFIGS, SWEEP_STEPS, device)):
        n = push_cuda.launches["push"]
        nsp = len(sim.state.species)
        if n != (row["period"] + 2 * row["nst"]) * nsp:
            raise AssertionError(f"sweep {sb.csv_row(row)}: {n} push "
                                 f"launches in {row['period']} + 2 x "
                                 f"{row['nst']} steps of {nsp} species")
        launches += n
        nm, e = sim.mover_counts(), sim.energies()
        if any(nm.values()):
            raise AssertionError(f"sweep {sb.csv_row(row)}: dropped movers "
                                 f"{nm}")
        if not all(math.isfinite(v) for v in e.values()):
            raise AssertionError(f"sweep {sb.csv_row(row)}: energies {e}")
        if row["npart"] != 2 * (npart // 2):
            raise AssertionError(f"sweep {sb.csv_row(row)}: {row['npart']} "
                                 f"live particles of {2 * (npart // 2)}")
        step_s = [row["ms_per_step"] / 1e3] + extra_windows(sim, row["nst"])
        med = statistics.median(step_s)
        log(f"  sweep {nx}x{ny}x{nz}, {row['npart']} particles ({card}): "
            f"{sb.csv_row(row)}; built in {row['build_s']:.2f} s; step over "
            f"{1 + SWEEP_EXTRA_WINDOWS} windows of {row['nst']} steps "
            f"{med * 1e3:.4f} ms (min {min(step_s) * 1e3:.4f}, max "
            f"{max(step_s) * 1e3:.4f}), op by op (one window) "
            f"{row['eager_ms_per_step']:.4f} ms; dropped movers {nm}")
        trace = phase_trace(sim, med, label=f"sweep deck {nx}x{ny}x{nz}, "
                            f"{row['npart']} particles")
        if not row["graphed"]:
            raise AssertionError(f"sweep {sb.csv_row(row)}: not graphed")
        rows.append(dict(row, step_ms=[s * 1e3 for s in step_s],
                         median_ms=med * 1e3, busy_ms=trace["busy_ms"],
                         ops=trace["ops"],
                         idle=1 - trace["busy_ms"] / (med * 1e3),
                         parts={k: trace["parts"][k]["busy_ms"]
                                for k in ("step.sort", "step.push",
                                          "step.field")}))
        if (npart, nx, ny, nz) in SWEEP_PUSH:
            push.update(sweep_push(sim, *SWEEP_PUSH[npart, nx, ny, nz]))
        del sim
        torch.cuda.empty_cache()
        push_cuda.reset_launch_counts()
    return rows, launches, push


def harness_profile():
    """profile_step.main at its defaults (2M particles, 128^2, 5 steps),
    its Chrome trace into a temporary directory: sort, push and field each
    with busy device time, push_walk_kernel among the listed ops.
    Returns (the report, its push launches)."""
    import shutil
    import tempfile
    from vpic_tpu_torch.engine.step import CORE_PHASES
    from vpic_tpu_torch.particles import push_cuda
    from vpic_tpu_torch.tools import profile_step
    tmp = tempfile.mkdtemp(prefix="profile_smoke_")
    before = os.environ.get("PROF_DIR")
    os.environ["PROF_DIR"] = tmp
    try:
        push_cuda.reset_launch_counts()
        rep = profile_step.main([])
        launches = push_cuda.launches["push"]
    finally:
        if before is None:
            del os.environ["PROF_DIR"]
        else:
            os.environ["PROF_DIR"] = before
        shutil.rmtree(tmp, ignore_errors=True)
    idle = [k for k in CORE_PHASES if not rep["parts"][k] > 0]
    if idle:
        raise AssertionError(f"profile_step: no busy time in {idle}: "
                             f"{rep['parts']}")
    if not any("push_walk_kernel" in name for name in rep["top"]):
        raise AssertionError("profile_step: push_walk_kernel is not among "
                             f"the listed ops {rep['top'][:10]}")
    if launches < 1:
        raise AssertionError("profile_step: no push launch")
    return rep, launches


def phase_harness(device, card):
    """Phase 17: the harness tools (evidence, the scaling sweep, the
    per-op profile) through their functions at full size.  Returns the push
    record's entries."""
    t0 = time.perf_counter()
    recs, ev_launches = harness_evidence()
    t1 = time.perf_counter()
    rows, sweep_launches, push = harness_sweep(device, card)
    t2 = time.perf_counter()
    rep, prof_launches = harness_profile()
    t3 = time.perf_counter()
    log(f"evidence ({card}): {recs[0]['deck']}, {recs[0]['steps']} steps, "
        f"drift {recs[0]['drift']:.6e} / {recs[1]['drift']:.6e}, wall "
        f"{recs[0]['wall_s']} / {recs[1]['wall_s']} s ({t1 - t0:.1f} s)")
    log(f"scaling sweep ({card}; {t2 - t1:.1f} s): " + "; ".join(
        f"{r['nx']}x{r['ny']}x{r['nz']}/{r['npart']} step "
        f"{r['median_ms']:.4f} ({min(r['step_ms']):.4f}-"
        f"{max(r['step_ms']):.4f}) ms (op by op "
        f"{r['eager_ms_per_step']:.4f}), busy {r['busy_ms']:.4f} ms, ops "
        f"{r['ops']:.1f}, idle {r['idle']:.4f}, sort/push/field "
        + "/".join(f"{v:.4f}" for v in r["parts"].values())
        + f", built {r['build_s']:.2f} s" for r in rows))
    log(f"profile_step ({card}; {t3 - t2:.1f} s): {rep['ms_per_step']:.4f} "
        f"ms/step plain, busy {rep['busy_ms']:.4f} ms/step, "
        f"{rep['ops']:.1f} ops/step, parts "
        + ", ".join(f"{k or 'outside the parts'} {v:.4f}"
                    for k, v in rep["parts"].items() if v))
    return dict(push, tools_evidence_launches=ev_launches,
                tools_sweep_launches=sweep_launches,
                tools_profile_launches=prof_launches)


# -- phase 18: the step as CUDA graphs ---------------------------------------

# each deck: its build and the steps of the bitwise window, which crosses
# a clean step on turbulence (every 50) and trecon (every 25); the bench
# deck's 48 steps are six super-cycles of k = 2, M = 4.  Path B (the
# packed cycle with the merge re-sort) at the deck's cadence (six
# super-cycles) and with every species sorted every step (48 replays of
# one step graph)
GRAPH_DECKS = {
    "bench 128^2, 4M": (lambda device: _bench(device, **SLICE), 48),
    "path B 128^2, 4M": (lambda device: _path_b(device), 48),
    "path B 128^2, 4M, every step": (lambda device: _path_b(
        device, resort_interval=1, ion_sort_mult=1), 48),
    "bench 256^2, 16M": (lambda device: _bench(
        device, nx=256, ny=256, nz=1, npart=8_000_000), 48),
    "turbulence": (lambda device: port_deck("turbulence", device,
                                            TURB_FULL), 56),
    "trecon": (lambda device: port_deck("trecon", device,
                                        RECON["trecon"]["full"]), 32),
}


def _bench(device, **deck):
    from vpic_tpu_torch.decks import bench_deck
    return bench_deck.build(**deck, device=device)


def _path_b(device, **deck):
    """The 128^2 bench deck on path B (``merge_sort=True``)."""
    sim = _bench(device, **SLICE, **deck)
    sim.modify_runparams(merge_sort=True)
    return sim


# the steps at the end of a path B deck's bitwise window that run under
# torch.cuda.set_sync_debug_mode("error"): one super-cycle at the cadence
SYNC_STEPS = 8
# the steps of graph_run's trace of the op-by-op step (the graphed step's
# takes TRACE_STEPS): the profiler's cost grows with the ops it records
EAGER_TRACE_STEPS = 4


def _launch_counts():
    """Every kernel's launches since :func:`_reset_launch_counts`, those
    inside the conditional bodies that the replays ran included
    (engine/cond.settle)."""
    from vpic_tpu_torch.core import random_cuda
    from vpic_tpu_torch.engine import cond
    from vpic_tpu_torch.particles import deposit_cuda, push_cuda, sort_cuda
    cond.settle()
    return dict(push_cuda.launches, **deposit_cuda.launches,
                **sort_cuda.launches, **random_cuda.launches,
                **cond.launches)


def _reset_launch_counts():
    from vpic_tpu_torch.core import random_cuda
    from vpic_tpu_torch.engine import cond
    from vpic_tpu_torch.particles import deposit_cuda, push_cuda, sort_cuda
    for mod in (push_cuda, deposit_cuda, sort_cuda, random_cuda):
        mod.reset_launch_counts()
    cond.reset()


def sort_counts_of():
    """The merge re-sort's fast and slow sorts per species since the last
    reset (the device counters)."""
    from vpic_tpu_torch.particles import sort_cuda
    return sort_cuda.sort_counts()


def merge_launches(sorts, graphed):
    """The merge kernels' launches that ``sorts`` (fast and slow sorts per
    species) give: a mark per sort; eagerly, where both branches run, the
    tables and two assembly launches (the merge and the full sort's
    gather) per sort; in a graph's replays the tables per merge kept and
    one assembly launch per sort, in the conditional body that runs."""
    total = sum(c["fast"] + c["slow"] for c in sorts.values())
    fast = sum(c["fast"] for c in sorts.values())
    return {"merge_mark": total,
            "merge_tables": fast if graphed else total,
            "merge_assemble": total if graphed else 2 * total}


def graph_run(label, build, device, steps, graphed, books=None,
              sync_free=False, extra=None):
    """One deck of GRAPH_DECKS (or of OPEN_GRAPH_DECKS), built alone on
    the card: ``steps`` steps through ``advance`` (``graphed``) or
    ``advance_eager``, then a timed window of STEPS steps, a trace of
    TRACE_STEPS steps of the same stepping (op by op EAGER_TRACE_STEPS)
    and, graphed, two more timed windows (op by op one window in all),
    with the card's peak memory over it all.  ``books(sim, n0)``: the
    deck's particle books after the ``steps`` steps (n0 the live lanes at
    build).  ``sync_free``: the last
    SYNC_STEPS of the ``steps`` run under
    ``torch.cuda.set_sync_debug_mode("error")``, so a host read or a copy
    from the host there raises.  Returns what phases 18-20 compare and
    record (``sorts``: the merge re-sort's fast and slow sorts in the
    ``steps``; ``end``: the checksums, every shard's random state and the
    books again after the first window and the trace, at the step that
    the most retried trace would reach, where every run of the deck goes
    on to; ``wait_ms``: on several shards the host wait at the rendezvous
    per step and shard in the timed windows, 0 on replays).  ``extra(sim)``:
    graphed, after the last window, a dict of more fields of the
    record."""
    import statistics
    import torch
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sim = build(device)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    t_run = time.perf_counter()
    if not sim.graphed:
        raise AssertionError(f"{label}: _graph_ok() refuses the deck")
    n0 = alive_count(sim) if books else None
    advance = sim.advance_steps if graphed else sim.advance_eager
    _reset_launch_counts()
    sim.dispatch_counts.clear()
    if sync_free:
        advance(steps - SYNC_STEPS)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            advance(SYNC_STEPS)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    else:
        advance(steps)
    torch.cuda.synchronize()
    from vpic_tpu_torch.particles import sort_cuda
    launches = _launch_counts()
    # the conditional nodes' set kernel runs only in graphs
    out = dict(launches=launches,
               cond_launches=launches.pop("cond_set_if"),
               sorts=sort_cuda.sort_counts(),
               dispatch=dict(sim.dispatch_counts),
               fields=sim.checksum_fields(),
               species=[sim.checksum_species(h["name"])
                        for h in sim._species],
               energies=sim.energies(), movers=sim.mover_counts(),
               rng=[st.rng.tolist() for st in sim.states],
               books=books(sim, n0) if books else None, build_s=build_s)
    if graphed:
        # the reads above copied the state out of the graphs' buffers: it
        # goes back in here, not inside the first timed window
        sim.advance_steps(0)
    rv = sim.comms[0].rv
    wait0 = sum(rv.wait_s)
    step_s = []

    def window():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        advance(STEPS)
        torch.cuda.synchronize()
        step_s.append((time.perf_counter() - t0) / STEPS)

    window()
    out["wait_ms"] = ((sum(rv.wait_s) - wait0) / sim.grid.n_shards
                      / STEPS * 1e3)
    advance(-sim.step_count % (sim.opts.resort_interval * 4))
    t_trace = time.perf_counter()
    end = sim.step_count + TRACE_STEPS * PROFILE_ATTEMPTS
    traced = TRACE_STEPS if graphed else EAGER_TRACE_STEPS
    wall_us, dev, _, lost, b = _trace(sim, advance, traced)
    torch.cuda.synchronize()
    out["trace_s"] = time.perf_counter() - t_trace
    # the trace steps again where the profiler drops device events, so two
    # runs of one deck can leave it at different steps
    advance(end - sim.step_count)
    torch.cuda.synchronize()
    out["end"] = dict(step=sim.step_count, fields=sim.checksum_fields(),
                      species=[sim.checksum_species(h["name"])
                               for h in sim._species],
                      rng=[st.rng.tolist() for st in sim.states],
                      books=books(sim, n0) if books else None)
    out["run_s"] = t_trace - t_run
    if graphed:
        sim.advance_steps(0)
        for _ in range(WINDOWS - 1):
            window()
        if extra is not None:
            out.update(extra(sim))
    out.update(step_ms=statistics.median(step_s) * 1e3,
               step_min_ms=min(step_s) * 1e3, step_max_ms=max(step_s) * 1e3,
               busy_ms=b["busy_ms"], ops=b["ops"], parts=b["parts"],
               reads=sum("DtoH" in e.name for e in dev) / traced,
               traced_wall_ms=wall_us / traced / 1e3,
               peak_gb=(torch.cuda.max_memory_allocated() - base) / 1e9,
               reserved_gb=torch.cuda.memory_reserved() / 1e9,
               captures=list(sim.capture_times))
    out["idle_share"] = 1 - out["busy_ms"] / out["step_ms"]
    del sim
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return out


def captures_text(captures) -> str:
    """The log's text of a run's capture records (``sim.capture_times``):
    per capture the unit, the warm-up and capture seconds, its nodes and
    instantiation seconds."""
    if not captures:
        return ""
    return ", captures " + "; ".join(
        f"{c['kind']} of {c['steps']} steps: warm-up {c['warmup_s']:.3f} s, "
        f"capture {c['capture_s']:.3f} s, {c['nodes']} nodes "
        f"({c['node_types'].get('conditional', 0)} conditional), "
        f"instantiated in {c['instantiate_s']:.3f} s" for c in captures)


def phase_graphs(device, card):
    """Phase 18: each deck of GRAPH_DECKS graphed and eager, each built
    alone from the same seed: after the bitwise window the same
    checksum_fields, species checksums, energies and dropped movers (0),
    the same kernel launches (a replay adds its graph's) and fast and
    slow sorts, and the same checksums and random state after the windows
    and the trace; on the bench deck and path B at its cadence 48 steps
    as six super-cycle replays, path B sorting every step 48 replays of
    one step graph, one capture and no eager step; on path B the last
    SYNC_STEPS of the window with no host read (graphed and eager), and
    none in the graphed trace; the wall step (three 16-step windows),
    busy ms, ops, host reads and idle share from a trace, the peak memory
    and each graph's capture time of both.  Returns the record of each
    deck."""
    recs = {}
    for label, (build, steps) in GRAPH_DECKS.items():
        path_b = label.startswith("path B")
        g = graph_run(label, build, device, steps, True, sync_free=path_b)
        e = graph_run(label, build, device, steps, False, sync_free=path_b)
        for key in ("fields", "species", "energies", "movers", "launches",
                    "sorts", "end"):
            a, b = g[key], e[key]
            if key == "launches" and path_b:
                # the tables and the assembly run in the merge's
                # conditional body: per merge kept graphed, per sort eager
                for r, graphed in ((g, True), (e, False)):
                    want = merge_launches(r["sorts"], graphed)
                    if any(r[key][k] != v for k, v in want.items()):
                        how = "graphed" if graphed else "eager"
                        raise AssertionError(
                            f"{label}: merge launches {r[key]} for sorts "
                            f"{r['sorts']} ({how})")
                a, b = ({k: v for k, v in r.items() if k not in (
                    "merge_tables", "merge_assemble")} for r in (a, b))
            if a != b:
                raise AssertionError(f"{label}: graphed {key} {a} vs "
                                     f"eager {b}")
        if any(g["movers"].values()):
            raise AssertionError(f"{label}: dropped movers {g['movers']}")
        if g["dispatch"].get("eager_steps") or \
                g["dispatch"]["graphed_steps"] != steps or \
                e["dispatch"] != {"eager_steps": steps}:
            raise AssertionError(f"{label}: dispatch {g['dispatch']}, "
                                 f"eager {e['dispatch']}")
        units = ({"replays.step": steps} if label.endswith("every step")
                 else {"replays.supercycle": steps // 8})
        if (label.startswith("bench") or path_b) and g["dispatch"] != dict(
                captures=1, graphed_steps=steps, **units):
            raise AssertionError(f"{label}: {steps} steps dispatched as "
                                 f"{g['dispatch']}, not {units} of one "
                                 "capture")
        if path_b and (g["reads"] or not g["sorts"]):
            raise AssertionError(f"{label}: {g['reads']} host reads per "
                                 f"graphed step, sorts {g['sorts']}")
        log(f"  {label} ({card}): after {steps} steps graphed = eager "
            f"bitwise (fields {g['fields'][:16]}..., species checksums, "
            f"energies, dropped movers {g['movers']}, launches "
            f"{ {k: v for k, v in g['launches'].items() if v} }; the "
            f"conditional nodes' set kernels {g['cond_launches']} graphed"
            + (f", sorts {g['sorts']}, no host read in the last "
               f"{SYNC_STEPS} steps of either" if path_b else "")
            + f"), and again after the windows and the trace at step "
            f"{g['end']['step']}; graphed dispatch {g['dispatch']}")
        for name, r in (("graphed", g), ("eager", e)):
            log(f"  {label}, {name}: step {r['step_ms']:.4f} ms "
                f"({r['step_min_ms']:.4f}-{r['step_max_ms']:.4f}), busy "
                f"{r['busy_ms']:.4f} ms/step, {r['ops']:.1f} ops/step, host "
                f"reads {r['reads']:.1f}/step, idle share "
                f"{r['idle_share']:.4f}, traced wall "
                f"{r['traced_wall_ms']:.4f} ms/step, peak allocated "
                f"{r['peak_gb']:.3f} GB (reserved {r['reserved_gb']:.3f}), "
                f"built in {r['build_s']:.2f} s"
                + captures_text(r["captures"]))
        recs[label] = {name: {k: r[k] for k in (
            "step_ms", "step_min_ms", "step_max_ms", "busy_ms", "ops",
            "idle_share", "peak_gb", "captures", "cond_launches")}
            for name, r in (("graphed", g), ("eager", e))}
    return recs


# -- phase 19: the open decks as CUDA graphs ---------------------------------

THREEFRY_SOURCE = "vpic_tpu_torch/csrc/threefry.cu"
# what it replaces: XLA's threefry2x32 under jax.random, drawn at the
# reflux handler first (no Pallas kernel draws in the JAX package)
THREEFRY_REPLACES = ("vpic_tpu/boundary/models.py:71 (jax.random: XLA's "
                     "threefry2x32, no pl.pallas_call)")
# H100 SXM int32: NVIDIA publishes no rate.  An SM issues 4 warp
# instructions a clock (128 lanes), and integer adds issue on the FMA
# pipe (IMAD) as well as on the 64 int32 lanes, so no integer code beats
# 128 lanes x 132 SMs x the 1.98 GHz boost clock of the 67 TFLOP/s
# float32 rate
INT32_OPS_PER_S = 132 * 128 * 1.98e9
# the hash's int32 operations per counter at the least: 20 rounds of an
# add, a rotate (one funnel shift) and a xor, 6 key injections of two
# adds (the key's words and the injections' sums are loop-invariant); the
# uniform's xor of the words, shift and or; its float32 operations
# (subtract, fma, max) and the normal's (its uniform's, log1p, a square,
# sqrt or subtract, 8 fmas, 2 multiplies)
THREEFRY_INT_OPS = {"split": 72, "uniform": 75, "normal": 75}
THREEFRY_FLOAT_OPS = {"split": 0, "uniform": 3, "normal": 3 + 20 + 4 + 8 + 2}
THREEFRY_BYTES = {"split": 16, "uniform": 4, "normal": 4}
# the 256^2 collisions deck's slots: each step draws a normal and a
# uniform over them
THREEFRY_LANES = 5_242_880
NORMAL_ULPS = 8
OPEN_GRAPH_STEPS = 32


def threefry_bound(what, n):
    """(ms, "bytes" or "operations") of n counters of ``what``: the words
    written over 3.35 TB/s, or the int32 operations over INT32_OPS_PER_S
    or the float32 ones over 67 TFLOP/s, whichever is larger (the key's
    16 bytes are read once)."""
    t_bytes = (n * THREEFRY_BYTES[what] + 16) / HBM_BYTES_PER_S
    t_ops = max(n * THREEFRY_INT_OPS[what] / INT32_OPS_PER_S,
                n * THREEFRY_FLOAT_OPS[what] / FP32_OPS_PER_S)
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def ulps(a, b):
    """The largest distance in float32 ulps between two float32 tensors."""
    import torch
    ia = a.view(torch.int32).long()
    ib = b.view(torch.int32).long()
    # ordered integers: negative floats count down from 0
    fix = lambda i: torch.where(i < 0, -(i & 0x7FFFFFFF), i)
    return int((fix(ia) - fix(ib)).abs().max()) if a.numel() else 0


def check_threefry(device, seed=20240):
    """The threefry kernel's three outputs at n counters under one key on
    the card: split and uniform (over (0, 1), (1e-38, 1), (-1, 1) and
    (0, 2 pi)) bitwise the plain twin's on the card and on the CPU (the
    key copied there), normal within NORMAL_ULPS of both, and a rerun
    bitwise equal.  Returns {output: max abs error against the twin on the
    card}."""
    import math
    import torch
    from vpic_tpu_torch.core import random as rnd
    n = THREEFRY_LANES
    key = rnd.split(rnd.make_key(seed, device), 3)[2]
    ckey = key.cpu()
    cases = [("split", lambda k: rnd.split(k, n),
              lambda k: rnd.plain_split(k, n))]
    for lo, hi in ((0.0, 1.0), (1e-38, 1.0), (-1.0, 1.0),
                   (0.0, 2.0 * math.pi)):
        cases.append(("uniform", lambda k, lo=lo, hi=hi: rnd.uniform(
            k, n, lo, hi), lambda k, lo=lo, hi=hi: rnd.plain_uniform(
                k, n, lo, hi)))
    cases.append(("normal", lambda k: rnd.normal(k, n),
                  lambda k: rnd.plain_normal(k, n)))
    errs = {}
    for what, run_k, run_p in cases:
        out, again = run_k(key), run_k(key)
        torch.cuda.synchronize()
        card, cpu = run_p(key), run_p(ckey)
        if out.device != key.device or not torch.equal(out, again):
            raise AssertionError(f"threefry {what}: two runs differ")
        if what == "normal":
            u_card, u_cpu = ulps(out, card), ulps(out.cpu(), cpu)
            if max(u_card, u_cpu) > NORMAL_ULPS or not bool(
                    torch.isfinite(out).all()):
                raise AssertionError(f"threefry normal: {u_card} ulps from "
                                     f"the twin on the card, {u_cpu} from "
                                     f"the CPU's (bar {NORMAL_ULPS})")
            err = float((out - card).abs().max())
            log(f"  threefry normal, {n} counters: within {u_card} ulps of "
                f"the twin on the card (max abs {err:.3e}) and {u_cpu} of "
                "the twin on the CPU; rerun bitwise")
        else:
            if not torch.equal(out, card) or not torch.equal(out.cpu(), cpu):
                raise AssertionError(f"threefry {what}: not bitwise the "
                                     "twin's on the card and the CPU's")
            err = 0.0
            log(f"  threefry {what}, {n} counters: bitwise the twin on the "
                "card and on the CPU; rerun bitwise")
        errs[what] = max(errs.get(what, 0.0), err)
    return errs


def time_threefry(device):
    """Each output at n counters: the wrapper (CUDA events), the kernel
    alone (profiler) and the plain twin on the card, against the bound;
    fails where a time beats it.  Returns {output: timing dict}."""
    from vpic_tpu_torch.core import random as rnd
    n = THREEFRY_LANES
    key = rnd.make_key(7, device)
    runs = {"split": (lambda: rnd.split(key, n),
                      lambda: rnd.plain_split(key, n)),
            "uniform": (lambda: rnd.uniform(key, n, 0.0, 1.0),
                        lambda: rnd.plain_uniform(key, n, 0.0, 1.0)),
            "normal": (lambda: rnd.normal(key, n),
                       lambda: rnd.plain_normal(key, n))}
    out = {}
    for what, (run_k, run_p) in runs.items():
        p1, k1, k2, p2 = (cuda_ms(run_p, 5), cuda_ms(run_k, 20),
                          cuda_ms(run_k, 20), cuda_ms(run_p, 5))
        kernel_ms, ops = profiled_ms(run_k, 20, ("threefry_kernel",), 1)
        bound_ms, bound_by = threefry_bound(what, n)
        held_to_bound(f"threefry {what}: the kernel alone", kernel_ms,
                      bound_ms)
        held_to_bound(f"threefry {what}: the wrapper", min(k1, k2), bound_ms)
        log(f"  timing, threefry {what} at {n} counters: wrapper "
            f"{k1:.4f} / {k2:.4f} ms ({ops:.1f} device ops per call), "
            f"kernel alone {kernel_ms:.4f} ms, plain twin {p1:.4f} / "
            f"{p2:.4f} ms; bound {bound_ms:.4f} ms ({bound_by}), the kernel "
            f"at {bound_ms / kernel_ms:.4f} of it")
        out[what] = dict(ms=min(k1, k2), kernel_ms=kernel_ms,
                         plain_ms=min(p1, p2), bound_ms=bound_ms,
                         bound_by=bound_by, library_ms=None)
    return out


def _open_graph_deck(variant):
    return lambda device: open_box(device, variant, **OPEN_FULL)


def _coll_graph_deck(size):
    def build(device):
        import importlib
        saved = {k: os.environ.get(k) for k in size}
        os.environ.update(size)
        try:
            return importlib.import_module(
                "vpic_tpu_torch.decks.collisions").deck(device=device)
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k)
                else:
                    os.environ[k] = v
    return build


OPEN_GRAPH_DECKS = dict(
    {f"open {v}": (_open_graph_deck(v), v) for v in OPEN_VARIANTS},
    **{f"collisions {k}": (_coll_graph_deck(v), None)
       for k, v in COLL_SIZES.items()})


def open_books(variant):
    """The books of phase 13's checks after a run: (sim, n0) -> counts."""
    def books(sim, n0):
        return open_counts(sim, variant, n0) if variant else dict(
            alive=alive_count(sim), dropped=sim.mover_counts()["electron"])
    return books


def check_books(label, variant, c):
    if c["dropped"]:
        raise AssertionError(f"{label}: dropped movers {c}")
    if variant == "reflux" and c["gone"]:
        raise AssertionError(f"{label}: the reflux walls lost {c['gone']}")
    if variant == "tally" and c["tally"] != c["gone"]:
        raise AssertionError(f"{label}: tally {c['tally']} != gone "
                             f"{c['gone']}")
    if variant == "link" and c["ring"] != c["gone"]:
        raise AssertionError(f"{label}: ring {c['ring']} != gone "
                             f"{c['gone']}")


def phase_open_graphs(device, card):
    """Phase 19: the threefry kernel against its twin and timed, then each
    deck of OPEN_GRAPH_DECKS graphed and eager, each built alone from one
    seed: after OPEN_GRAPH_STEPS steps the same checksums, energies,
    random state, books and kernel launches, bit for bit, and the same
    checksums, random state and books after the windows (80 steps, when
    the walls have taken lanes) and the trace; no dropped
    mover, the books balanced, the whole run graphed and no host read in
    the graphed trace.  Returns (the threefry errors, its timings, the
    record of each deck, the threefry launches of each graphed run)."""
    import torch
    errs = check_threefry(device)
    timing = time_threefry(device)
    torch.cuda.empty_cache()
    recs, launches = {}, {}
    steps = OPEN_GRAPH_STEPS
    for label, (build, variant) in OPEN_GRAPH_DECKS.items():
        books = open_books(variant)
        g = graph_run(label, build, device, steps, True, books)
        e = graph_run(label, build, device, steps, False, books)
        for key in ("fields", "species", "energies", "movers", "launches",
                    "rng", "books", "end"):
            if g[key] != e[key]:
                raise AssertionError(f"{label}: graphed {key} {g[key]} vs "
                                     f"eager {e[key]}")
        check_books(label, variant, g["books"])
        check_books(label, variant, g["end"]["books"])
        if g["dispatch"].get("eager_steps") or \
                g["dispatch"]["graphed_steps"] != steps or \
                e["dispatch"] != {"eager_steps": steps}:
            raise AssertionError(f"{label}: dispatch {g['dispatch']}, "
                                 f"eager {e['dispatch']}")
        if g["reads"]:
            raise AssertionError(f"{label}: {g['reads']} host reads per "
                                 "graphed step")
        drawn = {k: v for k, v in g["launches"].items()
                 if k.startswith("threefry") and v}
        if not drawn.get("threefry_split"):
            raise AssertionError(f"{label}: no threefry launch in "
                                 f"{g['launches']}")
        launches[label] = drawn
        log(f"  {label} ({card}): after {steps} steps graphed = eager "
            f"bitwise (fields {g['fields'][:16]}..., species checksums, "
            f"energies, rng {g['rng']}, books {g['books']}, launches "
            f"{ {k: v for k, v in g['launches'].items() if v} }), and again "
            f"after the windows and the trace at step {g['end']['step']} "
            f"(books {g['end']['books']}); graphed dispatch "
            f"{g['dispatch']}, host reads per graphed step "
            f"{g['reads']:.1f}")
        for name, r in (("graphed", g), ("eager", e)):
            log(f"  {label}, {name}: step {r['step_ms']:.4f} ms "
                f"({r['step_min_ms']:.4f}-{r['step_max_ms']:.4f}), busy "
                f"{r['busy_ms']:.4f} ms/step, {r['ops']:.1f} ops/step, host "
                f"reads {r['reads']:.1f}/step, idle share "
                f"{r['idle_share']:.4f}, peak allocated {r['peak_gb']:.3f} "
                f"GB, built in {r['build_s']:.2f} s"
                + ("; busy ms by step part " + ", ".join(
                    f"{k} {v:.4f}" for k, v in r["parts"].items() if k and v)
                   if name == "eager" else "")
                + captures_text(r["captures"]))
        recs[label] = {name: {k: r[k] for k in (
            "step_ms", "step_min_ms", "step_max_ms", "busy_ms", "ops",
            "idle_share", "peak_gb", "captures")}
            for name, r in (("graphed", g), ("eager", e))}
        recs[label]["eager"]["parts_busy_ms"] = {
            k: v for k, v in e["parts"].items() if k}
        recs[label]["push_launches"] = g["launches"]["push"]
        recs[label]["graphed_reads"] = g["reads"]
    return errs, timing, recs, launches


def open_fields(recs):
    """The push record's open_* and collisions_* fields that phase 19
    measures: per open variant its graphed busy ms, ops, idle share and
    host reads, its op-by-op step and its rounds' and emitters' busy ms;
    per collisions size its push launches, graphed and op-by-op step,
    busy ms and the hook's busy ms."""
    fields = {}
    for variant in OPEN_VARIANTS:
        rec = recs[f"open {variant}"]
        parts = rec["eager"]["parts_busy_ms"]
        fields.update({f"open_{variant}_{k}": v for k, v in dict(
            busy_ms=rec["graphed"]["busy_ms"],
            ops_per_step=rec["graphed"]["ops"],
            idle_share=rec["graphed"]["idle_share"],
            host_reads_per_step=rec["graphed_reads"],
            eager_step_ms=rec["eager"]["step_ms"],
            boundary_busy_ms=parts["step.boundary"],
            emit_busy_ms=parts["step.emit"]).items()})
    for name in COLL_SIZES:
        rec = recs[f"collisions {name}"]
        key = f"collisions_{name.replace('^2', 'sq')}"
        fields.update({
            f"{key}_launches": rec["push_launches"],
            f"{key}_step_ms": rec["graphed"]["step_ms"],
            f"{key}_busy_ms": rec["graphed"]["busy_ms"],
            f"{key}_eager_step_ms": rec["eager"]["step_ms"],
            f"{key}_collide_busy_ms":
            rec["eager"]["parts_busy_ms"]["step.collide"]})
    return fields


# -- phase 20: the sharded decks as CUDA graphs -------------------------------

# each sharded deck of phase 15 and the steps of its bitwise window
# before the timed ones: a super-cycle of the bench deck; turbulence's,
# with the first window and the trace after it, goes on past its clean at
# step 50 (its allsums and Marder passes conditional nodes around both
# shards' parts) before the end record (step 72)
SHARD_GRAPH_DECKS = {
    "bench 128^2 on 2x2 shards": (
        lambda device: shard_bench(device, **SHARD_MESH), 8),
    "turbulence on 2 z shards": (
        lambda device: port_deck("turbulence", device, TURB_SHARDED), 16),
}


# clean steps whose replay phase 20 times, each beside the plain step
# after it
CLEAN_SAMPLES = 3


def clean_replays(sim, samples=CLEAN_SAMPLES):
    """CUDA-event times of ``samples`` replays of a clean step (a multiple
    of the deck's div-E clean interval; its cleans, sync and Marder passes
    conditional bodies that the profiler's trace does not see) and of the
    plain step after each, through ``advance_steps(1)`` (the host's
    dispatch of one replay included); then the busy device ms and ops of
    the next clean step taken op by op (a trace of ``advance_eager(1)``,
    both Marder branches run; None where the profiler had to trace again
    and so traced a later step)."""
    import torch
    every = sim.opts.clean_div_e_interval
    out = dict(clean_replay_ms=[], plain_replay_ms=[],
               clean_steps=[])
    for _ in range(samples):
        sim.advance_steps(-sim.step_count % every)
        out["clean_steps"].append(sim.step_count)
        for key in ("clean_replay_ms", "plain_replay_ms"):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            sim.advance_steps(1)
            end.record()
            end.synchronize()
            out[key].append(start.elapsed_time(end))
    sim.advance_steps(-sim.step_count % every)
    clean = sim.step_count
    sim.states      # the copy out of the graphs' buffers, not traced
    _, _, _, _, b = _trace(sim, sim.advance_eager, 1)
    once = sim.step_count == clean + 1
    out.update(eager_clean_step=clean,
               eager_clean_busy_ms=b["busy_ms"] if once else None,
               eager_clean_ops=b["ops"] if once else None)
    return out


def phase_shard_graphs(device, card):
    """Phase 20: each deck of SHARD_GRAPH_DECKS graphed and op by op, each
    built alone from one seed: after the bitwise window, and again after
    the windows and the trace, the same checksums over every shard,
    energies, dropped movers (0), every shard's random state and kernel
    launches; the whole window graphed (the bench deck's 48 steps six
    super-cycle replays of one capture; turbulence's steps replays of one
    capture, the clean steps and the others alike, its cleans conditional
    nodes), no host read per graphed step; the wall step of three 16-step
    windows, busy ms, ops, idle share, peak memory, the captures
    (seconds, nodes by type) and the host wait at the rendezvous of both;
    turbulence's clean-step replays timed with CUDA events beside plain
    ones (:func:`clean_replays`).  Then ``dryrun_multichip(4)`` on the
    card, with its dispatch assertion.  Returns the record of each
    deck."""
    from vpic_tpu_torch.engine.distributed import dryrun_multichip
    recs = {}
    for label, (build, steps) in SHARD_GRAPH_DECKS.items():
        turb = label.startswith("turbulence")
        g = graph_run(label, build, device, steps, True,
                      extra=clean_replays if turb else None)
        e = graph_run(label, build, device, steps, False)
        for key in ("fields", "species", "energies", "movers", "launches",
                    "rng", "end"):
            if g[key] != e[key]:
                raise AssertionError(f"{label}: graphed {key} {g[key]} vs "
                                     f"eager {e[key]}")
        if any(g["movers"].values()):
            raise AssertionError(f"{label}: dropped movers {g['movers']}")
        if g["dispatch"].get("eager_steps") or \
                g["dispatch"]["graphed_steps"] != steps or \
                e["dispatch"] != {"eager_steps": steps}:
            raise AssertionError(f"{label}: dispatch {g['dispatch']}, "
                                 f"eager {e['dispatch']}")
        if label.startswith("bench") and g["dispatch"] != {
                "captures": 1, "replays.supercycle": steps // 8,
                "graphed_steps": steps}:
            raise AssertionError(f"{label}: {steps} steps dispatched as "
                                 f"{g['dispatch']}, not {steps // 8} "
                                 "super-cycle replays of one capture")
        if turb:
            conds = [c["node_types"].get("conditional", 0)
                     for c in g["captures"]]
            if g["dispatch"] != {"captures": 1, "replays.step": steps,
                                 "graphed_steps": steps} or \
                    len(conds) != 1 or conds[0] < 6:
                raise AssertionError(
                    f"{label}: {steps} steps dispatched as {g['dispatch']}, "
                    f"captures with {conds} conditional nodes, not one "
                    "capture whose cleans and sync are conditional nodes")
        if g["reads"] or g["wait_ms"]:
            raise AssertionError(f"{label}: {g['reads']} host reads and "
                                 f"{g['wait_ms']} ms of rendezvous wait per "
                                 "graphed step")
        log(f"  {label} ({card}): after {steps} steps graphed = op by op "
            f"bitwise on every shard (fields {g['fields'][:16]}..., species "
            f"checksums, energies, rng of {len(g['rng'])} shards, dropped "
            f"movers {g['movers']}, launches "
            f"{ {k: v for k, v in g['launches'].items() if v} }), and again "
            f"after the windows and the trace at step {g['end']['step']}; "
            f"graphed dispatch "
            f"{g['dispatch']}")
        for name, r in (("graphed", g), ("op by op", e)):
            log(f"  {label}, {name}: step {r['step_ms']:.4f} ms "
                f"({r['step_min_ms']:.4f}-{r['step_max_ms']:.4f}), busy "
                f"{r['busy_ms']:.4f} ms/step, {r['ops']:.1f} ops/step, host "
                f"reads {r['reads']:.1f}/step, idle share "
                f"{r['idle_share']:.4f}, rendezvous wait "
                f"{r['wait_ms']:.4f} ms/step per shard, peak allocated "
                f"{r['peak_gb']:.3f} GB, built in {r['build_s']:.2f} s, "
                f"stepped in {r['run_s']:.2f} s, traced in "
                f"{r['trace_s']:.2f} s" + captures_text(r["captures"]))
        recs[label] = {name: {k: r[k] for k in (
            "step_ms", "step_min_ms", "step_max_ms", "busy_ms", "ops",
            "idle_share", "wait_ms", "peak_gb", "captures")}
            for name, r in (("graphed", g), ("eager", e))}
        if turb:
            log(f"  {label}, graphed ({card}): replays of the clean steps "
                f"{g['clean_steps']} "
                f"{[round(t, 4) for t in g['clean_replay_ms']]} ms, of the "
                f"plain steps after them "
                f"{[round(t, 4) for t in g['plain_replay_ms']]} ms (CUDA "
                "events around advance_steps(1)); the clean step "
                f"{g['eager_clean_step']} op by op: busy "
                f"{g['eager_clean_busy_ms']} ms, {g['eager_clean_ops']} ops "
                "(a trace; both Marder branches run)")
            recs[label]["graphed"].update(
                {k: g[k] for k in ("clean_replay_ms", "plain_replay_ms",
                                   "clean_steps", "eager_clean_step",
                                   "eager_clean_busy_ms",
                                   "eager_clean_ops")})
        recs[label]["push_launches"] = g["launches"]["push"]
        recs[label]["walk_only_launches"] = g["launches"]["walk_only"]
    t0 = time.perf_counter()
    dryrun_multichip(4, device=device, log=lambda m: log("  " + m))
    recs["dryrun_multichip_4_s"] = time.perf_counter() - t0
    return recs


# -- phase 21: the step decides on the card -----------------------------------

ENTRY_STEPS = 16
RESTORE_STEPS = 16        # path B before its checkpoint; 8 more, then 8 again


def path_b_restore(device, label, deck, tmp):
    """Path B at 128^2 (``deck``: its cadence) graphed and op by op from
    one seed: RESTORE_STEPS steps, a checkpoint, 8 steps, a restore (no
    merge carry: each species' first sort after it is a full sort) and 8
    steps again, then the same field and species checksums, energies and
    fast and slow sorts, bit for bit, and no dropped mover."""
    from vpic_tpu_torch.particles import sort_cuda
    out = []
    for graphed in (True, False):
        sim = _path_b(device, **deck)
        advance = sim.advance_steps if graphed else sim.advance_eager
        sort_cuda.reset_launch_counts()
        advance(RESTORE_STEPS)
        path = os.path.join(tmp, f"path_b_{graphed}")
        sim.checkpoint(path)
        advance(8)
        sim.restore(path)
        advance(8)
        out.append(dict(fields=sim.checksum_fields(),
                        species=[sim.checksum_species(h["name"])
                                 for h in sim._species],
                        energies=sim.energies(), movers=sim.mover_counts(),
                        sorts=sort_cuda.sort_counts(),
                        dispatch=dict(sim.dispatch_counts)))
        del sim
    g, e = out
    for key in ("fields", "species", "energies", "movers", "sorts"):
        if g[key] != e[key]:
            raise AssertionError(f"path B {label} across a restore: graphed "
                                 f"{key} {g[key]} vs eager {e[key]}")
    if any(g["movers"].values()) or g["dispatch"].get("eager_steps"):
        raise AssertionError(f"path B {label}: movers {g['movers']}, "
                             f"dispatch {g['dispatch']}")
    log(f"  path B 128^2 {label}: {RESTORE_STEPS} steps, a checkpoint, 8 "
        f"steps, a restore and 8 steps, graphed = op by op bitwise (fields "
        f"{g['fields'][:16]}..., species, energies, sorts {g['sorts']}, "
        f"dropped movers {g['movers']}); graphed dispatch {g['dispatch']}")
    return g["sorts"]


COND_CHAIN = 64           # conds in the graph that times the nodes
COND_REPLACES = ("vpic_tpu/engine/step.py:411 (lax.cond, which XLA "
                 "lowers to its own conditional: no Pallas kernel)")


def time_cond(device):
    """engine/cond.cond's nodes against the select: COND_CHAIN conds in a
    row on a 1024-float vector, each taking v + 1 or v - 1, captured into
    one graph: each replay bitwise the select's result for the
    predicate's value at that replay; per cond the replay's ms (CUDA
    events; two set kernels, two conditional nodes, the branch's kernel)
    against the select's eagerly (both branches and a torch.where), the
    bound of the two set kernels' reads of the predicate (2 bytes)."""
    import torch
    from vpic_tpu_torch.engine import cond
    cond.prepare(device)
    x = torch.zeros(1024, device=device)
    p = torch.ones((), dtype=torch.bool, device=device)

    def chain():
        v = x
        for _ in range(COND_CHAIN):
            v = cond.cond(p, lambda v: v + 1, lambda v: v - 1, (v,))
        return v

    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        chain()
        graph = torch.cuda.CUDAGraph()
        graph.capture_begin()
        try:
            out = chain()
        finally:
            graph.capture_end()
    torch.cuda.current_stream(device).wait_stream(side)
    for flag in (True, False):
        p.fill_(flag)
        graph.replay()
        if not _bitwise_equal(out, chain()):
            raise AssertionError(f"cond chain: the replay differs from the "
                                 f"select for {flag}")
    p.fill_(True)
    n1, n2 = cuda_ms(graph.replay, 20), cuda_ms(graph.replay, 20)
    s1, s2 = cuda_ms(chain, 20), cuda_ms(chain, 20)
    b_ms, b_by = bound(2, 0)
    rec = dict(ms=min(n1, n2) / COND_CHAIN, plain_ms=min(s1, s2) / COND_CHAIN,
               bound_ms=b_ms, bound_by=b_by, library_ms=None,
               max_abs_err=0.0)
    log(f"  {COND_CHAIN} conds captured as conditional nodes: a replay "
        f"{n1:.4f} / {n2:.4f} ms, {rec['ms'] * 1e3:.3f} us a cond; the "
        f"select eagerly {s1:.4f} / {s2:.4f} ms ({rec['plain_ms'] * 1e3:.3f}"
        f" us a cond); bitwise for both predicates")
    return rec


def phase_on_card(device, card, graph_recs):
    """Phase 21: the step decides on the card (engine/cond.py).  The
    route of the conditional nodes with PyTorch's and CUDA's versions;
    vpic_tpu_torch.entry.entry()'s step captured once and replayed
    ENTRY_STEPS times bitwise Simulation.advance(ENTRY_STEPS) of the same
    deck, its graph's nodes by type; path B at 128^2 at its cadence and
    sorting every step bitwise its op-by-op run across a restore; from
    phase 18's captures, each graphed deck's captures and their
    conditional nodes (the bench deck, device-decided, and turbulence
    across its clean at step 50 were held there bitwise to their op-by-op
    steps).  Returns the phase's record."""
    import tempfile
    import torch
    from vpic_tpu_torch.decks import bench_deck
    from vpic_tpu_torch.engine import cond
    from vpic_tpu_torch.entry import DECK
    rec = dict(torch=torch.__version__, cuda=torch.version.cuda,
               route=cond.ROUTE,
               torch_binds_if_nodes=hasattr(
                   torch._C._CUDAGraph, "begin_capture_to_if_node"))
    log(f"  torch {rec['torch']}, CUDA {rec['cuda']}: conditional nodes by "
        f"the route {rec['route']!r} (csrc/cond_node.cu); PyTorch binds "
        f"begin_capture_to_if_node: {rec['torch_binds_if_nodes']}")

    t0 = time.perf_counter()
    _reset_launch_counts()
    state, counts, nodes = entry_replayed(device, ENTRY_STEPS)
    rec["entry_launches"] = {k: v for k, v in _launch_counts().items() if v}
    sim = bench_deck.build(**DECK, device=device)
    ref = sim.advance(ENTRY_STEPS)
    if not states_equal(state, ref):
        raise AssertionError("entry(): the replayed step differs from "
                             f"Simulation.advance({ENTRY_STEPS})")
    want = {"captures": 1, "replays.step": ENTRY_STEPS,
            "graphed_steps": ENTRY_STEPS}
    if counts != want or not nodes.get("conditional"):
        raise AssertionError(f"entry(): dispatch {counts} (want {want}), "
                             f"nodes {nodes}")
    rec.update(entry_nodes=nodes, entry_s=time.perf_counter() - t0)
    log(f"  entry() ({card}): fn captured once and replayed {ENTRY_STEPS} "
        f"times = Simulation.advance({ENTRY_STEPS}) bitwise (every tensor "
        f"of the state); its graph's top-level nodes {nodes}; launches in "
        f"the replays {rec['entry_launches']}; {rec['entry_s']:.2f} s")
    if not rec["entry_launches"].get("cond_set_if"):
        raise AssertionError("entry(): no conditional node was reached")
    rec["cond"] = time_cond(device)
    del sim, state, ref

    tmp = tempfile.mkdtemp(prefix="path_b_restore_")
    try:
        rec["path_b_restore_sorts"] = {
            label: path_b_restore(device, label, deck, tmp)
            for label, deck in (("at its cadence", {}),
                                ("sorting every step",
                                 dict(resort_interval=1, ion_sort_mult=1)))}
    finally:
        import shutil
        shutil.rmtree(tmp, ignore_errors=True)

    rec["captures"] = {}
    for label, r in graph_recs.items():
        caps = r["graphed"]["captures"]
        rec["captures"][label] = [dict(kind=c["kind"], steps=c["steps"],
                                       nodes=c["nodes"],
                                       types=c["node_types"]) for c in caps]
        log(f"  {label}: {len(caps)} capture(s) in phase 18's graphed run: "
            + "; ".join(f"{c['kind']} of {c['steps']} steps, {c['nodes']} "
                        f"nodes, {c['node_types'].get('conditional', 0)} "
                        "conditional" for c in caps))
    turb = rec["captures"]["turbulence"]
    if len(turb) != 1 or not turb[0]["types"].get("conditional"):
        raise AssertionError(f"turbulence: captures {turb}, expected one "
                             "graph whose cleans are conditional nodes")
    for label in ("path B 128^2, 4M", "path B 128^2, 4M, every step"):
        if not all(c["types"].get("conditional")
                   for c in rec["captures"][label]):
            raise AssertionError(f"{label}: a capture without conditional "
                                 f"nodes: {rec['captures'][label]}")
    return rec


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from vpic_tpu_torch.decks import bench_deck
    from vpic_tpu_torch.particles import push_cuda

    device = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    card = card_line()
    log(f"[1/21] device: {kind} (count {count}); torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    log(card)

    t0 = time.perf_counter()
    push_cuda.build()
    log(f"[2/21] build: {time.perf_counter() - t0:.3f} s -> "
        f"{push_cuda.library_path().relative_to(push_cuda.PKG_DIR.parent)}")
    for line in push_cuda.library_path().with_suffix(".log").read_text() \
            .splitlines():
        if any(w in line for w in ("== ", "entry function", "registers",
                                   "spill")):
            log("  ptxas: " + line.strip())

    log("[3/21] kernel vs plain, small 3D grid")
    small_err = phase_kernel_small(device)
    t0 = time.perf_counter()
    sim = bench_deck.build(**SLICE, device=device)
    torch.cuda.synchronize()
    log(f"[3/21] kernel vs plain, 128^2 deck (built in "
        f"{time.perf_counter() - t0:.2f} s)")
    push_err, push_t = phase_kernel_slice(sim)
    log("[4/21] determinism: checked above, per case and species")

    log("[5/21] slice")
    phase_small_deck(device)
    main_launches, rate, step_s = phase_slice(sim)
    phase_trace(sim, step_s)
    log(f"pushes/s: {rate:.6e} ({card}; 128^2, {SLICE['npart']} particles "
        f"per species, median of {WINDOWS} windows of {STEPS} steps, step "
        f"{step_s * 1e3:.4f} ms)")

    log("[6/21] deposit kernel vs plain")
    dep_err, dep_t = phase_deposit(sim, device)
    log("[7/21] merge re-sort kernels vs plain")
    mark_t, tables_t, asm_t = phase_merge(sim.grid, device)
    del sim
    e_refs = reference_energies(device)
    log("[8/21] path A: the unfused push")
    dep_launches, step_a = phase_path_a(device, e_refs)
    log("[9/21] path B: the packed cycle with the merge re-sort")
    mrg_launches, mrg_small, mrg_cadence, step_b, step_b1, trace_b1 = \
        phase_path_b(device, e_refs)
    log(f"step times at 128^2 ({card}; medians of {WINDOWS} windows of "
        f"{STEPS} steps): default path {step_s * 1e3:.4f} ms, path A "
        f"{step_a * 1e3:.4f} ms, path B {step_b * 1e3:.4f} ms, path B "
        f"sorting every step {step_b1 * 1e3:.4f} ms; merge launches "
        f"{mrg_launches} in the every-step windows, {mrg_cadence} at the "
        f"deck's own cadence, {mrg_small} on the 16^2 deck")

    log("[10/21] determinism: the charge deposit on the card")
    phase_determinism(device)
    log("[11/21] the turbulence deck through the CLI")
    turb = phase_turbulence(device, card)
    log("[12/21] the reconnection decks: trecon, sigma, turbulence_fan")
    recon = phase_recon(device, card)
    log("[13/21] open particle boundaries and the collisions deck")
    opened = phase_open(device, card)
    log("[14/21] materials: the material box")
    materials = phase_materials(device, card)
    log("[15/21] several shards on the card: the bench deck on 4 shards, "
        "the turbulence deck on 2")
    shard_push, shard_walk, shard_dep = phase_shards(device, card)
    log("[16/21] the tools path: the probe kernels of tools/ and the drift "
        "comparison against the float64 reference")
    tool_kernels, _ = phase_tools(device, card)
    log("[17/21] the harness tools at full size: evidence, the scaling sweep "
        "(3D 64^3 and 16M particles included), the per-op profile")
    harness = phase_harness(device, card)
    log("[18/21] the step as CUDA graphs: graphed against eager, bitwise, "
        "timed")
    graph_recs = phase_graphs(device, card)
    log("[19/21] the open decks as CUDA graphs: the threefry kernel against "
        "its twin, the open variants and the collisions deck graphed "
        "against eager, bitwise, timed")
    rnd_errs, rnd_t, open_graph_recs, rnd_launches = phase_open_graphs(
        device, card)
    opened.update(open_fields(open_graph_recs))
    log("[20/21] the sharded decks as CUDA graphs: the bench deck on 4 "
        "shards and turbulence on 2 (its cleans decided on the card) "
        "graphed against op by op, bitwise, timed; dryrun_multichip(4)")
    shard_graph_recs = phase_shard_graphs(device, card)
    log("[21/21] the step decides on the card: conditional graph nodes, "
        "entry()'s graph, path B across a restore")
    on_card = phase_on_card(device, card, graph_recs)

    steps = WINDOWS * STEPS
    srt = trace_b1["parts"]["step.sort"]
    merge_source = "vpic_tpu_torch/csrc/merge_assemble.cu"
    kernels = [
        dict(name="push_walk", source="vpic_tpu_torch/csrc/push_walk.cu",
             replaces="vpic_tpu/particles/push_pallas.py:465",
             launches=main_launches["push_walk"],
             max_abs_err=max(small_err, push_err), **push_t, **turb,
             **recon, **opened, **materials, **shard_push, **shard_walk,
             **harness, graphs=graph_recs, open_graphs=open_graph_recs,
             shard_graphs=shard_graph_recs, step_on_card=on_card),
        dict(name="deposit_sorted",
             source="vpic_tpu_torch/csrc/deposit_sorted.cu",
             replaces="vpic_tpu/particles/deposit_pallas.py:41",
             launches=dep_launches, max_abs_err=dep_err, **dep_t,
             **shard_dep),
        dict(name="merge_mark", source=merge_source,
             replaces="vpic_tpu/particles/sort_pallas.py:85",
             launches=mrg_launches["merge_mark"], **mark_t,
             launches_own_cadence_128sq=mrg_cadence["merge_mark"],
             launches_16sq_deck=mrg_small["merge_mark"]),
        dict(name="merge_tables", source=merge_source,
             replaces="vpic_tpu/particles/sort_pallas.py:85",
             launches=mrg_launches["merge_tables"], **tables_t,
             launches_own_cadence_128sq=mrg_cadence["merge_tables"],
             launches_16sq_deck=mrg_small["merge_tables"]),
        dict(name="merge_assemble", source=merge_source,
             replaces="vpic_tpu/particles/sort_pallas.py:85",
             launches=mrg_launches["merge_assemble"], **asm_t,
             launches_own_cadence_128sq=mrg_cadence["merge_assemble"],
             launches_16sq_deck=mrg_small["merge_assemble"],
             path_b_every_step_sort_busy_ms=srt["busy_ms"],
             path_b_every_step_sort_ops=srt["ops"])]
    for k in kernels:
        k["route"] = "cuda"
        k["launches_per_step"] = main_launches[k["name"]] / steps
    # the conditional nodes' set kernel (csrc/cond_node.cu): its launches
    # in entry()'s replays (phase 21)
    kernels.append(dict(
        name="cond_set_if", route="cuda", source="vpic_tpu_torch/csrc/"
        "cond_node.cu", replaces=COND_REPLACES,
        launches=on_card["entry_launches"]["cond_set_if"],
        launches_per_step=on_card["entry_launches"]["cond_set_if"]
        / ENTRY_STEPS, kernel_ms=None, **on_card["cond"]))
    # the threefry kernel's main path is phase 19's graphed runs: its
    # launches there, summed over the decks, and per deck
    for what in ("split", "uniform", "normal"):
        name = "threefry_" + what
        per_deck = {d: c.get(name, 0) for d, c in rnd_launches.items()}
        if not sum(per_deck.values()):
            raise AssertionError(f"{name}: no launch in phase 19's graphed "
                                 "runs")
        kernels.append(dict(
            name=name, route="cuda", source=THREEFRY_SOURCE,
            replaces=THREEFRY_REPLACES, launches=sum(per_deck.values()),
            launches_by_deck=per_deck, max_abs_err=rnd_errs[what],
            **rnd_t[what]))
    log(f"chip_smoke: 21 phases in {time.perf_counter() - _T0:.1f} s")
    print(json.dumps({"kernels": kernels + tool_kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
