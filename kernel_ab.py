#!/usr/bin/env python3
"""Trees of this repository against each other on one NVIDIA GPU: the
push+walk, deposit and merge re-sort kernels at the bench shape, the
default path's device time and path B's sort, each tree in its own
process, in the order given.

    python3 kernel_ab.py _archive/parent . . _archive/parent

Each argument is the root of a checkout (for example a ``git archive`` of
the parent commit unpacked under ``_archive/``, which .gitignore lists).
For each, a child process puts that root first on ``sys.path``, builds its
kernels into its own ``vpic_tpu_torch/_build``, builds the 128^2, 2 x 2M
bench deck on the card and, on the voxel-sorted electrons:

- checks the kernel's push against that tree's plain version (voxels,
  pcode and particle floats bitwise, the accumulator within
  1e-6 * sum|contributions| per voxel), and times the wrapper
  ``push_cuda.advance_p`` with CUDA events (``ms``) and the
  ``push_walk_kernel`` alone under torch.profiler (``kernel_ms``), with the
  device operations per call;
- does the same for the deposit kernel on the segment-1 currents
  (``deposit_cuda.deposit_sorted_into``; its kernels alone are those named
  ``deposit_*``), beside one ``index_add_`` of the valid lanes' (n, 12)
  contributions prepared beforehand;
- on chip_smoke's bench merge block (2 125 824 lanes, 5 % movers), checks
  the whole merge re-sort (``sort_cuda.merge_sort_packed``) against that
  tree's plain one (bitwise) and times it (CUDA events) against a full
  ``aux.sort_p_packed``, with its merge kernels alone, its device ops and
  its host reads per call from a profiler trace;

then advances the deck 8 steps and traces 8 more under torch.profiler
(``chip_smoke.phase_trace``): the default path's busy device ms and device
operations per step; then builds the path-B deck that sorts every species
every step (``merge_sort=True``, ``resort_interval=1``,
``ion_sort_mult=1``), advances it 8 steps and traces 8 more: its
``step.sort`` busy device ms and device operations per step; then times
path B's step through ``advance`` (graphed on the card), sorting every
step and at the deck's own cadence: the median of three windows of 16
steps.  Each
child prints one JSON line; the parent prints them all as a JSON list on
its last line.  Needs one card; exits non-zero without one.

    python3 kernel_ab.py --probes _archive/parent . . _archive/parent

measures instead, per tree, the six probe kernels of the tools: gather3d
and deposit2d (``vpic_tpu_torch/tools/probe_batched.py``) on the tool's
inputs beside ``torch.einsum`` on the prepared bf16 operands; the chain
(``tools/vpu_layout_probe.py``, 1024 reps, drawn uniform on [0, 3)) on
the dense (8, 16384) block and on rows 1 of its (8, 131072) block; io4d,
stack8 and onehot3d on the tool's inputs, stack8 beside one index
``win_bf16[:, loc]`` of the prepared bf16 window (CUDA events, and alone:
the sum of its device events per call under the profiler).  Each kernel
is checked bitwise against that tree's plain version, then timed alone
(torch.profiler) and through its wrapper (CUDA events).  For the chain it also reads the SASS of the tree's built
library (``cuobjdump -sass``, beside the toolkit's nvcc): the issued
instructions per element and rep of the kernel's main loop (the
instructions from the target of its backward branch to the branch, over
the FMULs among them, one per element and rep); the issue ceiling of the
dense block at 128 lane-instructions per SM and clock (3.35e13 per
second at 1.98 GHz); and the SM clock (``nvidia-smi``) read half-way
through a second of back-to-back chain calls.
"""

import json
import os
import re
import subprocess
import sys
import time

REPS = 20
# issued lane-instructions per second: 132 SMs x 128 lanes x 1.98 GHz
ISSUE_LANES_PER_S = 132 * 128 * 1.98e9


cs = None   # the chip_smoke module of the tree measured (_load)


def _load(tree=None):
    """Import chip_smoke as ``cs``: with ``tree``, put it first on
    sys.path before anything of the package is imported (chip_smoke
    imports vpic_tpu_torch), so that both are that tree's."""
    global cs
    if tree is not None:
        sys.path.insert(0, os.path.abspath(tree))
    import chip_smoke
    import vpic_tpu_torch
    pkg = os.path.dirname(os.path.abspath(vpic_tpu_torch.__file__))
    if tree is not None and pkg != os.path.join(os.path.abspath(tree),
                                                "vpic_tpu_torch"):
        raise RuntimeError(f"imported {pkg}, not the tree {tree}")
    cs = chip_smoke


def _import_tree(tree):
    """The tree's chip_smoke and vpic_tpu_torch (a child process)."""
    _load(tree)


def measure(tree):
    """The JSON record of one tree (run in a child process)."""
    _import_tree(tree)
    import torch
    from vpic_tpu_torch.decks import bench_deck
    from vpic_tpu_torch.engine.step import walk_segments
    from vpic_tpu_torch.core.types import PackedSpecies
    from vpic_tpu_torch.particles import (aux, deposit_cuda, push, push_cuda,
                                          sort, sort_cuda)
    device = torch.device("cuda", 0)
    push_cuda.build()
    sim = bench_deck.build(**cs.SLICE, device=device)
    st, g = sim.state, sim.grid
    nb, interp = st.grid_arrays.neighbor, st.interpolator
    n_walk = walk_segments(g, sim.opts)
    sp = aux.sort_p(st.species[0])
    acc0 = torch.zeros((g.nv, 12), dtype=torch.float32, device=device)
    run = lambda: push_cuda.advance_p(sp, interp, acc0, nb, g, n_walk=n_walk)

    ko, kacc = run()
    po, pacc = push.advance_p(sp, interp, acc0, nb, g, n_walk=n_walk)
    for name in cs.PUSH_FLOATS + ("i", "pc", "nm"):
        if not cs._bitwise_equal(getattr(ko, name), getattr(po, name)):
            raise AssertionError(f"{tree}: {name} differs from the plain push")
    # the segment cap written out: older trees have no push.segment_cap
    absacc = cs.abs_deposit(push.pushed_walk_state(sp, interp, g), nb, g,
                            1 + 4 * (n_walk - 1) + 8)
    err = (kacc.double() - pacc.double()).abs()
    if not bool((err <= 1e-6 * absacc + 1e-30).all()):
        raise AssertionError(f"{tree}: acc beyond 1e-6*sum|c|")

    ms = cs.cuda_ms(run, REPS)
    kernel_ms, ops_per_call = cs.profiled_ms(run, REPS,
                                             ("push_walk_kernel",), 1)
    del ko, kacc, po, pacc, absacc, err

    vox, cols, valid = cs.segment1_currents(sp, interp, nb, g)
    cs.check_deposit("segment 1", acc0, vox, cols, valid, g.nv)
    run_d = lambda: deposit_cuda.deposit_sorted_into(acc0, vox, cols, valid,
                                                     g.nv)
    lib_vox = vox[valid].long()
    lib_c = torch.stack(cols, dim=-1)[valid]
    lib_acc = acc0.clone()
    dep = dict(ms=cs.cuda_ms(run_d, REPS),
               library_ms=cs.cuda_ms(
                   lambda: lib_acc.index_add_(0, lib_vox, lib_c), REPS))
    dep["kernel_ms"], dep["ops_per_call"] = cs.profiled_ms(run_d, REPS,
                                                           ("deposit_",), 3)
    del vox, cols, valid, lib_vox, lib_c, lib_acc

    args = cs.bench_merge_block(g, device)
    pk, npt, key0, ctot = args[:4]
    k, p = (f(*args) for f in (sort_cuda.merge_sort_packed,
                               sort.merge_sort_packed))
    if not (k.fast and p.fast and int(k.anomaly) == 0
            and cs._bitwise_equal(k.pk, p.pk) and torch.equal(k.key0, p.key0)
            and torch.equal(k.ctot, p.ctot)):
        raise AssertionError(f"{tree}: the merge re-sort differs from the "
                             "plain one")
    psp = PackedSpecies(name="bench", sid=0, max_np=pk.shape[1],
                        sort_interval=0, q_m=-1.0, np=npt,
                        nm=torch.zeros_like(npt), pk=pk, key0=key0, ctot=ctot)
    run_m = lambda: sort_cuda.merge_sort_packed(*args)
    merge = dict(ms=cs.cuda_ms(run_m, 10),
                 full_sort_ms=cs.cuda_ms(lambda: aux.sort_p_packed(psp, g),
                                         10))
    # the merge kernels one re-sort launches in this tree
    sort_cuda.reset_launch_counts()
    run_m()
    prof = cs.call_profile(run_m, sum(sort_cuda.launches.values()))
    merge.update(kernel_ms=prof["kernel_ms"], busy_ms=prof["busy_ms"],
                 ops_per_call=prof["ops"], host_reads=prof["reads"],
                 full_sort_busy_ms=cs.call_profile(
                     lambda: aux.sort_p_packed(psp, g))["busy_ms"])
    del k, p, psp, args, pk, key0, ctot

    sim.advance(cs.WARM_STEPS)
    trace = cs.phase_trace(sim, None, tree)
    del sim
    sim = bench_deck.build(**cs.SLICE, resort_interval=1, ion_sort_mult=1,
                           device=device)
    sim.modify_runparams(merge_sort=True)
    sim.advance(cs.WARM_STEPS)
    srt = cs.phase_trace(sim, None, f"{tree} path B sorting every step")[
        "parts"]["step.sort"]
    every = graphed_step_ms(sim)
    del sim
    sim = bench_deck.build(**cs.SLICE, device=device)
    sim.modify_runparams(merge_sort=True)
    sim.advance(cs.WARM_STEPS)
    cadence = graphed_step_ms(sim)
    return dict(tree=tree, card=cs.card_line(), lanes=int(sp.np), ms=ms,
                kernel_ms=kernel_ms, ops_per_call=ops_per_call,
                deposit=dep, merge=merge, step_busy_ms=trace["busy_ms"],
                step_ops=trace["ops"], path_b_sort_busy_ms=srt["busy_ms"],
                path_b_sort_ops=srt["ops"], path_b_step_ms=cadence,
                path_b_every_step_ms=every)


def graphed_step_ms(sim):
    """The median over cs.WINDOWS windows of cs.STEPS steps of
    ``sim.advance_steps`` (the graphed step where the deck runs as CUDA
    graphs), host clock around a synchronized window, in ms a step."""
    import statistics
    import time

    import torch
    out = []
    for _ in range(cs.WINDOWS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sim.advance_steps(cs.STEPS)
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) / cs.STEPS * 1e3)
    return statistics.median(out)


_SASS_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_SASS_LABEL = re.compile(r"^\s*(\.L_x_\d+):")
_SASS_BRA = re.compile(r"\bBRA\b.*?(?:`\((\.L_x_\d+)\)|(0x[0-9a-f]+))")


def sass_loops(so, kernel):
    """The loops of the kernel whose name contains ``kernel`` in the
    library ``so``: per backward branch, (instructions from its target to
    it, NOPs left out; FMULs among them)."""
    from vpic_tpu_torch.particles import push_cuda
    cuobjdump = os.path.join(os.path.dirname(push_cuda._nvcc()), "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", str(so)], capture_output=True,
                          text=True, check=True).stdout
    body = text.split("Function : ")
    found = [b for b in body[1:] if kernel in b.splitlines()[0]]
    if len(found) != 1:
        raise RuntimeError(f"{len(found)} functions named {kernel} in {so}")
    insns, labels, pending = [], {}, []
    for line in found[0].splitlines():
        m = _SASS_LABEL.match(line)
        if m:
            pending.append(m.group(1))
            continue
        m = _SASS_INSN.search(line)
        if m:
            addr = int(m.group(1), 16)
            for name in pending:
                labels[name] = addr
            pending = []
            insns.append((addr, m.group(2)))
    loops = []
    for addr, op in insns:
        m = _SASS_BRA.search(op)
        if not m:
            continue
        target = labels[m.group(1)] if m.group(1) else int(m.group(2), 16)
        if target <= addr:
            ops = [o for a, o in insns if target <= a <= addr
                   and not re.search(r"\bNOP\b", o)]
            loops.append((len(ops), sum(bool(re.search(r"\bFMUL\b", o))
                                        for o in ops)))
    return loops


def sm_clock_mhz(fn, seconds=1.0):
    """The SM clock in MHz, read with nvidia-smi half-way through
    ``seconds`` of back-to-back fn() calls (50 enqueued at a time, so
    the card is busy while it is read)."""
    import torch
    fn()
    torch.cuda.synchronize()
    query, t0 = None, time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        for _ in range(50):
            fn()
        if query is None and time.perf_counter() - t0 > seconds / 2:
            query = subprocess.Popen(
                ["nvidia-smi", "--id=0", "--query-gpu=clocks.sm",
                 "--format=csv,noheader,nounits"], stdout=subprocess.PIPE,
                text=True)
    torch.cuda.synchronize()
    return float(query.communicate(timeout=60)[0].split()[0])


def chain_record(tree, vp, x, rows):
    """The chain on ``x``: bitwise that tree's plain version, alone and
    through its wrapper."""
    run = lambda: vp.chain(x, rows)
    cs.check_bitwise(f"{tree}: vpu chain rows {rows}", run(),
                     vp.chain_plain(x, rows), "the plain version")
    return dict(kernel="vpu_chain_kernel", shape=list(x.shape), rows=rows,
                kernel_ms=cs.profiled_ms(run, REPS, ("vpu_chain_kernel",),
                                         1)[0],
                ms=cs.cuda_ms(run, REPS))


def measure_probes(tree):
    """The record of one tree's six probe kernels (run in a child
    process)."""
    _import_tree(tree)
    import torch
    from vpic_tpu_torch.particles import push_cuda
    from vpic_tpu_torch.tools import probe_batched as pb
    from vpic_tpu_torch.tools import vpu_layout_probe as vp
    device = torch.device("cuda", 0)
    rec = dict(tree=tree, card=cs.card_line())
    for name, eq in (("gather3d", "aw,rwl->arl"),
                     ("deposit2d", "krl,rwl->kw")):
        args = pb.tool_inputs(name, device)
        run = lambda: pb.PROBES[name](*args)
        cs.check_bitwise(f"{tree}: {name}", run(), pb.PLAIN[name](*args),
                         "the plain version")
        a, oh = (t.to(torch.bfloat16) for t in args)
        kernel_ms, _ = cs.profiled_ms(run, REPS, (pb.KERNEL_NAMES[name],), 1)
        rec[name] = dict(
            kernel=pb.KERNEL_NAMES[name], kernel_ms=kernel_ms,
            ms=cs.cuda_ms(run, REPS),
            einsum_ms=cs.cuda_ms(lambda: torch.einsum(eq, a, oh), REPS))
    gen = torch.Generator(device=device).manual_seed(16)
    xs = {rows: 3 * torch.rand(vp.block_shape(rows), device=device,
                               generator=gen) for rows in (8, 1)}
    for key, rows in (("vpu_chain", 8), ("vpu_chain_rows1", 1)):
        rec[key] = chain_record(tree, vp, xs[rows], rows)
    loops = sass_loops(push_cuda.library_path(), "vpu_chain_kernel")
    insns, reps_per_turn = max(loops, key=lambda lp: lp[1])
    per_rep = insns / reps_per_turn
    window = rec["vpu_chain"]["shape"][0] * rec["vpu_chain"]["shape"][1]
    rec["vpu_chain"].update(
        sass_loops=loops, sass_per_rep=per_rep,
        issue_ceiling_ms=per_rep * vp.REPS * window / ISSUE_LANES_PER_S * 1e3,
        sm_clock_mhz=sm_clock_mhz(lambda: vp.chain(xs[8], 8)))
    for name in ("io4d", "stack8", "onehot3d"):
        args = pb.tool_inputs(name, device)
        run = lambda: pb.PROBES[name](*args)
        cs.check_bitwise(f"{tree}: {name}", run(), pb.PLAIN[name](*args),
                         "the plain version")
        kernel = pb.KERNEL_NAMES[name]
        rec[name] = dict(kernel=kernel,
                         kernel_ms=cs.profiled_ms(run, REPS, (kernel,), 1)[0],
                         ms=cs.cuda_ms(run, REPS))
    win, loc = pb.tool_inputs("stack8", device)
    index = lambda w=win.to(torch.bfloat16), i=loc.long(): w[:, i]
    rec["stack8"].update(index_ms=cs.cuda_ms(index, REPS),
                         index_alone_ms=cs.call_profile(
                             index, reps=REPS)["device_ms"])
    return rec


def log_probes(tree, rec):
    parts = []
    for name, r in rec.items():
        if not isinstance(r, dict):
            continue
        line = (f"{name} ({r['kernel']}) alone {r['kernel_ms']:.4f} ms, "
                f"wrapper {r['ms']:.4f} ms")
        if "einsum_ms" in r:
            line += f", torch.einsum {r['einsum_ms']:.4f} ms"
        if "index_ms" in r:
            line += (f", win_bf16[:, loc] {r['index_ms']:.4f} ms (alone "
                     f"{r['index_alone_ms']:.4f} ms)")
        if "sass_per_rep" in r:
            line += (f", {r['sass_per_rep']:.4f} SASS instructions per "
                     f"element and rep (loops {r['sass_loops']}), issue "
                     f"ceiling {r['issue_ceiling_ms']:.4f} ms, SM clock "
                     f"{r['sm_clock_mhz']:.0f} MHz")
        parts.append(line)
    cs.log(f"{tree}: " + "; ".join(parts) + f" ({rec['card']})")


def main(argv):
    if len(argv) == 2 and argv[0] in ("--one", "--one-probes"):
        fn = measure if argv[0] == "--one" else measure_probes
        print(json.dumps(fn(argv[1])), flush=True)
        return 0
    import torch
    _load()
    probes = bool(argv) and argv[0] == "--probes"
    trees = argv[1:] if probes else argv
    if not trees or not torch.cuda.is_available():
        print("kernel_ab: needs tree roots and a CUDA device", file=sys.stderr)
        return 2
    here = os.path.abspath(__file__)
    out = []
    for tree in trees:
        r = subprocess.run([sys.executable, here,
                            "--one-probes" if probes else "--one", tree],
                           capture_output=True, text=True, timeout=900)
        if r.returncode != 0:
            print(r.stdout + r.stderr, file=sys.stderr)
            raise RuntimeError(f"kernel_ab: {tree} failed ({r.returncode})")
        rec = json.loads(r.stdout.strip().splitlines()[-1])
        out.append(rec)
        if probes:
            log_probes(tree, rec)
            continue
        d, m = rec["deposit"], rec["merge"]
        cs.log(f"{tree}: push wrapper {rec['ms']:.4f} ms, kernel alone "
               f"{rec['kernel_ms']:.4f} ms, {rec['ops_per_call']:.1f} device "
               f"ops per call; deposit wrapper {d['ms']:.4f} ms, kernels "
               f"alone {d['kernel_ms']:.4f} ms, {d['ops_per_call']:.1f} ops "
               f"per call, index_add_ {d['library_ms']:.4f} ms; merge "
               f"re-sort {m['ms']:.4f} ms (device busy {m['busy_ms']:.4f} "
               f"ms, kernels alone {m['kernel_ms']:.4f} ms, "
               f"{m['ops_per_call']:.1f} ops and {m['host_reads']:.1f} host "
               f"reads per call), full sort {m['full_sort_ms']:.4f} ms "
               f"(device busy {m['full_sort_busy_ms']:.4f} ms); default "
               f"path busy "
               f"{rec['step_busy_ms']:.4f} ms/step, {rec['step_ops']:.1f} "
               f"ops/step; path B sorting every step: step.sort busy "
               f"{rec['path_b_sort_busy_ms']:.4f} ms/step, "
               f"{rec['path_b_sort_ops']:.1f} ops/step; path B's step "
               f"through advance {rec['path_b_step_ms']:.4f} ms at its "
               f"cadence, {rec['path_b_every_step_ms']:.4f} sorting every "
               f"step ({rec['card']})")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
