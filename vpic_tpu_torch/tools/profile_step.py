"""Profile the bench deck's step and print where its time goes, the port's
counterpart of ``tools/profile_step.py``: the plain ms/step and pushes/s,
then a ``torch.profiler`` trace of ``steps`` steps and three tables: busy
time per step part, the 50 busiest ops, and the long tail by op family.

    python -m vpic_tpu_torch.tools.profile_step [npart] [nx] [steps]
        [--device cpu]

Env: ``PROF_NZ`` and ``PROF_NY`` (default 1 and nx), ``PROF_DIR`` (where
the Chrome trace ``step_trace.json`` goes; default ``vpic_prof`` in the
temporary directory) and ``PROF_TAIL`` (set: also list the 40 busiest
tail ops one by one).

The plain ms/step is ``Simulation.advance``'s: the deck's CUDA graphs on
the card.  The trace steps op by op (``Simulation.advance_eager``) on
purpose, since a graph's replay has no step-part scopes, and says so.
On the card the trace holds CPU and CUDA activity and the tables count
device ops: kernels, copies and sets.  A step part is a scope of
``engine/step.PHASES`` (``step.sort``, ``step.push``, ``step.field``,
...).  The profiler does not link the kernels this package launches
through ctypes to a scope, so an op goes to the scope whose host interval
holds its launch call, the runtime event with the op's correlation id
(:func:`_step_parts`).  Busy time is the union of the ops' intervals
(:func:`_busy_us`).  The profiler can drop device events of a trace, so
:func:`profiled` pads each trace with small kernels at both ends and
traces again where events are missing.  With ``--device cpu`` the trace
holds CPU ops only, the outermost ``aten::`` op of each call, each in the
scope that holds it, and no ``torch.cuda`` call is made.
"""

from __future__ import annotations

import argparse
import collections
import os
import re
import tempfile
import time

import torch

from ..decks import bench_deck
from ..engine.step import PHASES
from .drift_compare import _sync, sort_period
from .evidence import live_count
from .probes_cuda import card_line, resolve_device

PROFILE_ATTEMPTS = 5
# small kernels launched at the start and at the end of every trace:
# where the profiler loses a trace's first or last device records (seen
# after long traces: the first five of each later trace; after a run of
# long traces, the first 25), it is these that it loses, not fn's
PAD_SCOPE, PAD_OPS = "profiler_pad", 128
# the runtime calls whose device work a trace keeps; a graph's replay is
# one cudaGraphLaunch with the device events of all its nodes
_RUNTIME = ("LaunchKernel", "Memcpy", "Memset", "GraphLaunch")
TOP_OPS, TAIL_FAMILIES, TAIL_OPS = 50, 25, 40


def _pad():
    from torch.profiler import record_function
    with record_function(PAD_SCOPE):
        pad = torch.zeros(1, device="cuda")
        for _ in range(PAD_OPS):
            pad.add_(1.0)
        torch.cuda.synchronize()


def profiled(fn, ok, trace_path=None):
    """Run fn() under torch.profiler, again while ``ok(device events,
    runtime calls without a device event)`` is false: the profiler can
    drop device events, and a kernel missing from a trace would read as
    time not spent.  The device events are those of fn's runtime calls;
    records of other traces and of this trace's padding are left out.
    ``trace_path``: where the accepted trace goes as a Chrome trace.
    Returns (host-clock us of fn, all events, device events, runtime calls
    without a device event)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(PROFILE_ATTEMPTS):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            _pad()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
            _pad()
        events = prof.events()
        pads = [(e.time_range.start, e.time_range.end) for e in events
                if e.device_type == DeviceType.CPU and e.name == PAD_SCOPE]
        calls = {e.id: e for e in events if e.device_type == DeviceType.CPU
                 and any(k in e.name for k in _RUNTIME)
                 and not any(a <= e.time_range.start <= b for a, b in pads)}
        dev = [e for e in events if e.device_type == DeviceType.CUDA
               and not e.is_user_annotation and e.id in calls]
        ids = {e.id for e in dev}
        order = sorted(calls, key=lambda i: calls[i].time_range.start)
        lost = [calls[i].name for i in order if i not in ids]
        if dev and ok(dev, lost):
            if trace_path is not None:
                prof.export_chrome_trace(trace_path)
            return wall_us, events, dev, len(lost)
        where = [k for k, i in enumerate(order) if i not in ids]
        print(f"  (the trace lacks the device events of {len(lost)} of "
              f"{len(order)} runtime calls, {sorted(set(lost))}, at "
              f"positions {where[:8]}; traced again)", flush=True)
    raise AssertionError(f"the profiler dropped device events in "
                         f"{PROFILE_ATTEMPTS} traces in a row")


def _busy_us(intervals):
    """Length of the union of (start, end) intervals."""
    busy, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy


def _scopes(events):
    from torch.autograd import DeviceType
    return [(e.time_range.start, e.time_range.end, e.name)
            for e in events if e.device_type == DeviceType.CPU
            and e.name in PHASES]


def _scope_at(scopes, t):
    return next((n for s, f, n in scopes if s <= t <= f), None)


def _step_parts(events, dev):
    """The step part (a name of PHASES, or None) of each device op in
    ``dev``: the scope whose host interval holds the op's launch call,
    the runtime event with the op's correlation id.  (The kernels this
    package launches through ctypes are not linked to a scope by the
    profiler's own tree, but their launch calls are in the trace.)  Also
    returns how many ops had a launch call in the trace."""
    from torch.autograd import DeviceType
    scopes = _scopes(events)
    launch = {e.id: e.time_range.start for e in events
              if e.device_type == DeviceType.CPU
              and e.name.startswith(("cuda", "cuLaunch"))}
    parts = [_scope_at(scopes, launch[e.id]) if e.id in launch else None
             for e in dev]
    return parts, sum(e.id in launch for e in dev)


def _cpu_ops(events):
    """The outermost ``aten::`` op of each call in a CPU-only trace, and
    the step part of each (the scope that holds it)."""
    def outermost(e):
        p = e.cpu_parent
        while p is not None:
            if p.name.startswith("aten::"):
                return False
            p = p.cpu_parent
        return True

    ops = [e for e in events if e.name.startswith("aten::") and outermost(e)]
    scopes = _scopes(events)
    return ops, [_scope_at(scopes, e.time_range.start) for e in ops]


def family(name: str) -> str:
    """An op's family: its name without template arguments, call
    arguments and a numbered suffix."""
    name = re.sub(r"^void ", "", name)
    name = re.split(r"[<(]", name, maxsplit=1)[0].strip()
    return re.sub(r"[.\d_]+$", "", name) or name


def breakdown(ops, parts, steps):
    """Per step: busy ms (the union of the ops' intervals), ops, the busy
    ms and the ops of each step part (``parts``, ``part_ops``; the key
    None for ops outside the parts), and per op name its total ms, count
    and the step part where most of its time falls."""
    span = lambda e: (e.time_range.start, e.time_range.end)
    per = lambda us: us / steps / 1e3
    busy = _busy_us([span(e) for e in ops])
    part_busy = {k: per(_busy_us([span(e) for e, p in zip(ops, parts)
                                  if p == k])) for k in (*PHASES, None)}
    ms, count = collections.Counter(), collections.Counter()
    where = collections.defaultdict(collections.Counter)
    for e, p in zip(ops, parts):
        us = e.time_range.elapsed_us()
        ms[e.name] += us / 1e3
        count[e.name] += 1
        where[e.name][p] += us
    part_ops = collections.Counter(parts)
    return dict(busy_ms=per(busy), ops=len(ops) / steps, parts=part_busy,
                part_ops={k: part_ops[k] / steps for k in (*PHASES, None)},
                op_ms=dict(ms), op_count=dict(count),
                op_part={n: c.most_common(1)[0][0] for n, c in where.items()})


def print_tables(b, steps, what, tail):
    total = sum(b["parts"].values()) or 1.0
    print(f"\n== busy {what} ms per step part (union of the parts' ops) ==")
    print(f"{'part':>14} {'ms/step':>9} {'%':>6}")
    for p, v in sorted(b["parts"].items(), key=lambda kv: -kv[1]):
        if v or p in PHASES[:3]:
            print(f"{p or 'outside':>14} {v:9.4f} {100 * v / total:6.1f}")

    rows = sorted(b["op_ms"].items(), key=lambda kv: -kv[1])[:TOP_OPS]
    print(f"\n== the {TOP_OPS} busiest {what} ops ==")
    print(f"{'ms_total':>9} {'ms/step':>8} {'n':>6}  {'part':<12}  name")
    for name, ms in rows:
        print(f"{ms:9.3f} {ms / steps:8.4f} {b['op_count'][name]:6d}  "
              f"{b['op_part'][name] or '-':<12}  {name[:100]}")

    listed = {n for n, _ in rows}
    fam_ms, fam_n = collections.Counter(), collections.Counter()
    for name, ms in b["op_ms"].items():
        if name not in listed:
            fam_ms[family(name)] += ms
            fam_n[family(name)] += b["op_count"][name]
    print(f"\n== long tail by op family ({what} ops not listed above) ==")
    print(f"{'ms_total':>9} {'ms/step':>8} {'n':>6}  family")
    for fam, ms in fam_ms.most_common(TAIL_FAMILIES):
        print(f"{ms:9.3f} {ms / steps:8.4f} {fam_n[fam]:6d}  {fam[:100]}")
    if tail:
        print("\n== top tail ops (individually) ==")
        tail_ops = [(n, m) for n, m in b["op_ms"].items() if n not in listed]
        for name, ms in sorted(tail_ops, key=lambda kv: -kv[1])[:TAIL_OPS]:
            print(f"{ms:9.3f} {ms / steps:8.4f} {b['op_count'][name]:6d}  "
                  f"{name[:140]}")
    print(f"sum over the ops: {sum(b['op_ms'].values()):.3f} ms "
          f"({sum(b['op_ms'].values()) / steps:.4f} ms/step); busy "
          f"{b['busy_ms']:.4f} ms/step, {b['ops']:.1f} ops/step", flush=True)


def main(argv=None) -> dict:
    """Profile the deck; returns the breakdown (``breakdown``'s keys, per
    step) with ``device``, ``steps``, ``ms_per_step``, ``pushes_per_s``,
    ``wall_ms`` (per step under the profiler), ``top`` (the listed op
    names) and ``trace`` (the Chrome trace's path)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("npart", nargs="?", type=int, default=2_000_000,
                    help="particles in all, half per species")
    ap.add_argument("nx", nargs="?", type=int, default=128)
    ap.add_argument("steps", nargs="?", type=int, default=5)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    on_card = device.type == "cuda"
    nx, steps = args.nx, args.steps
    nz = int(os.environ.get("PROF_NZ", 1))
    ny = int(os.environ.get("PROF_NY", nx))
    prof_dir = os.environ.get("PROF_DIR",
                              os.path.join(tempfile.gettempdir(),
                                           "vpic_prof"))
    os.makedirs(prof_dir, exist_ok=True)
    trace_path = os.path.join(prof_dir, "step_trace.json")

    what = "device" if on_card else "CPU"
    print(f"== profile_step: bench deck {nx}x{ny}x{nz}, {args.npart} "
          f"particles, {steps} steps on "
          + (card_line(device) + " (CPU and CUDA activity)" if on_card
             else "the CPU (CPU ops only; no device trace)") + " ==",
          flush=True)
    sim = bench_deck.build(nx=nx, ny=ny, nz=nz, npart=args.npart // 2,
                           device=device)
    # warm-up: one sort period, then the window's units from a sort period
    # boundary (their graphs captured where the deck runs graphed), back
    # to a boundary; the timed window replays those units
    period = sort_period(sim)
    sim.advance_steps(period)
    sim.advance_steps(steps)
    sim.advance_steps(-sim.step_count % period)
    _sync(device)
    t0 = time.perf_counter()
    sim.advance_steps(steps)
    _sync(device)
    dt = time.perf_counter() - t0
    total = live_count(sim)
    path = "graphed" if sim.graphed else "op by op"
    print(f"== plain ({path}): {dt / steps * 1e3:.4f} ms/step, "
          f"{total * steps / dt / 1e6:.4f} M pushes/s ==", flush=True)

    # the trace steps op by op (advance_eager) on purpose: the step's
    # part scopes do not exist inside a graph's replay
    print("== traced op by op (advance_eager), for the step parts ==",
          flush=True)
    if on_card:
        wall_us, events, ops, lost = profiled(
            lambda: sim.advance_eager(steps),
            lambda dev, lost: len(lost) <= steps, trace_path)
        parts, _ = _step_parts(events, ops)
    else:
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            t0 = time.perf_counter()
            sim.advance_eager(steps)
            wall_us = (time.perf_counter() - t0) * 1e6
        prof.export_chrome_trace(trace_path)
        ops, parts = _cpu_ops(prof.events())
    b = breakdown(ops, parts, steps)
    outside = 1 - b["busy_ms"] * steps * 1e3 / wall_us
    print(f"== traced: wall {wall_us / steps / 1e3:.4f} ms/step, {what} "
          f"busy {b['busy_ms']:.4f} ms/step, "
          + (f"idle share {outside:.4f}, {lost} runtime calls without a "
             "device event" if on_card else
             f"share of the wall outside the ops {outside:.4f}")
          + f"; trace {trace_path} ==", flush=True)
    print_tables(b, steps, what, bool(os.environ.get("PROF_TAIL")))
    top = [n for n, _ in sorted(b["op_ms"].items(),
                                key=lambda kv: -kv[1])[:TOP_OPS]]
    return dict(b, device=str(device), steps=steps, graphed=sim.graphed,
                ms_per_step=dt / steps * 1e3,
                pushes_per_s=total * steps / dt,
                wall_ms=wall_us / steps / 1e3, top=top, trace=trace_path)


if __name__ == "__main__":
    main()
