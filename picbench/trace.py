"""The traced run's record, from ``torch.profiler`` traces of the program:
a graphed window (kernels by name, device busy time, idle gaps) and an op
by op window (busy device time per step part, by the program's
``record_function`` scopes).  The attribution of a device op to a scope
by its launch call's correlation id is a copy of
``vpic_tpu_torch/tools/profile_step.py``'s ``_busy_us`` and
``_step_parts``; the padding and retry of its ``profiled``, which guard
against device events that the profiler drops, are copied too.

The per-layer readers (``picbench/metrics``) read the record that the
harness builds from these (``picbench/run.py``, ``Cell.traced``);
nothing here knows a metric."""

from __future__ import annotations

import collections
import re
import time

import torch

# the program's step-part scopes (vpic_tpu_torch/engine/step.PHASES)
PARTS = ("step.sort", "step.push", "step.field", "step.collide",
         "step.emit", "step.boundary")
RUNTIME = ("LaunchKernel", "Memcpy", "Memset", "GraphLaunch")
PAD_SCOPE, PAD_OPS, ATTEMPTS = "picbench.pad", 128, 5
# the harness's own host scopes, which name the idle gaps
SCOPES = ("picbench.replay", "picbench.sync", "picbench.eager")
TOP = 10


def _pad():
    from torch.profiler import record_function
    with record_function(PAD_SCOPE):
        pad = torch.zeros(1, device="cuda")
        for _ in range(PAD_OPS):
            pad.add_(1.0)
        torch.cuda.synchronize()


def profiled(fn, prepare=None):
    """fn() under the profiler, again while the trace lacks the device
    events of a launch: a kernel missing from a trace would read as time
    not spent.  ``prepare()`` runs untraced before each attempt.
    Returns (wall seconds of fn, all events, fn's device events, launches
    without a device event in the trace kept)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(ATTEMPTS):
        if prepare is not None:
            prepare()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            _pad()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            _pad()
        events = prof.events()
        pads = [(e.time_range.start, e.time_range.end) for e in events
                if e.device_type == DeviceType.CPU and e.name == PAD_SCOPE]
        calls = {e.id for e in events if e.device_type == DeviceType.CPU
                 and any(k in e.name for k in RUNTIME)
                 and not any(a <= e.time_range.start <= b for a, b in pads)}
        dev = [e for e in events if e.device_type == DeviceType.CUDA
               and not e.is_user_annotation and e.id in calls]
        lost = len(calls - {e.id for e in dev})
        if dev and not lost:
            break
    return wall, events, dev, lost


def busy_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    busy, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy


def _cpu_spans(events, names):
    from torch.autograd import DeviceType
    return [(e.time_range.start, e.time_range.end, e.name) for e in events
            if e.device_type == DeviceType.CPU and e.name in names]


def step_parts(events, dev):
    """The step part of each device op: the scope whose host interval
    holds the op's launch call (the runtime event with its correlation
    id), or None."""
    from torch.autograd import DeviceType
    scopes = _cpu_spans(events, PARTS)
    launch = {e.id: e.time_range.start for e in events
              if e.device_type == DeviceType.CPU
              and e.name.startswith(("cuda", "cuLaunch"))}
    return [next((n for s, f, n in scopes if s <= launch[e.id] <= f), None)
            if e.id in launch else None for e in dev]


def graphed_record(events, dev, wall_s: float, steps: int) -> dict:
    """Kernels (name, start, end in us), busy and window seconds, and the
    idle gaps between device ops named by the harness scope that the host
    was in at the gap's middle."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in dev)
    gaps = collections.Counter()
    scopes = _cpu_spans(events, SCOPES + tuple(
        e.name for e in events if any(k in e.name for k in RUNTIME)))
    end = spans[0][1] if spans else 0.0
    for s, e in spans[1:]:
        if s > end:
            mid = 0.5 * (s + end)
            inner = [(f - b, n) for b, f, n in scopes if b <= mid <= f]
            gaps[min(inner)[1] if inner else "host"] += (s - end) / 1e6
        end = max(end, e)
    return dict(kernels=[(e.name, e.time_range.start, e.time_range.end)
                         for e in dev],
                busy_s=busy_us(spans) / 1e6, window_s=wall_s, steps=steps,
                idle_gaps=gaps.most_common(TOP))


def eager_record(events, dev, steps: int) -> dict:
    """Busy device seconds per step part over ``steps`` op-by-op steps."""
    parts = step_parts(events, dev)
    return dict(steps=steps, parts_s={
        p: busy_us([(e.time_range.start, e.time_range.end)
                    for e, q in zip(dev, parts) if q == p]) / 1e6
        for p in PARTS})


def family(name: str) -> str:
    """A device op's name without template and call arguments and a
    numbered suffix (after ``profile_step.family``)."""
    short = re.sub(r"^void |\(anonymous namespace\)::", "", name)
    short = re.split(r"[<(]", short, maxsplit=1)[0].strip()
    return re.sub(r"[.\d_]+$", "", short) or name


def device_ops(kernels) -> list:
    """The device op families that took most time: [[name, seconds]]."""
    total = collections.Counter()
    for name, s, e in kernels:
        total[family(name)] += (e - s) / 1e6
    return [[n, v] for n, v in total.most_common(TOP)]
