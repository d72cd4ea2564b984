"""Device-clock spans of the step's parts: they survive a CUDA graph's
replay and run inside conditional bodies.

A span is the ``torch.profiler`` scope that a step part always had
(``engine/step.PHASES``) and two stamps on the current stream, one just
before the scope opens and one just after it closes (so that a trace's
time of the scope holds no stamp).  On the card a stamp is a one-thread
kernel (``csrc/span_stamp.cu``) that reads the card's clock
(``%globaltimer``, ns), and on the card too the step (from the 0-d
``state.step``) and whether the span was taken (from an optional 0-d
predicate), and writes them into a ring per device.  Eagerly the stamps
run in the stream's order; in a graph's capture they are kernel nodes,
so every replay stamps anew; inside a conditional node's body
(``engine/cond.py``) they run where the card takes the branch.  An event
record could not: CUDA admits only kernel, copy, set, empty, child-graph
and conditional nodes in a body.  On the CPU a host ring stamped with
``time.perf_counter_ns`` does the same, so the CPU tests reach every line.

- :func:`span` is the context manager of the step's parts
  (``engine/step.py``: ``step.sort``, ``step.push``, ``step.field`` and
  the others of ``PHASES``; ``step.clean_div_e``, ``step.clean_div_b``
  and ``step.sync_shared`` around the true branch of each interval cond)
  and of the graphs (``engine/graphs.py``: ``graphs.unit`` around a
  unit's body and its write-back, ``graphs.write_back`` around the
  latter).  :func:`parts` gives it, or the bare scope where
  ``StepOptions.spans`` is off, which captures no stamp.  A stamp costs
  about a kernel launch of card time, so the step opens few: one sort,
  one push and one field span a step, over every species.
- :func:`records` reads the rings back, one copy per device, never inside
  a step, and pairs each begin with its end per (device, shard): the
  closed spans as :class:`Span`, untaken spans dropped, and the count of
  stamps that the ring overwrote.
- :func:`reset` empties the rings; ``Simulation.finalize`` calls it, so
  the records are those of the newest deck.
- :func:`align` places a ``torch.profiler`` trace on the card's clock:
  it pairs the trace's stamp kernels with their stamps, so that a trace's
  idle gap can be placed inside or between spans.

A ring holds :data:`CAPACITY` stamps per device, 16 B each.  It is made
outside any capture by :func:`prepare` (``GraphRunner`` calls it beside
``cond.prepare``; an eager stamp makes it on first use) and is never
freed, since a graph keeps its pointer.  A stamp is not a launch of the
wrappers' counts (``push_cuda.launches`` and the others of
``cond.counters``): no launch count moves.
"""

from __future__ import annotations

import contextlib
import ctypes
import threading
import time
from typing import NamedTuple

import numpy as np
import torch
from torch.profiler import record_function

# stamps per device ring (16 B each: the time, then the word)
CAPACITY = 1 << 16
# the word's low 32 bits (csrc/span_stamp.cu): bits 0-15 the span's id,
# 16-23 the shard, then these flags; the high 32 bits hold the step
_SHARD = 16
_END, _TAKEN, _GRAPHED = 1 << 24, 1 << 25, 1 << 26
# align(): a stamp kernel's middle in a trace pairs with the stamp that
# lies within ALIGN_JITTER_US of it, plus ALIGN_DRIFT_PPM of the trace's
# time since the pair before, under that pair's offset; the first kernels
# vote for the offset in bins of ALIGN_BIN_US, which also bounds a jump
# of the trace's clock
ALIGN_JITTER_US, ALIGN_DRIFT_PPM, ALIGN_BIN_US = 3.0, 1000.0, 25.0

_lock = threading.Lock()
_rings: dict = {}       # device -> its ring: on the card a tensor, else numpy
_ids: dict = {}         # span name -> id
_names: list = []       # id -> span name
_units = 0              # graphs' units open (engine/graphs.py)


class Span(NamedTuple):
    """A closed span: its name, the shard that opened it, the step it
    opened in (-1 without one), whether a graph's unit issued it, and its
    begin and end on the device's clock (ns)."""
    name: str
    shard: int
    step: int
    graphed: bool
    t0_ns: int
    t1_ns: int


class Records(NamedTuple):
    spans: list         # Span, by begin
    dropped: int        # stamps the rings overwrote


class Alignment(NamedTuple):
    offset_us: float    # the card's clock minus the trace's at the first
    #                     pair, in us
    residual_us: float  # the largest change of the offset between pairs,
    #                     the jumps aside
    jumps: int          # jumps of the trace's clock against the card's
    pairs: int          # stamp kernels paired
    points: tuple       # (trace us, card us) of the pairs

    def card_us(self, t):
        """The card's clock at the trace's time ``t`` (us): the pairs'
        offset, interpolated."""
        tr, card = self.points
        return t + np.interp(t, tr, np.asarray(card) - tr)


def _key(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def _new_ring(device: torch.device):
    if device.type == "cuda":
        return torch.zeros((1 + 2 * CAPACITY,), dtype=torch.int64,
                           device=device)
    return np.zeros((1 + 2 * CAPACITY,), dtype=np.int64)


def prepare(device) -> None:
    """Make the ring of ``device`` (on the card outside any capture, since
    a graph that made it would zero it at every replay)."""
    device = _key(device)
    with _lock:
        if device not in _rings:
            _rings[device] = _new_ring(device)


def reset() -> None:
    """Empty every ring: a card's in place (a graph keeps stamping into
    it), a host ring made anew at :data:`CAPACITY`."""
    with _lock:
        for device, ring in _rings.items():
            if isinstance(ring, np.ndarray):
                _rings[device] = _new_ring(device)
            else:
                ring[0].zero_()


@contextlib.contextmanager
def unit():
    """The stamps issued inside are a graph's unit's (``graphed``):
    ``GraphRunner`` opens it around a capture, and around the CPU runner's
    steps, which stand in for a replay."""
    global _units
    with _lock:
        _units += 1
    try:
        yield
    finally:
        with _lock:
            _units -= 1


def _id(name: str) -> int:
    with _lock:
        if name not in _ids:
            _ids[name] = len(_names)
            _names.append(name)
        return _ids[name]


def _native():
    from ..particles import push_cuda
    lib = push_cuda.build()
    with _lock:
        if not getattr(lib, "span_bound", False):
            lib.vpic_span_stamp.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_ulonglong,
                ctypes.c_uint, ctypes.c_void_p, ctypes.c_void_p]
            lib.vpic_span_stamp.restype = ctypes.c_int
            lib.span_bound = True
    return lib


def _ring(device: torch.device):
    ring = _rings.get(device)
    if ring is None:
        if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
            raise RuntimeError(f"spans: no ring on {device} for a stamp "
                               "under a capture (engine.spans.prepare "
                               "before the capture)")
        prepare(device)
        ring = _rings[device]
    return ring


def _stamp(device: torch.device, word: int, step, pred) -> None:
    ring = _ring(device)
    if isinstance(ring, np.ndarray):
        st = -1 if step is None else int(step)
        if pred is None or bool(pred):
            word |= _TAKEN
        with _lock:
            cap = (len(ring) - 1) // 2
            s = int(ring[0]) % cap
            ring[0] += 1
            ring[1 + 2 * s] = time.perf_counter_ns()
            ring[2 + 2 * s] = (st << 32) | word
        return
    if step is not None and (step.dtype != torch.int32 or step.dim() != 0
                             or step.device != device):
        raise ValueError(f"spans: the step is a {tuple(step.shape)} "
                         f"{step.dtype} tensor on {step.device}, not a 0-d "
                         f"int32 one on {device}")
    if pred is not None and (pred.dim() != 0 or pred.device != device):
        raise ValueError(f"spans: the predicate is a {tuple(pred.shape)} "
                         f"tensor on {pred.device}, not a 0-d one on "
                         f"{device}")
    err = _native().vpic_span_stamp(
        torch.cuda.current_stream(device).cuda_stream, ring.data_ptr(),
        (ring.numel() - 1) // 2, word,
        None if step is None else step.data_ptr(),
        None if pred is None else pred.data_ptr())
    if err:
        raise RuntimeError(f"spans: the stamp kernel's launch failed "
                           f"(cudaError {err})")


@contextlib.contextmanager
def span(name: str, step, comm=None, pred=None, device=None):
    """The profiler scope ``name`` and a stamp where it opens and one where
    it closes, on the current stream of the device of ``step`` (the 0-d
    int32 ``state.step``; None: ``device``, and no step).  ``comm``: the
    shard's ``ShardComm``, whose rank the stamps carry (0 without one).
    ``pred``: a 0-d tensor that says whether the span is taken, read on the
    card (the branch of a cond that the eager select runs for nothing
    leaves no span).  A block that raises leaves its begin unpaired."""
    device = _key(step.device if isinstance(step, torch.Tensor) else device)
    shard = comm.rank if comm is not None else 0
    word = _id(name) | ((shard & 0xFF) << _SHARD)
    if _units:
        word |= _GRAPHED
    if pred is not None and pred.dtype != torch.bool:
        pred = pred != 0
    _stamp(device, word, step, pred)
    with record_function(name):
        yield
    _stamp(device, word | _END, step, pred)


def _scope(name: str, step=None, comm=None, pred=None, device=None):
    return record_function(name)


def parts(on: bool = True):
    """:func:`span`, or where ``on`` is false the bare profiler scope of
    the same name, which stamps nothing (``StepOptions.spans``)."""
    return span if on else _scope


def _stamps() -> list:
    """Per device the stamps its ring holds, oldest first: (device, times
    in ns, words, stamps overwritten), one copy of each ring."""
    with _lock:
        rings = list(_rings.items())
    out = []
    for device, ring in rings:
        if isinstance(ring, np.ndarray):
            with _lock:
                arr = ring.copy()
        else:
            torch.cuda.synchronize(device)
            arr = ring.cpu().numpy()
        n, cap = int(arr[0]), (len(arr) - 1) // 2
        slots = np.arange(max(n - cap, 0), n) % cap
        out.append((device, arr[1 + 2 * slots], arr[2 + 2 * slots],
                    max(n - cap, 0)))
    return out


def records() -> Records:
    """The closed spans of every ring, by begin: each end paired with the
    newest open begin of its name on its (device, shard), begins left open
    above it dropped; spans whose stamps say untaken dropped."""
    spans, dropped = [], 0
    for _, times, words, lost in _stamps():
        dropped += lost
        open_: dict = {}
        for t, w in zip(times.tolist(), words.tolist()):
            low, step = w & 0xFFFFFFFF, w >> 32
            ident, shard = low & 0xFFFF, (low >> _SHARD) & 0xFF
            stack = open_.setdefault(shard, [])
            if not low & _END:
                stack.append((ident, t, step, low))
                continue
            k = next((k for k in range(len(stack) - 1, -1, -1)
                      if stack[k][0] == ident), None)
            if k is None:
                continue
            _, t0, step0, low0 = stack[k]
            del stack[k:]
            if low0 & low & _TAKEN:
                spans.append(Span(_names[ident], shard, step0,
                                  bool(low0 & _GRAPHED), t0, t))
    spans.sort(key=lambda s: s.t0_ns)
    return Records(spans, dropped)


def align(kernels, steps=None) -> Alignment:
    """Place a ``torch.profiler`` trace on the card's clock, so that a
    trace's idle gap can be placed inside or between spans
    (:meth:`Alignment.card_us`).  ``kernels``: the trace's device ops as
    (name, start us, end us); the process's one card holds the ring.  The
    two clocks drift apart by up to a few hundred ppm, and not at one rate
    (on the card, over 2-s windows), so the trace's stamp kernels, by
    their middles, are paired in order with the ring's stamps, each with
    the next stamp under the offset of the pair before, within the
    jitter and the most drift since that pair (:data:`ALIGN_JITTER_US`,
    :data:`ALIGN_DRIFT_PPM`): the offset is tracked, and a kernel that a
    trace places off its stamp pairs with none.  The profiler's clock also
    jumps against the card's now and then (by up to about 20 us on the
    card): where the kernel after such a kernel confirms it, the pair is
    a jump, counted apart.  It starts from each of
    the offsets that the first kernels vote for against every stamp (to
    the us), and the start that pairs the most kernels, with the least
    residual among them, wins.  ``steps``: (first, last), the steps the
    trace's window ran, so that only their stamps are candidates (steps
    repeat their kernels' spacing, so a window could pair a step early or
    late).  A residual is the change of the offset from one pair to the
    next, a jump's aside.

    Reliable on a window between cleans: a trace on the card shows the
    stamp kernels inside conditional bodies too, but up to a body's
    length off after a clean, so that a window with one pairs few of its
    kernels after it."""
    mids = np.sort([0.5 * (s + e) for name, s, e in kernels
                    if "stamp_kernel" in name])
    cards = [(t, w) for d, t, w, _ in _stamps() if d.type == "cuda"]
    if len(cards) != 1:
        raise ValueError(f"spans.align: {len(cards)} card rings, not one")
    times, words = cards[0]
    if steps is not None:
        step = words >> 32
        # a unit's closing stamps read the step it ends at
        times = times[(step >= steps[0]) & (step <= steps[1] + 1)]
    rec = np.sort(times / 1e3)
    if len(mids) == 0 or len(rec) == 0:
        raise ValueError(f"spans.align: {len(mids)} stamp kernels in the "
                         f"trace, {len(rec)} stamps")
    # the first kernels' votes for the offset in bins, each bin's start
    # its most voted us: stamps lie a few us apart, so a start off by half
    # a bin would pair the first kernels with their neighbours
    diff = (rec[None, :] - mids[:16, None]).ravel()
    bins = np.round(diff / ALIGN_BIN_US)
    keys, counts = np.unique(bins, return_counts=True)
    fits = []
    for key in keys[np.argsort(counts)[-32:]]:
        us, votes = np.unique(np.round(diff[bins == key]),
                              return_counts=True)
        fits.append(_track(mids, rec, float(us[np.argmax(votes)])))
    best = max(fits, key=lambda f: (f.pairs, -f.residual_us))
    if not best.pairs:
        raise ValueError("spans.align: no stamp meets the trace's stamp "
                         "kernels under any offset voted for")
    return best


def _tol(dt_us: float) -> float:
    """How far the offset may move over ``dt_us`` of the trace's time."""
    return ALIGN_JITTER_US + ALIGN_DRIFT_PPM * 1e-6 * dt_us


def _near(rec, t: float, last: int):
    """The index past ``last`` of the stamp of ``rec`` nearest ``t``, and
    its distance; (None, inf) where none is past ``last``."""
    j = int(np.searchsorted(rec, t))
    near = [k for k in (j - 1, j) if last < k < len(rec)]
    if not near:
        return None, float("inf")
    k = min(near, key=lambda k: abs(rec[k] - t))
    return k, abs(rec[k] - t)


def _jump(mids, rec, i: int, k: int, off: float) -> bool:
    """Whether kernel ``i`` paired with stamp ``k`` is a jump of the
    trace's clock from the offset ``off``: by at most
    :data:`ALIGN_BIN_US` (not a step's kernels missing from the trace,
    whose next step repeats their spacing), and the next two kernels pair
    in order with the next two stamps under the offset it gives."""
    new = rec[k] - mids[i]
    return abs(new - off) <= ALIGN_BIN_US and all(
        i + d < len(mids) and k + d < len(rec) and abs(
            rec[k + d] - mids[i + d] - new) <= _tol(mids[i + d] - mids[i])
        for d in (1, 2))


def _track(mids, rec, off: float) -> Alignment:
    """Pair the kernels' middles ``mids`` in order with the stamps ``rec``
    (both sorted, us), the offset tracked from ``off`` (:func:`align`):
    each kernel with the next stamp in order where it lies within the
    jitter and the drift since the pair before, or where it is a jump
    (:func:`_jump`), else with the nearest stamp within them (the stamps
    between had no kernel in the trace), else with none."""
    last, tr, card, res, jumps = -1, [], [], 0.0, 0
    for i, m in enumerate(mids):
        tol = _tol(m - tr[-1]) if tr else ALIGN_JITTER_US
        nxt, jump = last + 1, False
        if tr and nxt < len(rec) and abs(rec[nxt] - m - off) <= tol:
            k = nxt
        elif tr and nxt < len(rec) and _jump(mids, rec, i, nxt, off):
            k, jump = nxt, True
        else:
            k, dist = _near(rec, m + off, last)
            if dist > tol:
                continue
        if jump:
            jumps += 1
        elif tr:
            res = max(res, abs(rec[k] - m - off))
        last, off = k, rec[k] - m
        tr.append(m)
        card.append(rec[k])
    if not tr:
        return Alignment(off, float("inf"), 0, 0, ((), ()))
    tr, card = np.array(tr), np.array(card)
    return Alignment(float(card[0] - tr[0]), res, jumps, len(tr),
                     (tr, card))
