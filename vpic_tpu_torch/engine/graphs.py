"""The step as one program on the card: CUDA graphs of the units that
``Simulation.advance`` dispatches, the counterparts of the JAX package's
jitted step, resort cycle and super-cycle executables
(``vpic_tpu/deck/api.py:565-871``).

The JAX package never issues a step op by op.  A step, a resort cycle of
k steps, a run of m cycles and S whole super-cycles are each one compiled
program that runs on donated buffers.  The port's counterpart of such a
program is a CUDA graph, captured once and replayed on static buffers:

- :func:`plan` gives, from ``(step, n, k, M)``, the units that the JAX
  loop dispatches (``advance``, ``api.py:836-871``) as ``(kind, count)``:
  ``count`` replays of one graph of :func:`unit_steps` steps.  A scan of m
  cycles is m replays, one host call each, as one scan iteration is in
  XLA; S super-cycles are S replays of the graph of one.
- The JAX step reads ``state.step`` on the device and branches with
  ``lax.cond``; its dispatch units fix only the sort flags.  So does the
  port: a unit's graph is keyed by its steps' sort flags
  (``engine/step.graph_sort_flags``), and the cleans, the shared-face
  sync, the Marder passes and path B's fast-or-full decision are
  conditional nodes inside the graph (``engine/cond.py``), on a sharded
  deck each one node around every shard's part.
- :class:`GraphRunner` holds the static state, the graphs and their one
  memory pool.  A graph copies its outputs back into the static state
  inside the graph (the counterpart of ``donate_argnums``), so a replay
  leaves the advanced state in the same buffers.  On the CPU the runner
  runs the unit's steps eagerly where the card would replay, with the
  same copy-in and copy-out, so the CPU tests reach its code.
- A replay has no profiler scopes inside it, so the step's parts carry
  device-clock spans (``engine/spans.py``), which a capture keeps as
  stamp kernels: every replay stamps the parts of its steps, the
  conditional bodies' included, inside the span ``graphs.unit``, which
  holds the unit's body and its write-back, the span
  ``graphs.write_back``.  On the host, :meth:`GraphRunner.run` opens the
  profiler scopes ``graphs.capture.<kind>`` and ``graphs.replay.<kind>``:
  in a ``torch.profiler`` trace their host intervals are a unit kind's
  capture seconds and each replay's enqueue time.  ``StepOptions.spans``
  off, a graph holds no stamp.

A unit is captured the first time its key comes up.  The unit first runs
eagerly on a clone of the static state, on the capture stream: that
builds the kernels and makes the per-stream scratch of the kernels'
wrappers (``push_cuda._scratch_for``) and the package's caches outside
the capture, without advancing the real state.  The wrappers' launch
counts move only while Python runs, so each graph keeps the counts its
capture added and adds them again at every replay; the warm-up's and the
capture's own counts are taken back, and so are the warm-up's additions
to the merge re-sort's device counters of fast and slow sorts
(``sort_cuda.sort_counters``), which a replay adds to on the card.  A
launch inside a conditional node's body is counted where the replay runs
the body (``engine/cond.settle``).  A capture or replay that fails
raises: nothing falls back to eager steps.  A capture that failed inside
a conditional body whose own capture the failure invalidated (a host read
there; ``engine/cond.invalid_bodies``) is never destroyed: CUDA leaves
that body graph undefined, and destroying its graph crashed the process.

Which decks run so is ``Simulation._graph_ok()``'s decision: every deck
whose shards all live on the one card, the open ones included (boundary
rounds, emitters, the injection and collision hooks), since the random
state is a device tensor that the threefry kernel reads at each replay
(``core/random.py``) and the graph writes back like any other buffer,
and the packed merge re-sort, whose mover count and fast-or-full
decision stay on the card (``particles/sort.py``): there the static state
is the packed mirror, its ``key0``/``ctot`` carry included, which the
graphs carry from replay to replay as the JAX package donates it.  A
mesh over several devices (a graph belongs to one) steps eagerly.

Several shards on one card (the counterpart of the JAX package's
``shard_map``-ped step, cycle and super-cycle, ``vpic_tpu/deck/api.py:
565-611``): the static state is the list of per-shard states in rank
order, and the unit's body runs ``engine/distributed.run_shards``.  Its
shard threads take the caller's current stream, the capture stream, and
the rendezvous runs them one at a time, so one graph holds every shard's
work in the order the eager step issues it, the halo exchanges, the
``allsum`` of a clean and the migration rounds included; a decision that
holds the rendezvous' turns (a clean, the sync, a Marder pass) is one
conditional node around every shard's part; a replay needs no thread and
no rendezvous.  The capture is begun by the calling thread
and launched into by the shard threads under CUDA's default capture mode,
``"global"``: a capture follows its stream, not its thread, so the shard
threads' launches and allocations land in the graph and the runner's
pool, and a host read in a shard thread still invalidates the capture
and raises.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import time

import torch
from torch.profiler import record_function

from ..particles import push_cuda, sort_cuda
from . import cond
from . import spans as _spans
from .step import StepOptions


def plan(step: int, n: int, k: int, M: int, cycles: bool = True) -> list:
    """The units of ``advance(n)`` from ``step``: the JAX package's
    dispatch loop (``vpic_tpu/deck/api.py:836-871``) with resort interval
    ``k``, cycle multiple ``M`` and, where ``cycles``, the cycle
    executables (the JAX package builds them for k > 1).  Each unit is
    ``(kind, count)``: ``supercycle`` (an A cycle and M - 1 B cycles),
    ``cycle_b`` (a B cycle: only the species of the base interval sort),
    ``cycle`` (an A cycle: every species sorts), ``step`` and
    ``step_nosort`` (one step on and off the resort cadence)."""
    units, left = [], n
    while left > 0:
        if cycles and left >= k and step % k == 0:
            c = step // k
            if M > 1 and c % M == 0 and left >= k * M:
                count = left // (k * M)
                units.append(("supercycle", count))
                step, left = step + count * k * M, left - count * k * M
                continue
            if M > 1 and c % M != 0:
                count = min(left // k, M - c % M)
                units.append(("cycle_b", count))
                step, left = step + count * k, left - count * k
                continue
            count = left // k if M == 1 and left // k >= 2 else 1
            units.append(("cycle", count))
            step, left = step + count * k, left - count * k
            continue
        units.append(("step_nosort" if k > 1 and step % k else "step", 1))
        step, left = step + 1, left - 1
    return units


def unit_steps(kind: str, k: int, M: int) -> int:
    """The steps one replay of a ``kind`` unit spans."""
    return {"supercycle": k * M, "cycle_b": k, "cycle": k}.get(kind, 1)


_leaves = cond.leaves


def _map(fn, obj):
    """``obj`` with ``fn`` applied to each of its tensors."""
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{
            f.name: _map(fn, getattr(obj, f.name))
            for f in dataclasses.fields(obj)})
    if isinstance(obj, (tuple, list)):
        return type(obj)(_map(fn, v) for v in obj)
    if isinstance(obj, dict):
        return {key: _map(fn, v) for key, v in obj.items()}
    return obj


def clone_state(state):
    """A copy of ``state`` that shares no tensor with it."""
    return _map(torch.clone, state)


def _layout(state) -> list:
    return [(tuple(t.shape), t.dtype, t.device) for t in _leaves(state)]


def write_back(static, out, capturing: bool = False) -> None:
    """Copy the tensors of ``out`` (a unit's result) into those of
    ``static`` (its input), slot by slot; inside a capture the copies are
    nodes of the graph.  A slot that still holds its input tensor is not
    copied.  A result that aliases another slot's input (the same storage)
    is cloned before any slot is written, so every slot gets the value
    the unit gave it.  ``capturing``: inside a capture, where a host (CPU)
    tensor must come back unchanged, since a graph does not replay host
    work."""
    dst, src = _leaves(static), _leaves(out)
    if len(dst) != len(src):
        raise ValueError(f"the unit returned {len(src)} tensors for "
                         f"{len(dst)}")
    inputs = {t.untyped_storage().data_ptr() for t in dst}
    pairs = []
    for d, s in zip(dst, src):
        if s is d or (s.data_ptr() == d.data_ptr() and s.shape == d.shape
                      and s.stride() == d.stride()):
            continue
        if s.device != d.device or (capturing and d.device.type == "cpu"):
            raise RuntimeError(
                f"the unit changed a {tuple(d.shape)} {d.device} tensor of "
                "the state that a graph cannot write: host state needs the "
                "eager step")
        if s.untyped_storage().data_ptr() in inputs:
            s = s.clone()
        pairs.append((d, s))
    for d, s in pairs:
        d.copy_(s)


class GraphRunner:
    """The graphs of one simulation's units, their static state and
    their memory pool.  A unit is run by :meth:`run` with its key (the
    host's decisions of its steps) and its body: ``body(state, start,
    n)`` steps ``state`` through steps ``start`` to ``start + n - 1``
    eagerly.  The runner keeps no reference to its owner, so a
    simulation and its graphs are freed together when it is dropped.

    ``counts`` (shared with the simulation) gains ``captures``,
    ``graphed_steps`` and, per unit kind, ``replays.<kind>``;
    ``capture_s`` gets one record per capture on the card: the unit's
    kind and steps, the seconds of the warm-up on the clone and of the
    capture, the captured graph's node count, its top-level nodes by type
    (``node_types``: conditional nodes among them) and the seconds of its
    instantiation.  The static state is one state, or on a sharded deck
    the list of the per-shard states, which :meth:`load` and the copy-out
    treat as one.  ``opts``: the deck's ``StepOptions``, whose ``spans``
    says whether the runner stamps the spans ``graphs.unit`` and
    ``graphs.write_back`` (``engine/spans.py``) on the static state's
    step, as the step stamps its parts.

    The graphs share one pool: each copies its results into the static
    state and keeps no tensor of the pool alive after its capture, and
    the graphs replay one at a time on one stream, so one pool serves all
    of them (after a failed capture the graphs to come take a new one,
    since PyTorch records into an invalidated capture's pool no more).
    :meth:`close` frees the graphs and the pool (the owner calls it before
    it builds new ones); the runner holds the only references."""

    def __init__(self, device, counts, capture_s, opts=StepOptions()):
        self.device = torch.device(device)
        self.part = _spans.parts(opts.spans)
        self.capture = self.device.type == "cuda"
        self.counts = counts
        self.capture_s = capture_s
        self.static = None
        self.graphs = {}
        if self.capture:
            self.stream = torch.cuda.Stream(self.device)
            self.pool = torch.cuda.graph_pool_handle()

    def load(self, state) -> None:
        """Copy ``state`` into the static state (made on the first load,
        and again with the graphs dropped where the layout differs)."""
        if self.static is not None and _layout(self.static) == _layout(state):
            for d, s in zip(_leaves(self.static), _leaves(state)):
                if d is not s:
                    d.copy_(s)
            return
        self.close()
        self.static = clone_state(state)

    def close(self) -> None:
        """Drop the graphs (after the work queued on the card)."""
        if self.graphs and self.capture:
            torch.cuda.synchronize(self.device)
        self.graphs.clear()

    def run(self, kind: str, key: tuple, start: int, n: int, body) -> None:
        """Advance the static state by the unit of ``n`` steps from step
        ``start``: replay the graph of ``key``, captured from ``body``
        first where the key is new."""
        entry = self.graphs.get(key)
        if entry is None:
            with record_function("graphs.capture." + kind):
                entry = self.graphs[key] = self._capture(kind, start, n,
                                                         body)
        graph, delta = entry
        with record_function("graphs.replay." + kind):
            if graph is None:
                self._unit(body, start, n)
            else:
                graph.replay()
        if graph is not None:
            with push_cuda._lock:
                for c, d in zip(cond.counters(), delta):
                    for name, v in d.items():
                        c[name] += v
        self.counts["replays." + kind] += 1
        self.counts["graphed_steps"] += n

    def _unit(self, body, start: int, n: int, capturing: bool = False):
        """The unit's body on the static state and its write-back, in the
        spans ``graphs.unit`` and ``graphs.write_back`` on the static
        state's step (its first shard's), stamped as a graph's unit's."""
        first = (self.static[0] if isinstance(self.static, list)
                 else self.static)
        step = getattr(first, "step", None)
        with _spans.unit(), self.part("graphs.unit", step,
                                     device=self.device):
            out = body(self.static, start, n)
            with self.part("graphs.write_back", step, device=self.device):
                write_back(self.static, out, capturing=capturing)

    def _capture(self, kind: str, start: int, n: int, body):
        """(graph, launch counts per replay) of the unit; (None, ()) on
        the CPU.  A warm-up or capture that fails raises the body's own
        exception (a shard's, through ``run_shards``), after the capture
        is ended, and keeps nothing: the static state is unchanged, since
        a capture runs no work."""
        self.counts["captures"] += 1
        if not self.capture:
            return None, ()
        # the conditional bodies' tally words and the spans' ring, made
        # outside any capture
        cond.prepare(self.device)
        _spans.prepare(self.device)
        before = cond.counts()
        sorts = {k: c.clone() for k, c in sort_cuda.sort_counters().items()}
        try:
            t0 = time.perf_counter()
            cur = torch.cuda.current_stream(self.device)
            self.stream.wait_stream(cur)
            with torch.cuda.stream(self.stream):
                body(clone_state(self.static), start, n)
            cur.wait_stream(self.stream)
            torch.cuda.synchronize(self.device)
            t1 = time.perf_counter()
            warm = cond.counts()
            graph, types = self._record(body, start, n)
            t2 = time.perf_counter()
            graph.instantiate()
            torch.cuda.synchronize(self.device)
            t3 = time.perf_counter()
            delta = [{name: v - w.get(name, 0) for name, v in c.items()
                      if v != w.get(name, 0)}
                     for c, w in zip(cond.counts(), warm)]
        finally:
            with push_cuda._lock:
                for c, b in zip(cond.counters(), before):
                    c.clear()
                    c.update(b)
            for k, c in sort_cuda.sort_counters().items():
                if k in sorts:
                    c.copy_(sorts[k])
                else:
                    c.zero_()
        self.capture_s.append(dict(kind=kind, steps=n, warmup_s=t1 - t0,
                                   capture_s=t2 - t1,
                                   nodes=sum(types.values()),
                                   node_types=types,
                                   instantiate_s=t3 - t2))
        return graph, delta

    def _record(self, body, start: int, n: int):
        """Capture the unit on the capture stream: (graph, its top-level
        nodes by type).  The graph is kept uninstantiated, so that its
        nodes can be counted; the caller instantiates it."""
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        # as torch.cuda.graph does: the cached blocks go back first
        torch.cuda.synchronize(self.device)
        torch.cuda.empty_cache()
        invalid = cond.invalid_bodies
        with torch.cuda.stream(self.stream):
            graph.capture_begin(pool=self.pool)
            try:
                self._unit(body, start, n, capturing=True)
            except BaseException:
                # an invalidated capture's own error would hide the body's.
                # Its capture_end raises before it takes the allocator off
                # the pool, and PyTorch then refuses every later capture
                # into that pool: end the allocation here and give the
                # graphs to come a new pool
                with contextlib.suppress(Exception):
                    graph.capture_end()
                with contextlib.suppress(RuntimeError):
                    torch._C._cuda_endAllocateToPool(self.device.index,
                                                     self.pool)
                self.pool = torch.cuda.graph_pool_handle()
                if cond.invalid_bodies != invalid:
                    # a conditional body's capture was invalidated inside
                    # it: destroying the graph that holds that body
                    # crashed the process (a card test), so it lives on
                    ctypes.pythonapi.Py_IncRef(ctypes.py_object(graph))
                raise
            graph.capture_end()
        return graph, node_types(graph.raw_cuda_graph())


# CUgraphNodeType (cuda.h), by value
NODE_TYPES = ("kernel", "memcpy", "memset", "host", "graph", "empty",
              "wait_event", "event_record", "ext_semas_signal",
              "ext_semas_wait", "mem_alloc", "mem_free", "batch_mem_op",
              "conditional")


def node_types(raw: int) -> dict:
    """The nodes of a captured ``cudaGraph_t`` by type
    (``cuGraphNodeGetType``): the top level only, a conditional node's
    body being a graph of its own."""
    lib = ctypes.CDLL("libcuda.so.1")
    get_type = lib.cuGraphNodeGetType
    get_type.argtypes = (ctypes.c_void_p, ctypes.POINTER(ctypes.c_int))
    get_type.restype = ctypes.c_int
    out: dict = {}
    for node in _nodes_of(raw):
        kind = ctypes.c_int(0)
        err = get_type(node, ctypes.byref(kind))
        if err:
            raise RuntimeError(f"cuGraphNodeGetType failed ({err})")
        name = (NODE_TYPES[kind.value] if kind.value < len(NODE_TYPES)
                else str(kind.value))
        out[name] = out.get(name, 0) + 1
    return out


def _nodes_of(raw: int) -> list:
    """The top-level nodes of a ``cudaGraph_t`` (``cuGraphGetNodes``)."""
    get_nodes = ctypes.CDLL("libcuda.so.1").cuGraphGetNodes
    get_nodes.argtypes = (ctypes.c_void_p, ctypes.c_void_p,
                          ctypes.POINTER(ctypes.c_size_t))
    get_nodes.restype = ctypes.c_int
    count = ctypes.c_size_t(0)
    err = get_nodes(raw, None, ctypes.byref(count))
    if err:
        raise RuntimeError(f"cuGraphGetNodes failed ({err})")
    nodes = (ctypes.c_void_p * count.value)()
    err = get_nodes(raw, nodes, ctypes.byref(count))
    if err:
        raise RuntimeError(f"cuGraphGetNodes failed ({err})")
    return list(nodes[:count.value])
