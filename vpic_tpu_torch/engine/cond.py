"""The port's ``lax.cond``: a branch that the card takes, with no host read.

The JAX step branches on device scalars with ``lax.cond``: the interval
cleans and the shared-face sync on ``state.step``
(``vpic_tpu/engine/step.py:411-424``), a species' own sort interval
(``:252-255``), the Marder passes on their rms errors (``:93-119``) and
the merge re-sort's fast-or-full decision (``particles/sort_pallas.py:
347, 355``).  :func:`cond` is their counterpart:

- **Under a CUDA graph capture** (``pred`` on the card, the current stream
  capturing): two conditional nodes, an if-node on ``pred`` around
  ``true_fn`` and one on ``~pred`` around ``false_fn`` (an if-else node
  needs CUDA 12.8), made by the port's own entries in
  ``csrc/cond_node.cu``, since the PyTorch on the card (2.11) binds no
  conditional node to Python: a one-thread kernel sets the node's handle
  from ``pred`` at every launch, and each body is captured on a stream of
  its own (one per nesting depth) into the node's body graph, its
  allocations routed into a private pool of the bodies.  Inside the
  second body the false branch's outputs are copied into the first
  branch's buffers, so the graph after the nodes reads fixed addresses.
  A replay runs only the branch that ``pred`` names.  Calls nest, and so
  do their nodes.  A node that cannot be made raises: nothing inside a
  graph falls back to the select.
- **Otherwise** (eager on the card, and on the CPU): both branches and
  one ``torch.where`` per output tensor (:func:`select`), bitwise the
  branch taken; nothing is read back.

The branches take ``operands`` and return the same structure of tensors
(tensors, dataclasses, tuples, lists, dicts): fresh tensors or tensors of
``operands``, never another tensor from outside the branch, which the
copy into the first branch's buffers would overwrite.  Where the true
branch passes an operand through and the false branch gives that slot
another tensor, the false body writes a fresh buffer and a third if-node
on ``pred`` copies the operand into it.

**Several shards** (``cond(..., comm=...)``, the ``lax.cond`` inside the
JAX package's ``shard_map``-ped step, ``vpic_tpu/engine/step.py:87-119,
411-424``): every shard takes the same branch.  Where the shards of a
deck run in the threads of ``engine/distributed.run_shards`` and the
rendezvous hands the turns, a body that holds turns (the ``allsum`` of a
clean, the halo exchanges) cannot be issued whole in one thread's turn.
So under a capture one node holds every shard's part of a body: every
shard reaches a barrier; shard 0, which runs first after a barrier,
makes the node on its own predicate, on the one stream that every shard
issues into, and starts the body's allocations into the depth's pool;
each shard in its turn issues its part of the body on the node's body
stream (kept on its own stack of open bodies, so that
:func:`home_stream` resolves); a barrier, and shard 0 ends the node
before anyone issues past it.  The false branch's node, and a third
where any shard's true branch passed an operand through, go the same
way.  Nested calls take the next depth's stream and pool.  Shard 0's
predicate stands for every shard's, which is sound only because they are
bitwise equal: ``state.step`` is the same on every shard, and
``ShardComm.allsum`` sums in float64 in rank order, so every shard holds
the same rms error; nothing reads them back to check.  A shard that
raises inside a body breaks the rendezvous: shard 0 ends the open nodes,
the call raises that shard's own exception, and the depth's bodies take
a new pool.  A failure that invalidates the body's capture (a read of the
card from the host there) leaves the body graph undefined in CUDA:
:data:`invalid_bodies` counts them, and ``engine/graphs.py`` never
destroys a graph that holds one.  Eagerly and on the CPU this is the select too: every shard
runs both branches, so the barriers inside both pair up.  With one shard
(``LocalComm``) it is the plain form above.

**Launch counts.**  ``launches`` counts the nodes' set kernel, one
launch per node made (one per node of several shards, whose shard 0
makes it); a replay runs it wherever it reaches the node.  A
kernel's wrapper counts its launches on the host when Python issues
them; a graph's replay adds what its capture issued
(``engine/graphs.py``).  A launch inside a conditional body runs only
where the card takes the branch, so a body that issues counted launches
(:func:`counters`) takes them back from the host counts and adds 1 to a
tally word of its own on the card at every run (a body of several
shards one word, for every shard's launches); :func:`settle` turns the
tallies into launches (one host read), and :func:`reset` zeros them in
place.  The tallies live in one buffer per device, made by
:func:`prepare` outside any capture.

How a capture makes its nodes (the capture test, the streams, the native
entries, the allocator's pools) is :data:`NODES`, in one place, so that
the CPU tests can put a recorder in its place and follow the protocol.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import threading

import torch

# how a capture makes its conditional nodes: the port's own entries in
# csrc/cond_node.cu (PyTorch 2.11, on the card, binds none to Python)
ROUTE = "native"
# tally words per device: one per conditional body that issues counted
# launches, never reused (a graph keeps its pointers)
TALLY_SLOTS = 1 << 14

# the launches of csrc/cond_node.cu's set_if_kernel, one per node made
launches = {"cond_set_if": 0}
_tallies: dict = {}     # device -> (TALLY_SLOTS,) int64 on the device
_bodies: list = []      # (device, slot, launches per run) of each body
# bodies whose capture a failure inside them invalidated (a host read
# there): CUDA leaves such a body graph undefined, and destroying the graph
# that holds its node crashes the process (engine/graphs.py keeps it)
invalid_bodies = 0


def counters() -> tuple:
    """The kernels' launch counts that a graph's replay, or a conditional
    body's run, adds to (the wrappers' ``launches``; imported here, since
    the merge re-sort's plain passes branch through :func:`cond`)."""
    from ..core import random_cuda
    from ..particles import deposit_cuda, push_cuda, sort_cuda
    return (push_cuda.launches, deposit_cuda.launches, sort_cuda.launches,
            random_cuda.launches, launches)


def _lock():
    """The wrappers' lock, which guards their launch counts."""
    from ..particles.push_cuda import _lock as lock
    return lock


def counts() -> list:
    """A copy of every launch count of :func:`counters`."""
    with _lock():
        return [dict(c) for c in counters()]


def prepare(device) -> None:
    """Make the tally words of ``device`` (a CUDA device; outside any
    capture, since a graph that made them would zero them at every
    replay)."""
    device = torch.device(device)
    with _lock():
        if device.type == "cuda" and device not in _tallies:
            _tallies[device] = torch.zeros((TALLY_SLOTS,), dtype=torch.int64,
                                           device=device)


def settle() -> None:
    """Add the launches of every conditional body's runs since the last
    call (or :func:`reset`) to the host counts, and zero the tallies."""
    with _lock():
        for device, tally in _tallies.items():
            mine = [(slot, d) for dev, slot, d in _bodies if dev == device]
            if not mine:
                continue
            runs = tally.tolist()
            tally.zero_()
            for slot, delta in mine:
                for c, d in zip(counters(), delta):
                    for name, v in d.items():
                        c[name] += runs[slot] * v


def reset() -> None:
    """Zero the set kernel's launch count and the tallies, these in place
    (a graph keeps adding to the same words)."""
    with _lock():
        launches["cond_set_if"] = 0
        for tally in _tallies.values():
            tally.zero_()


def leaves(obj, out=None) -> list:
    """The tensors of ``obj`` (tensors, dataclasses, tuples, lists, dicts
    by sorted key), in a fixed order."""
    out = [] if out is None else out
    if isinstance(obj, torch.Tensor):
        out.append(obj)
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        for f in dataclasses.fields(obj):
            leaves(getattr(obj, f.name), out)
    elif isinstance(obj, (tuple, list)):
        for v in obj:
            leaves(v, out)
    elif isinstance(obj, dict):
        for k in sorted(obj):
            leaves(obj[k], out)
    return out


def _rebuild(obj, it):
    """``obj`` with its tensors replaced, in :func:`leaves` order, by the
    items of ``it``."""
    if isinstance(obj, torch.Tensor):
        return next(it)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{
            f.name: _rebuild(getattr(obj, f.name), it)
            for f in dataclasses.fields(obj)})
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(_rebuild(v, it) for v in obj))
    if isinstance(obj, (tuple, list)):
        return type(obj)(_rebuild(v, it) for v in obj)
    if isinstance(obj, dict):
        return {k: _rebuild(obj[k], it) for k in sorted(obj)}
    return obj


def _pairs(t_out, f_out):
    """The two branches' tensors, slot by slot, checked alike."""
    ts, fs = leaves(t_out), leaves(f_out)
    if len(ts) != len(fs) or any(
            a.shape != b.shape or a.dtype != b.dtype or a.device != b.device
            for a, b in zip(ts, fs)):
        raise ValueError("cond: the branches return different structures: "
                         f"{[(tuple(a.shape), a.dtype) for a in ts]} vs "
                         f"{[(tuple(b.shape), b.dtype) for b in fs]}")
    return ts, fs


def select(pred, true_fn, false_fn, operands=()):
    """Both branches, then per output tensor the one ``pred`` names
    (``torch.where``; a slot both branches share is kept as it is)."""
    t_out, f_out = true_fn(*operands), false_fn(*operands)
    ts, fs = _pairs(t_out, f_out)
    return _rebuild(t_out, iter([a if a is b else torch.where(pred, a, b)
                                 for a, b in zip(ts, fs)]))


def cond(pred, true_fn, false_fn, operands=(), comm=None):
    """``true_fn(*operands)`` where the 0-d bool tensor ``pred`` holds,
    else ``false_fn(*operands)``: conditional graph nodes under a capture
    on the card, :func:`select` otherwise (module docstring).  ``comm``:
    the calling shard's ``ShardComm`` where every shard of a deck makes
    this call in its turn and the branches hold the rendezvous' turns;
    one node then holds every shard's part of a body."""
    operands = tuple(operands)
    if not NODES.capturing(pred):
        return select(pred, true_fn, false_fn, operands)
    return _nodes(pred, true_fn, false_fn, operands,
                  comm if comm is not None and comm.rv.n > 1 else None)


_local = threading.local()
_streams: dict = {}     # (device, depth) -> the bodies' stream
_pools: dict = {}       # (device, depth) -> the bodies' memory pool


def _open() -> list:
    """This thread's open bodies, outermost first: (body stream, the
    stream the outermost capture runs on)."""
    if not hasattr(_local, "open"):
        _local.open = []
    return _local.open


def home_stream(stream: int) -> int:
    """The stream a capture runs on, for a body's stream (else
    ``stream``): the kernels' wrappers key their scratch by it, so a body
    finds the scratch that the graph's warm-up made on that stream."""
    for body, home in _open():
        if body == stream:
            return home
    return stream


def _native():
    from ..particles import push_cuda
    lib = push_cuda.build()
    with _lock():
        if not getattr(lib, "cond_bound", False):
            lib.vpic_cond_stream.argtypes = [ctypes.POINTER(ctypes.c_void_p)]
            lib.vpic_cond_begin.argtypes = [ctypes.c_void_p] * 3 + [
                ctypes.c_int]
            lib.vpic_cond_end.argtypes = [ctypes.c_void_p]
            for fn in (lib.vpic_cond_stream, lib.vpic_cond_begin,
                       lib.vpic_cond_end):
                fn.restype = ctypes.c_int
            lib.cond_bound = True
    return lib


class CardNodes:
    """How a capture on the card makes its conditional nodes: the capture
    test, the bodies' streams and pools, the entries of
    ``csrc/cond_node.cu`` and the allocator's routing into a pool."""

    def capturing(self, pred) -> bool:
        """Whether ``pred``'s branch is taken inside a graph: ``pred`` on
        the card and the calling thread's stream capturing."""
        return pred.is_cuda and torch.cuda.is_current_stream_capturing()

    def parent(self, device) -> int:
        """The calling thread's current stream on ``device``."""
        return torch.cuda.current_stream(device).cuda_stream

    def body(self, device, depth: int):
        """(stream, pool) of the bodies at nesting ``depth`` on
        ``device``: the stream made once (``cudaStreamCreate``, not one of
        PyTorch's pooled streams), so the bodies' cached blocks, which the
        allocator keys by stream, serve the bodies to come."""
        key = (device, depth)
        with _lock():
            if key not in _streams:
                ptr = ctypes.c_void_p()
                with torch.cuda.device(device):
                    err = _native().vpic_cond_stream(ctypes.byref(ptr))
                if err:
                    raise RuntimeError(f"cond: cudaStreamCreate failed "
                                       f"({err})")
                _streams[key] = torch.cuda.ExternalStream(ptr.value,
                                                          device=device)
                _pools[key] = torch.cuda.graph_pool_handle()
            return _streams[key], _pools[key]

    def renew(self, device, depth: int) -> None:
        """A new pool for the bodies at ``depth``, after a body failed."""
        with _lock():
            if (device, depth) in _pools:
                _pools[(device, depth)] = torch.cuda.graph_pool_handle()

    def handle(self, stream) -> int:
        return stream.cuda_stream

    def on(self, stream):
        """``stream`` as the calling thread's current stream, for a
        block."""
        return torch.cuda.stream(stream)

    def begin(self, parent: int, body, pred, negate: bool) -> None:
        """An if-node on ``pred`` (``~pred`` where ``negate``) after what
        ``parent`` captured so far, its body captured from ``body``."""
        err = _native().vpic_cond_begin(parent, body.cuda_stream,
                                        pred.data_ptr(), int(negate))
        if err:
            raise RuntimeError(f"cond: the conditional node was not made "
                               f"(cudaError {err})")

    def end(self, body) -> int:
        """End the body's capture: the CUDA error, 0 where none."""
        return _native().vpic_cond_end(body.cuda_stream)

    def allocate(self, device, pool) -> None:
        """Route the allocations on the current stream into ``pool``, a
        private pool never released, so nothing outside a graph takes its
        blocks.  One routing per pool at a time: PyTorch refuses a
        second."""
        torch._C._cuda_beginAllocateCurrentStreamToPool(device.index, pool)

    def release(self, device, pool) -> None:
        torch._C._cuda_endAllocateToPool(device.index, pool)


# the node maker that every capture uses
NODES = CardNodes()


@contextlib.contextmanager
def _if_node(pred, negate: bool = False, comm=None):
    """Capture the block into the body of an if-node on ``pred`` (on
    ``~pred`` where ``negate``) of the graph that the current stream is
    capturing; a body that issued counted launches takes them back and
    tallies its runs.  ``comm`` (several shards): every shard enters in
    its turn, with a barrier before the block and one after it, and shard
    0 alone makes, routes, tallies and ends the node (module
    docstring)."""
    lead = comm is None or comm.rank == 0
    device = pred.device
    opened = _open()
    depth = len(opened)
    if comm is not None:
        # every shard has issued what comes before the node
        comm.rv.wait(comm.rank)
    body, pool = NODES.body(device, depth)
    parent = NODES.parent(device)
    if lead:
        NODES.begin(parent, body, pred, negate)
        with _lock():
            launches["cond_set_if"] += 1
    opened.append((NODES.handle(body), opened[0][1] if opened else parent))
    failed = True
    try:
        with NODES.on(body):
            if lead:
                NODES.allocate(device, pool)
            try:
                start = counts() if lead else None
                yield
                if comm is not None:
                    # every shard's part is issued; shard 0 runs first
                    comm.rv.wait(comm.rank)
                if lead:
                    _tally(device, start)
            finally:
                if lead:
                    NODES.release(device, pool)
        failed = False
    finally:
        opened.pop()
        if lead:
            err = NODES.end(body)
            if failed:
                NODES.renew(device, depth)
                if err:
                    global invalid_bodies
                    with _lock():
                        invalid_bodies += 1
            elif err:
                raise RuntimeError(f"cond: the conditional body's capture "
                                   f"failed (cudaError {err})")


def _tally(device, start) -> None:
    delta = [{k: v - s.get(k, 0) for k, v in c.items() if v != s.get(k, 0)}
             for c, s in zip(counts(), start)]
    if not any(delta):
        return
    with _lock():
        tally = _tallies.get(device)
        slot = sum(dev == device for dev, _, _ in _bodies)
        if tally is None or slot >= TALLY_SLOTS:
            raise RuntimeError(
                f"cond: no tally word left on {device} for a conditional "
                "body's launches (engine.cond.prepare before the capture)")
        for c, d in zip(counters(), delta):
            for name, v in d.items():
                c[name] -= v
        _bodies.append((device, slot, delta))
    tally[slot].add_(1)


def _as_pred(pred):
    if pred.dim() != 0:
        raise ValueError(f"cond: the predicate is {tuple(pred.shape)}, not "
                         "0-d")
    return (pred if pred.dtype == torch.bool else pred != 0).contiguous()


def _nodes(pred, true_fn, false_fn, operands, comm=None):
    """:func:`cond` under a capture (module docstring); with ``comm``
    each node holds every shard's part, and whether a third node is
    needed is shared at the rendezvous (``rv.shared``, per depth): shard
    0 clears it first in the false body, and every shard reads it after
    the barrier that ends that body."""
    pred = _as_pred(pred)
    own = {t.untyped_storage().data_ptr() for t in leaves(operands)}
    key = ("cond late", len(_open()))
    with _if_node(pred, comm=comm):
        t_out = true_fn(*operands)
    ts = leaves(t_out)
    out, late = list(ts), []
    with _if_node(pred, True, comm):
        ts, fs = _pairs(t_out, false_fn(*operands))
        for k, (a, b) in enumerate(zip(ts, fs)):
            if a is b:
                continue
            if a.untyped_storage().data_ptr() in own:
                # the true branch passed an operand through: the false
                # branch's value goes to a fresh buffer, which the
                # operand's value reaches by a third node below
                out[k] = b.clone()
                late.append(k)
            else:
                a.copy_(b)
        if comm is not None:
            if comm.rank == 0:
                comm.rv.shared[key] = False
            if late:
                comm.rv.shared[key] = True
    if late if comm is None else comm.rv.shared[key]:
        with _if_node(pred, comm=comm):
            for k in late:
                out[k].copy_(ts[k])
    return _rebuild(t_out, iter(out))
