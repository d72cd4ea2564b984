"""Face-neighbor exchange (``vpic_tpu/comm/facecomm.py``; the reference's
mp port layer, grid_comm.c:6-78).

The value received at face ``f`` is the payload that our face-``f``
neighbor sent through its opposite face (grid_comm.c: sender =
bc[BOUNDARY(-i,-j,-k)]).

- :class:`ShardComm`: one instance per shard of a mesh whose shards all
  live in one process, each stepping in its own host thread
  (``engine/distributed.py``).  The shards meet at a :class:`Rendezvous`,
  which also runs their threads in turn: an exchange posts this shard's
  payloads, waits for every shard, takes its neighbors' and waits again
  before anyone posts anew.  A payload on another device is copied to
  this shard's with ``.to``.  On an unsharded axis a periodic
  (self-joined) face receives our own opposite-face payload and an
  unjoined face receives None, with no wait.
- :class:`LocalComm`: the ``ShardComm`` of an unsharded grid.
"""

from __future__ import annotations

import contextlib
import threading
import time

import torch

from ..core.types import FACE_AXIS, FACE_DIR, Grid, PERIODIC_FIELDS

OPP = (3, 4, 5, 0, 1, 2)


class ShardError(RuntimeError):
    """A shard's step failed, left without reaching an exchange the others
    reached, or a wait at the rendezvous exceeded its timeout."""


class Rendezvous:
    """Where the shards of one mesh meet, and the order in which their
    threads run: one at a time, by rank, each until its next barrier (an
    exchange has two: after every shard posted, after every shard read).
    A token goes round the ranks; a shard passes a barrier when the token
    comes back to it, by which time every other shard has reached that
    barrier.  Only one shard thread runs at a time, so the threads do not
    contend for the interpreter lock (each PyTorch call releases and takes
    it again) and the payloads need no lock.

    ``slots``: one posting slot per shard, emptied at the end of every
    run.  ``wait_s``: each shard's host
    seconds from reaching a barrier to passing it (the other shards'
    turns).  A shard that raises calls :meth:`abort`; every shard waiting
    then raises :class:`ShardError`, as does a wait longer than
    ``timeout`` seconds and a barrier that a finished shard never
    reached."""

    def __init__(self, n: int, timeout: float = 300.0):
        self.n = n
        self.timeout = timeout
        self.cond = threading.Condition()
        self.wait_s = [0.0] * n
        self.start()

    def start(self) -> None:
        """Ready for a new run of every shard (``run_shards``)."""
        self.turn = 0
        self.arrived = [0] * self.n
        self.done = [False] * self.n
        self.broken = None
        self.clear()

    def clear(self) -> None:
        """Drop the payloads the slots still hold (``run_shards`` at the
        end of a run): under a capture they are tensors of the graphs'
        pool, which no reference may keep alive after the capture."""
        self.slots = [None] * self.n

    def _pass(self, rank: int) -> None:
        """Hand the token to the next rank still running."""
        for k in range(1, self.n + 1):
            r = (rank + k) % self.n
            if not self.done[r]:
                self.turn = r
                break
        self.cond.notify_all()

    def _await_turn(self, rank: int) -> None:
        deadline = time.monotonic() + self.timeout
        while self.turn != rank:
            if self.broken:
                raise ShardError(f"shard {rank}: {self.broken}")
            left = deadline - time.monotonic()
            if left <= 0:
                self.broken = (f"a wait at the rendezvous exceeded "
                               f"{self.timeout} s")
                self.cond.notify_all()
                raise ShardError(f"shard {rank}: {self.broken}")
            self.cond.wait(left)
        if self.broken:
            raise ShardError(f"shard {rank}: {self.broken}")

    def enter(self, rank: int) -> None:
        """A shard thread's start: wait for its first turn."""
        with self.cond:
            self._await_turn(rank)

    def wait(self, rank: int) -> None:
        """The barrier: pass the token on and wait for it to come back."""
        t0 = time.perf_counter()
        with self.cond:
            self.arrived[rank] += 1
            k = self.arrived[rank]
            self._pass(rank)
            self._await_turn(rank)
            lag = [r for r in range(self.n) if self.arrived[r] < k]
            if lag:
                self.broken = (f"shards {lag} finished without reaching "
                               f"barrier {k}")
                self.cond.notify_all()
                raise ShardError(f"shard {rank}: {self.broken}")
        self.wait_s[rank] += time.perf_counter() - t0

    def finish(self, rank: int) -> None:
        """A shard thread's end: its turns are over."""
        with self.cond:
            self.done[rank] = True
            if self.turn == rank:
                self._pass(rank)

    def abort(self, rank: int, error: BaseException) -> None:
        """A shard failed: every shard that waits raises."""
        with self.cond:
            if not self.broken:
                self.broken = f"shard {rank} failed ({error!r})"
            self.done[rank] = True
            self.cond.notify_all()


def _to(payload, device):
    if payload is None:
        return None
    if isinstance(payload, torch.Tensor):
        return payload if payload.device == device else payload.to(device)
    return tuple(_to(p, device) for p in payload)


class ShardComm:
    """The exchange of one shard of a ``(gpz, gpy, gpx)`` mesh.

    ``shard`` = (sx, sy, sz); its rank is ``sx + gpx*(sy + gpy*sz)``.
    Faces of a sharded axis are joined to the neighbor shard (the JAX
    package's ``lax.ppermute`` ring: a high face receives from shard s+1,
    a low face from s-1, a ``join_domain`` face from ``join[face][s]``);
    on a non-periodic axis the outermost shards' outer faces receive the
    wrapped payload too, and the callers take their local boundary there
    (:meth:`is_global_boundary`).  An unsharded axis behaves as in
    :class:`LocalComm`.

    Payload tensors must not be written after they are posted: a
    neighbor on the same device reads them in place."""

    def __init__(self, g: Grid, shard, rendezvous: Rendezvous, device):
        self.g = g
        self.shard = tuple(int(s) for s in shard)
        sx, sy, sz = self.shard
        self.rank = sx + g.gpx * (sy + g.gpy * sz)
        self.rv = rendezvous
        self.device = None if device is None else torch.device(device)

    def _shards(self, ax: int) -> int:
        return (self.g.gpx, self.g.gpy, self.g.gpz)[ax]

    def joined(self, face: int) -> bool:
        if self._shards(FACE_AXIS[face]) > 1:
            return True
        return self.g.fbc[face] == PERIODIC_FIELDS

    def is_global_boundary(self, face: int) -> bool:
        """This shard's face lies on the global domain boundary of a
        non-periodic axis, where the local boundary condition applies
        (``vpic_tpu/comm/facecomm.py:68-83``).  Faces wired by
        join_domain are interior everywhere."""
        if self.g.join[face] is not None:
            return False
        if self.g.fbc[face] == PERIODIC_FIELDS:
            return False
        ax = FACE_AXIS[face]
        n = self._shards(ax)
        if n == 1:
            return True
        s = self.shard[ax]
        return s == 0 if FACE_DIR[face] < 0 else s == n - 1

    def source_rank(self, face: int) -> int:
        """The rank whose face-``OPP[face]`` payload arrives at ``face``
        (the pairing of ``vpic_tpu/comm/facecomm.py:89-115``)."""
        ax = FACE_AXIS[face]
        n = self._shards(ax)
        s = self.shard[ax]
        join = self.g.join[face]
        if join is not None:
            src = join[s]
        elif FACE_DIR[face] > 0:
            src = (s + 1) % n
        else:
            src = (s - 1) % n
        coords = list(self.shard)
        coords[ax] = src
        return coords[0] + self.g.gpx * (coords[1] + self.g.gpy * coords[2])

    def exchange(self, payloads: dict) -> dict:
        """``{face: payload}`` (a tensor or a tuple of tensors) ->
        ``{face: received}``; every shard must call it with the same
        faces."""
        remote = [f for f in payloads
                  if self._shards(FACE_AXIS[f]) > 1]
        if remote:
            self.rv.slots[self.rank] = payloads
            self.rv.wait(self.rank)
        recv = {}
        for f in payloads:
            if not self.joined(f):
                recv[f] = None
            elif f not in remote:
                recv[f] = payloads[OPP[f]]
            else:
                recv[f] = _to(self.rv.slots[self.source_rank(f)][OPP[f]],
                              self.device)
        if remote:
            self.rv.wait(self.rank)
        return recv

    def allsum(self, x):
        """The sum over every shard of a 0-d tensor (or a float), in
        float64 and in rank order, so that every shard gets the same value
        and a run repeats bit for bit (mp_allsum_d); ``x`` itself on one
        shard."""
        if self.rv.n == 1:
            return x
        self.rv.slots[self.rank] = x
        self.rv.wait(self.rank)
        total = None
        for v in self.rv.slots:
            v = torch.as_tensor(v, dtype=torch.float64).to(self.device)
            total = v if total is None else total + v
        self.rv.wait(self.rank)
        return total


class LocalComm(ShardComm):
    """The exchange of an unsharded grid: the one shard of its own
    rendezvous."""

    def __init__(self, g: Grid, device=None):
        if g.is_multishard:
            raise ValueError("a sharded grid takes one ShardComm per shard "
                             "(engine/distributed.py)")
        super().__init__(g, (0, 0, 0), Rendezvous(1), device)


_current = threading.local()


@contextlib.contextmanager
def bound(comm):
    """``comm`` as the calling thread's exchange (:func:`current`) for the
    block: the step binds its shard's comm around the deck's injection
    hook, whose injector places lanes in that shard's box."""
    prev = current()
    _current.comm = comm
    try:
        yield comm
    finally:
        _current.comm = prev


def current():
    """The comm bound by :func:`bound` in this thread, or None."""
    return getattr(_current, "comm", None)
