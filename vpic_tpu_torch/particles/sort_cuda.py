"""The hand-written CUDA kernels of the merge re-sort
(``csrc/merge_assemble.cu``: the mark pass, the tables and the assembly)
and their wrappers.

:func:`mark`, :func:`assemble` and :func:`gather` take the arguments and
give the results of their plain versions in ``sort.py``: for tensors on
the CPU they call the plain version; for CUDA tensors they launch the
kernels (built with the package's other kernels by ``push_cuda.build``),
and a build or launch failure raises.  :func:`assemble` launches two: the
tables, then the assembly that reads them, which writes the merge where
the mark pass's counts say fast; :func:`gather` launches the assembly
kernel in its gather mode, which writes the full sort's block where they
say slow.  Both write one output buffer set, each only where the decision
is its own.  The outputs equal the plain versions' bit for bit there (the
slots no lane reaches after an anomaly are unspecified in both).

:func:`merge_sort_packed` is ``sort.merge_sort_packed`` with these
kernels: the mark pass, then the decision taken on the card
(``engine/cond.cond``) between the merge (the movers' sort, the tables
and the assembly) and the full sort (its order and the gather); the host
reads nothing and no size depends on the data, so a sort records into a
CUDA graph, where the merge and the full sort are the bodies of
conditional nodes.  ``launches`` counts each kernel's launches: per sort
the mark one; eagerly, where both branches run, the tables one and the
assembly two (the merge and the gather); in a graph's replay the tables
and an assembly per merge kept, a gather per full sort
(``engine/cond.settle``).  Each named species' fast (merge) and slow
(full) sorts are counted on the block's device, from the decision, by a
device addition that a graph replays with the sort; :func:`sort_counts`
reads them, so no fallback goes unseen.

The kernels' scratch (the mark pass's look-back words, its epoch, and both
kernels' counters) is kept per (device, stream, tiles) and never freed
(a conditional body's stream counts as the stream its graph is captured
on, ``engine/cond.home_stream``, whose warm-up made the scratch),
since a captured graph keeps its pointers; the kernels leave the counters
zero, and each mark launch tags its look-back words with an epoch that
the launch before it left in the scratch, so no call clears anything and
a replay moves the epoch on as an eager launch does.
"""

from __future__ import annotations

import ctypes

import torch

from ..engine.cond import home_stream
from . import sort as plain
from .push_cuda import _lock, build, check_tensor, cuda_device

launches = {"merge_mark": 0, "merge_tables": 0, "merge_assemble": 0}
# (species, device) -> (2,) int64 [fast, slow] sorts, on the device
_sort_counters: dict = {}

_MARK_POINTERS = ("pk", "np", "key0", "ctot", "res_base", "res_key",
                  "mov_lane", "mov_key", "mov_old", "info", "status", "work")
_TABLES_POINTERS = ("key_ms", "mov_old", "ctot", "cum_res", "cum_mov",
                    "cum_tot")
_ASSEMBLE_POINTERS = ("pk", "np", "key0", "res_base", "res_key", "cum_res",
                      "cum_mov", "key_ms", "order", "mov_lane", "info",
                      "full_order", "full_key", "out", "key0_out", "anomaly",
                      "work")
# AssembleArgs.mode (csrc/merge_assemble.cu kGather)
_MERGE, _GATHER = 0, 1


class _MarkArgs(ctypes.Structure):
    """Mirror of ``struct MarkArgs`` in csrc/merge_assemble.cu."""
    _fields_ = ([(k, ctypes.c_void_p) for k in _MARK_POINTERS]
                + [(k, ctypes.c_int) for k in ("n", "nvk", "m_cap", "vec")])


class _TablesArgs(ctypes.Structure):
    """Mirror of ``struct TablesArgs`` in csrc/merge_assemble.cu."""
    _fields_ = ([(k, ctypes.c_void_p) for k in _TABLES_POINTERS]
                + [(k, ctypes.c_int) for k in ("slots", "keys")])


class _AssembleArgs(ctypes.Structure):
    """Mirror of ``struct AssembleArgs`` in csrc/merge_assemble.cu."""
    _fields_ = ([(k, ctypes.c_void_p) for k in _ASSEMBLE_POINTERS]
                + [(k, ctypes.c_int) for k in ("n", "nvk", "m_cap", "vec",
                                               "mode")])


_bound = None


def _lib():
    with _lock:
        return _bind()


def _bind():
    global _bound
    if _bound is None:
        lib = build()
        for name, args in (("mark", _MarkArgs), ("tables", _TablesArgs),
                           ("assemble", _AssembleArgs)):
            size = getattr(lib, f"vpic_merge_{name}_args_size")
            size.argtypes, size.restype = [], ctypes.c_int
            if size() != ctypes.sizeof(args):
                raise RuntimeError(f"{args.__name__} differs between "
                                   "merge_assemble.cu and sort_cuda.py")
        lib.vpic_merge_mark.argtypes = [ctypes.POINTER(_MarkArgs),
                                        ctypes.c_void_p]
        lib.vpic_merge_assemble.argtypes = [ctypes.POINTER(_TablesArgs),
                                            ctypes.POINTER(_AssembleArgs),
                                            ctypes.c_void_p]
        lib.vpic_merge_gather.argtypes = [ctypes.POINTER(_AssembleArgs),
                                          ctypes.c_void_p]
        lib.vpic_merge_mark.restype = ctypes.c_int
        lib.vpic_merge_assemble.restype = ctypes.c_int
        lib.vpic_merge_gather.restype = ctypes.c_int
        lib.vpic_merge_tile.argtypes, lib.vpic_merge_tile.restype = \
            [], ctypes.c_int
        if lib.vpic_merge_tile() != plain.TILE:
            raise RuntimeError("the tile differs between merge_assemble.cu "
                               "and sort.py")
        _bound = lib
    return _bound


_scratch: dict = {}


def _scratch_for(device, stream: int, tiles: int):
    """(status, work) of the calls on ``stream`` with ``tiles`` tiles:
    the look-back words and six int32 words, the mark pass's [ticket,
    range count, epoch, done blocks] and the assembly's [done blocks,
    bad lanes]; zero when made, the counters left zero by the kernels.
    Made at a wrapper's first call on the stream (a graph's warm-up runs
    on its capture stream, so not inside the capture) and kept."""
    key = (device, stream, tiles)
    with _lock:
        if key not in _scratch:
            _scratch[key] = (
                torch.zeros((tiles,), dtype=torch.int64, device=device),
                torch.zeros((6,), dtype=torch.int32, device=device))
        return _scratch[key]


def _launch(err, key, names):
    """Raise if the entry's launches failed, else count them."""
    if err != 0:
        # a launch that did not run leaves the counters not zero
        with _lock:
            _scratch.pop(key, None)
        raise RuntimeError(f"{' / '.join(names)} kernel launch failed: "
                           f"cudaError {err}")
    for name in names:
        launches[name] += 1


def _vec(n, *tensors):
    """The kernels' 16-byte loads need aligned rows."""
    return int(n % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in tensors))


def _check_block(pk, np_, key0, nvk):
    device = cuda_device(pk)
    n = pk.shape[1]
    check_tensor("pk", pk, torch.float32, (8, n), device)
    check_tensor("np", np_, torch.int32, (), device)
    check_tensor("key0", key0, torch.int32, (n,), device)
    if not (0 < n and 8 * n < 2 ** 31 and nvk + 3 < 2 ** 31):
        raise ValueError("the kernels take 0 < n lanes and index with "
                         "32-bit counts")
    return device, n


def _int32(device, *sizes):
    """Views of one new int32 buffer (one allocation per call)."""
    buf = torch.empty((sum(sizes),), dtype=torch.int32, device=device)
    return buf.split(sizes)


def mark(pk, np_, key0, ctot, nvk: int, m_cap: int) -> plain.Marks:
    """Kernel version of :func:`sort.mark`: one fill of the mover slots
    with the sentinel, then the mark kernel."""
    if pk.device.type == "cpu":
        return plain.mark(pk, np_, key0, ctot, nvk, m_cap)
    device, n = _check_block(pk, np_, key0, nvk)
    check_tensor("ctot", ctot, torch.int32, (nvk + 3,), device)
    if not 0 <= m_cap <= n:
        raise ValueError(f"m_cap {m_cap} outside [0, {n}]")
    tiles = -(-n // plain.TILE)
    buf = torch.empty((2 * tiles + 3 * m_cap + 4,), dtype=torch.int32,
                      device=device)
    # the mover slots past the movers hold the sentinel (the kernel
    # writes the first min(n_m, m_cap))
    buf[2 * tiles:2 * tiles + 3 * m_cap].fill_(plain.SENTINEL)
    marks = plain.Marks(*buf.split((tiles, tiles, m_cap, m_cap, m_cap, 4)))
    lib = _lib()
    stream = torch.cuda.current_stream(device).cuda_stream
    key = (device, home_stream(stream), tiles)
    status, work = _scratch_for(*key)
    ptr = dict(marks._asdict(), pk=pk, np=np_, key0=key0, ctot=ctot,
               status=status, work=work)
    args = _MarkArgs(*(ptr[k].data_ptr() for k in _MARK_POINTERS), n, nvk,
                     m_cap, _vec(n, pk, key0))
    _launch(lib.vpic_merge_mark(ctypes.byref(args), stream), key,
            ("merge_mark",))
    return marks


def _out_block(out, pk, key0, device, n):
    """The output buffer set (``sort.block_buffers``), made where None,
    checked where given."""
    if out is None:
        return plain.block_buffers(pk, key0)
    check_tensor("out rows", out[0], torch.float32, (8, n), device)
    check_tensor("out key0", out[1], torch.int32, (n,), device)
    return out


def assemble(pk, np_, key0, ctot, marks: plain.Marks, plan: plain.MergePlan,
             nvk: int, m_cap: int, out=None) -> plain.Assembled:
    """Kernel version of :func:`sort.assemble`: the tables kernel, then the
    assembly kernel, from one call.  Both read the mover count and the
    decision from ``marks.info`` on the device; where the decision is
    slow the assembly writes only the anomaly (0)."""
    if pk.device.type == "cpu":
        return plain.assemble(pk, np_, key0, ctot, marks, plan, nvk, m_cap,
                              out)
    device, n = _check_block(pk, np_, key0, nvk)
    check_tensor("ctot", ctot, torch.int32, (nvk + 3,), device)
    tiles = -(-n // plain.TILE)
    for k in ("res_base", "res_key"):
        check_tensor(k, getattr(marks, k), torch.int32, (tiles,), device)
    for k in ("mov_lane", "mov_old"):
        check_tensor(k, getattr(marks, k), torch.int32, (m_cap,), device)
    check_tensor("info", marks.info, torch.int32, (4,), device)
    check_tensor("key_ms", plan.key_ms, torch.int32, (m_cap,), device)
    check_tensor("order", plan.order, torch.int64, (m_cap,), device)
    rows, key0_out = _out_block(out, pk, key0, device, n)
    cum_res, cum_mov, cum_tot, anomaly = _int32(device, nvk + 3, nvk + 3,
                                                nvk + 3, 1)
    res = plain.Assembled(pk=rows, key0=key0_out, cum_res=cum_res,
                          cum_mov=cum_mov, cum_tot=cum_tot,
                          anomaly=anomaly.view(()))
    lib = _lib()
    stream = torch.cuda.current_stream(device).cuda_stream
    key = (device, home_stream(stream), tiles)
    _, work = _scratch_for(*key)
    ptr = dict(res._asdict(), pk=pk, np=np_, key0=key0, ctot=ctot,
               res_base=marks.res_base, res_key=marks.res_key,
               mov_lane=marks.mov_lane, mov_old=marks.mov_old,
               info=marks.info, key_ms=plan.key_ms, order=plan.order,
               out=rows, key0_out=key0_out, work=work[4:])
    targs = _TablesArgs(*(ptr[k].data_ptr() for k in _TABLES_POINTERS),
                        m_cap, nvk + 3)
    args = _AssembleArgs(*(ptr[k].data_ptr() if k in ptr else None
                           for k in _ASSEMBLE_POINTERS), n, nvk, m_cap,
                         _vec(n, pk, key0), _MERGE)
    _launch(lib.vpic_merge_assemble(ctypes.byref(targs), ctypes.byref(args),
                                    stream),
            key, ("merge_tables", "merge_assemble"))
    return res


def gather(pk, np_, full: plain.FullOrder, nvk: int, info, m_cap: int,
           out=None):
    """Kernel version of :func:`sort.gather`: the assembly kernel in its
    gather mode, which reads the decision from ``info`` on the device and
    writes the full sort's block into ``out`` only where it is slow."""
    if pk.device.type == "cpu":
        return plain.gather(pk, np_, full, nvk, info, m_cap, out)
    device, n = _check_block(pk, np_, full.key_s, nvk)
    check_tensor("info", info, torch.int32, (4,), device)
    check_tensor("full order", full.order, torch.int64, (n,), device)
    rows, key0_out = _out_block(out, pk, full.key_s, device, n)
    anomaly = torch.empty((), dtype=torch.int32, device=device)
    tiles = -(-n // plain.TILE)
    lib = _lib()
    stream = torch.cuda.current_stream(device).cuda_stream
    key = (device, home_stream(stream), tiles)
    _, work = _scratch_for(*key)
    ptr = dict(pk=pk, np=np_, info=info, full_order=full.order,
               full_key=full.key_s, out=rows, key0_out=key0_out,
               anomaly=anomaly, work=work[4:])
    args = _AssembleArgs(*(ptr[k].data_ptr() if k in ptr else None
                           for k in _ASSEMBLE_POINTERS), n, nvk, m_cap, 0,
                         _GATHER)
    _launch(lib.vpic_merge_gather(ctypes.byref(args), stream), key,
            ("merge_assemble",))
    return rows, key0_out, anomaly


def merge_sort_packed(pk, np_, key0, ctot, nvk: int, m_cap: int,
                      species: str | None = None):
    """:func:`sort.merge_sort_packed` with the kernels; counts the sort as
    fast or slow under ``species`` when given, on the device."""
    res = plain.merge_sort_packed(pk, np_, key0, ctot, nvk, m_cap,
                                  mark_fn=mark, assemble_fn=assemble,
                                  gather_fn=gather)
    if species is not None:
        _count_sort(species, res.fast)
    return res


def _count_sort(species: str, fast) -> None:
    """Add the 0-d bool ``fast`` to the species' [fast, slow] counter on
    its device (made at the first count, outside any capture: a graph's
    warm-up sorts first)."""
    key = (species, fast.device)
    with _lock:
        c = _sort_counters.get(key)
        if c is None:
            c = _sort_counters[key] = torch.zeros((2,), dtype=torch.int64,
                                                  device=fast.device)
    c.add_(torch.stack([fast, ~fast]).to(torch.int64))


def sort_counts() -> dict:
    """``{species: {"fast": f, "slow": s}}``: each species' sorts since the
    last :func:`reset_launch_counts`, summed over its devices (one host
    read per counter; the species that did not sort are left out)."""
    out: dict = {}
    with _lock:
        items = list(_sort_counters.items())
    for (species, _), c in items:
        fast, slow = c.tolist()
        if fast or slow:
            d = out.setdefault(species, {"fast": 0, "slow": 0})
            d["fast"] += fast
            d["slow"] += slow
    return out


def sort_counters() -> dict:
    """The device counters, ``(species, device) -> (2,) int64``: the
    graph runner copies them around a warm-up (``engine/graphs.py``)."""
    with _lock:
        return dict(_sort_counters)


def reset_launch_counts() -> None:
    """Zero the launch counts and the sort counters, the latter in place:
    a captured graph keeps adding to the same tensors."""
    for k in launches:
        launches[k] = 0
    with _lock:
        for c in _sort_counters.values():
            c.zero_()
