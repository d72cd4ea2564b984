"""The hand-written CUDA kernels of the merge re-sort
(``csrc/merge_assemble.cu``: the mark pass, the tables and the assembly)
and their wrappers.

:func:`mark` and :func:`assemble` take the arguments and give the results
of their plain versions in ``sort.py``: for tensors on the CPU they call
the plain version; for CUDA tensors they launch the kernels (built with
the package's other kernels by ``push_cuda.build``), and a build or launch
failure raises.  :func:`assemble` launches two: the tables, then the
assembly that reads them.  The outputs equal the plain
versions' bit for bit (the slots past the movers that :func:`mark`
writes, and the slots no lane reaches after an anomaly, are unspecified
in both).

:func:`merge_sort_packed` is ``sort.merge_sort_packed`` with these
kernels: the mark pass, one host read, then the plan and the assembly, or
the full sort.  ``launches`` counts each kernel's launches and
``sort_counts[species]`` the fast (merge) and slow (full) sorts of each
named species, so no fallback goes unseen.

The kernels' scratch (the mark pass's look-back words and both kernels'
counters) is kept per (device, stream); the kernels leave the counters
zero, and each mark launch tags its look-back words with a new epoch, so
no call clears anything.
"""

from __future__ import annotations

import ctypes

import torch

from . import sort as plain
from .push_cuda import build, check_tensor, cuda_device

launches = {"merge_mark": 0, "merge_tables": 0, "merge_assemble": 0}
sort_counts: dict = {}

_MARK_POINTERS = ("pk", "np", "key0", "ctot", "res_base", "res_key",
                  "mov_lane", "mov_key", "mov_old", "info", "status", "work")
_TABLES_POINTERS = ("key_ms", "mov_old", "ctot", "cum_res", "cum_mov",
                    "cum_tot")
_ASSEMBLE_POINTERS = ("pk", "np", "key0", "res_base", "res_key", "cum_res",
                      "cum_mov", "key_ms", "order", "mov_lane", "out",
                      "key0_out", "anomaly", "work")


class _MarkArgs(ctypes.Structure):
    """Mirror of ``struct MarkArgs`` in csrc/merge_assemble.cu."""
    _fields_ = ([(k, ctypes.c_void_p) for k in _MARK_POINTERS]
                + [(k, ctypes.c_int)
                   for k in ("n", "nvk", "m_cap", "epoch", "vec")])


class _TablesArgs(ctypes.Structure):
    """Mirror of ``struct TablesArgs`` in csrc/merge_assemble.cu."""
    _fields_ = ([(k, ctypes.c_void_p) for k in _TABLES_POINTERS]
                + [(k, ctypes.c_int) for k in ("n_m", "keys")])


class _AssembleArgs(ctypes.Structure):
    """Mirror of ``struct AssembleArgs`` in csrc/merge_assemble.cu."""
    _fields_ = ([(k, ctypes.c_void_p) for k in _ASSEMBLE_POINTERS]
                + [(k, ctypes.c_int) for k in ("n", "nvk", "n_m", "vec")])


_bound = None


def _lib():
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
        lib.vpic_merge_mark.restype = ctypes.c_int
        lib.vpic_merge_assemble.restype = ctypes.c_int
        lib.vpic_merge_tile.argtypes, lib.vpic_merge_tile.restype = \
            [], ctypes.c_int
        if lib.vpic_merge_tile() != plain.TILE:
            raise RuntimeError("the tile differs between merge_assemble.cu "
                               "and sort.py")
        _bound = lib
    return _bound


_EPOCHS = 2 ** 30   # the epoch field of a look-back word
_scratch: dict = {}


def _scratch_for(device, stream: int, tiles: int) -> dict:
    """The scratch of the calls on ``stream``: ``status`` (the look-back
    words, tagged with ``epoch``) and ``work`` (the mark pass's ticket and
    range count, the assembly's block ticket and bad-lane count), zero
    when made and left zero by the kernels."""
    key = (device, stream)
    s = _scratch.get(key)
    if s is None or s["status"].numel() < tiles or s["epoch"] >= _EPOCHS:
        s = dict(status=torch.zeros((tiles,), dtype=torch.int64,
                                    device=device),
                 work=torch.zeros((4,), dtype=torch.int32, device=device),
                 epoch=0)
        _scratch[key] = s
    return s


def _launch(err, device, stream, names):
    """Raise if the entry's launches failed, else count them."""
    if err != 0:
        # a launch that did not run leaves the counters not zero
        _scratch.pop((device, stream), None)
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
    """Kernel version of :func:`sort.mark`."""
    if pk.device.type == "cpu":
        return plain.mark(pk, np_, key0, ctot, nvk, m_cap)
    device, n = _check_block(pk, np_, key0, nvk)
    check_tensor("ctot", ctot, torch.int32, (nvk + 3,), device)
    if not 0 <= m_cap <= n:
        raise ValueError(f"m_cap {m_cap} outside [0, {n}]")
    tiles = -(-n // plain.TILE)
    marks = plain.Marks(*_int32(device, tiles, tiles, m_cap, m_cap, m_cap, 4))
    lib = _lib()
    stream = torch.cuda.current_stream(device).cuda_stream
    s = _scratch_for(device, stream, tiles)
    s["epoch"] += 1
    ptr = dict(marks._asdict(), pk=pk, np=np_, key0=key0, ctot=ctot,
               status=s["status"], work=s["work"])
    args = _MarkArgs(*(ptr[k].data_ptr() for k in _MARK_POINTERS), n, nvk,
                     m_cap, s["epoch"], _vec(n, pk, key0))
    _launch(lib.vpic_merge_mark(ctypes.byref(args), stream), device, stream,
            ("merge_mark",))
    return marks


def assemble(pk, np_, key0, ctot, marks: plain.Marks, plan: plain.MergePlan,
             nvk: int) -> plain.Assembled:
    """Kernel version of :func:`sort.assemble`: the tables kernel, then the
    assembly kernel, from one call."""
    if pk.device.type == "cpu":
        return plain.assemble(pk, np_, key0, ctot, marks, plan, nvk)
    device, n = _check_block(pk, np_, key0, nvk)
    n_m = plan.key_ms.shape[0]
    check_tensor("ctot", ctot, torch.int32, (nvk + 3,), device)
    for k in ("res_base", "res_key"):
        check_tensor(k, getattr(marks, k), torch.int32,
                     (-(-n // plain.TILE),), device)
    check_tensor("key_ms", plan.key_ms, torch.int32, (n_m,), device)
    check_tensor("order", plan.order, torch.int64, (n_m,), device)
    for k in ("mov_lane", "mov_old"):
        t = getattr(marks, k)
        check_tensor(k, t, torch.int32, t.shape, device)
        if t.shape[0] < n_m:
            raise ValueError(f"{n_m} movers, {t.shape[0]} marked")

    out = torch.empty((8, n), dtype=torch.float32, device=device)
    key0_out, cum_res, cum_mov, cum_tot, anomaly = _int32(
        device, n, nvk + 3, nvk + 3, nvk + 3, 1)
    res = plain.Assembled(pk=out, key0=key0_out, cum_res=cum_res,
                          cum_mov=cum_mov, cum_tot=cum_tot,
                          anomaly=anomaly.view(()))
    lib = _lib()
    stream = torch.cuda.current_stream(device).cuda_stream
    s = _scratch_for(device, stream, 0)
    ptr = dict(res._asdict(), pk=pk, np=np_, key0=key0, ctot=ctot,
               res_base=marks.res_base, res_key=marks.res_key,
               mov_lane=marks.mov_lane, mov_old=marks.mov_old,
               key_ms=plan.key_ms, order=plan.order, out=out,
               key0_out=key0_out, work=s["work"][2:])
    targs = _TablesArgs(*(ptr[k].data_ptr() for k in _TABLES_POINTERS), n_m,
                        nvk + 3)
    args = _AssembleArgs(*(ptr[k].data_ptr() for k in _ASSEMBLE_POINTERS), n,
                         nvk, n_m, _vec(n, pk, key0))
    _launch(lib.vpic_merge_assemble(ctypes.byref(targs), ctypes.byref(args),
                                    stream),
            device, stream, ("merge_tables", "merge_assemble"))
    return res


def merge_sort_packed(pk, np_, key0, ctot, nvk: int, m_cap: int,
                      species: str | None = None):
    """:func:`sort.merge_sort_packed` with the kernels; counts the sort as
    fast or slow under ``species`` when given."""
    res = plain.merge_sort_packed(pk, np_, key0, ctot, nvk, m_cap,
                                  mark_fn=mark, assemble_fn=assemble)
    if species is not None:
        counts = sort_counts.setdefault(species, {"fast": 0, "slow": 0})
        counts["fast" if res.fast else "slow"] += 1
    return res


def reset_launch_counts() -> None:
    for k in launches:
        launches[k] = 0
    sort_counts.clear()
