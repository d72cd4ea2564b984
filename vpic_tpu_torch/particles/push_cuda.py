"""The hand-written CUDA push+walk+deposit kernel (``csrc/push_walk.cu``),
its wrappers, and the build of every kernel of the package.

:func:`advance_p`, :func:`advance_p_packed` and :func:`streak_walk` take
the arguments and give the results of their plain versions in ``push.py``.
For tensors on the CPU they call the plain version; for CUDA tensors they
launch the kernels, and a build or launch failure raises.  There is no
other fallback.

Every ``csrc/*.cu`` is built at first use with ``nvcc`` (one compiler
process per source, started together, then one link) into one shared
library with a plain C interface under ``vpic_tpu_torch/_build``, loaded
with ctypes and rebuilt when the hash of a source or of a header
(``csrc/*.cuh``) changes.  Nothing is built
when this module is imported.

``launches`` counts the kernel launches of each entry: a run can show that
its main path went through the kernel.

A call launches three kernels: the scale kernel (2^S of the fixed-point
deposit, from max|q|), the push+walk kernel, and ``acc_unfix`` (acc + the
fixed-point sums, which it clears).  Their scratch (the int64 accumulator,
the scale and the lane counters) is allocated once per (device, nv,
stream) and left zero by each call, so a call allocates only its outputs.

Several shards may call from their own threads (``engine/distributed.py``).
Every shard launches on its device's current stream, so calls on one
device share one stream, which orders them: the scratch of a (device,
nv, stream) serves each call in turn.  ``_lock`` makes the build, the
scratch's creation, the launch counts and the enqueue of a call's
kernels together with the reads of its lane counters one step that no
other thread interleaves.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

from ..core.types import Grid, PackedSpecies, SpeciesState
from . import push as plain
from .push import WalkState, push_params, segment_cap

PKG_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xcompiler", "-fPIC", "-Xptxas=-v")
NVCC_LINK_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-shared")

launches = {"push": 0, "walk_only": 0}
_lock = threading.RLock()

_POINTERS = ("x", "y", "z", "vox", "ux", "uy", "uz", "q", "rx", "ry", "rz",
             "pcode", "active", "np", "interp", "neighbor", "scale",
             "x_out", "y_out", "z_out", "vox_out", "ux_out", "uy_out",
             "uz_out", "rx_out", "ry_out", "rz_out", "pcode_out", "acc_fix",
             "counters")


class _PushArgs(ctypes.Structure):
    """Mirror of ``struct PushArgs`` in csrc/push_walk.cu."""
    _fields_ = ([(k, ctypes.c_void_p) for k in _POINTERS]
                + [(k, ctypes.c_int) for k in ("n", "walk_only", "seg_cap")]
                + [(k, ctypes.c_float)
                   for k in ("qdt_2mc", "cdt_dx", "cdt_dy", "cdt_dz")])


_lib = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on "
                           "PATH to build the CUDA kernels")
    return path


def library_path() -> Path:
    """Where the kernels' shared library for the current sources lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS + NVCC_LINK_FLAGS).encode())
    for src in sorted(CSRC_DIR.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libvpic_kernels_{h.hexdigest()[:16]}.so"


def _compile(so: Path) -> None:
    """One ``nvcc -c`` per source, all started together, then one link.
    Every compiler process is waited for before a failure is raised."""
    nvcc = _nvcc()
    srcs = sorted(CSRC_DIR.glob("*.cu"))
    stem = f"{so.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{stem}.{s.stem}.o" for s in srcs]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", str(s), "-o", str(o)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for s, o in zip(srcs, objs)]
    logs, failed = [], []
    for s, p in zip(srcs, procs):
        out, err = p.communicate()
        logs.append(f"== {s.name}\n{out}{err}")
        if p.returncode != 0:
            failed.append(f"nvcc failed on {s.name} ({p.returncode}):\n{err}")
    try:
        if failed:
            raise RuntimeError("\n".join(failed))
        tmp = so.with_name(f"{stem}.tmp")
        r = subprocess.run([nvcc, *NVCC_LINK_FLAGS, "-o", str(tmp),
                            *(str(o) for o in objs)],
                           capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({r.returncode}):\n"
                               f"{r.stderr}")
        so.with_suffix(".log").write_text("\n".join(logs))
        os.replace(tmp, so)
    finally:
        for o in objs:
            o.unlink(missing_ok=True)


def build() -> ctypes.CDLL:
    """Build (if the sources changed) and load the kernels' library.  The
    compiler's resource report is kept beside it in ``<library>.log``."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = _load()
    return _lib


def _load() -> ctypes.CDLL:
    so = library_path()
    if not so.exists():
        BUILD_DIR.mkdir(exist_ok=True)
        _compile(so)
    lib = ctypes.CDLL(str(so))
    lib.vpic_push_args_size.argtypes = []
    lib.vpic_push_args_size.restype = ctypes.c_int
    lib.vpic_push_walk.argtypes = [ctypes.POINTER(_PushArgs), ctypes.c_void_p]
    lib.vpic_push_walk.restype = ctypes.c_int
    lib.vpic_acc_unfix.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int,
                                                           ctypes.c_void_p]
    lib.vpic_acc_unfix.restype = ctypes.c_int
    lib.vpic_fixed_scale.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                     ctypes.c_int, ctypes.c_void_p,
                                     ctypes.c_void_p, ctypes.c_void_p]
    lib.vpic_fixed_scale.restype = ctypes.c_int
    if lib.vpic_push_args_size() != ctypes.sizeof(_PushArgs):
        raise RuntimeError("PushArgs layout differs between push_walk.cu "
                           "and push_cuda.py")
    return lib


def check_tensor(name, t, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


def cuda_device(t: torch.Tensor) -> torch.device:
    if t.device.type != "cuda":
        raise ValueError(f"the CUDA kernel takes CUDA tensors, got "
                         f"{t.device}")
    return t.device


_scratch: dict = {}


def _scratch_for(device, nv: int, stream: int):
    """(fix, work, scale) of the calls on ``stream``: the (nv, 12) int64
    fixed-point accumulator, the scale kernel's four int32 work words (its
    max|q| and block ticket, then the [exhausted, stopped] lane counters)
    and 2^S.  Zero between calls: the scale kernel and ``acc_unfix`` clear
    what the call used."""
    key = (device, nv, stream)
    with _lock:
        if key not in _scratch:
            _scratch[key] = (
                torch.zeros((nv, 12), dtype=torch.int64, device=device),
                torch.zeros((4,), dtype=torch.int32, device=device),
                torch.zeros((), dtype=torch.float64, device=device))
        return _scratch[key]


_OUTPUTS = ("x_out", "y_out", "z_out", "vox_out", "ux_out", "uy_out",
            "uz_out", "rx_out", "ry_out", "rz_out", "pcode_out")


def _run(inputs: dict, n: int, walk_only: int, seg_cap: int, params,
         g: Grid, acc, neighbor, device, out=None):
    """Check the grid-shaped arguments, allocate the outputs not given in
    ``out``, and launch the scale kernel, the walk kernel and acc +
    fix/scale on the current stream.  Returns (outputs, new acc,
    [exhausted, stopped] lane counters); the counters are scratch that the
    next call on the stream overwrites.  The caller holds ``_lock``."""
    check_tensor("acc", acc, torch.float32, (g.nv, 12), device)
    check_tensor("neighbor", neighbor, torch.int32, (g.nv, 6), device)
    if n >= 2 ** 31 or 12 * g.nv >= 2 ** 31:
        raise ValueError("the kernel indexes with 32-bit slot counts")
    out = dict(out or {})
    for k in _OUTPUTS:
        dtype = (torch.int32 if k in ("vox_out", "pcode_out")
                 else torch.float32)
        if k in out:
            check_tensor(k, out[k], dtype, (n,), device)
        else:
            out[k] = torch.empty((n,), device=device, dtype=dtype)
    lib = build()
    stream = torch.cuda.current_stream(device).cuda_stream
    key = (device, g.nv, stream)
    fix, work, scale = _scratch_for(*key)
    counters = work[2:]
    ptr = dict.fromkeys(_POINTERS, 0)
    ptr.update(inputs, neighbor=neighbor, scale=scale, acc_fix=fix,
               counters=counters, **out)
    args = _PushArgs(*(p if isinstance(p, int) else p.data_ptr()
                       for p in (ptr[k] for k in _POINTERS)),
                     n, walk_only, seg_cap, *params)
    acc_out = torch.empty_like(acc)

    def check(err, name):
        if err != 0:
            # a launch that did not run leaves the scratch not zero
            del _scratch[key]
            raise RuntimeError(f"{name} kernel launch failed: cudaError "
                               f"{err}")

    check(lib.vpic_fixed_scale(inputs["q"].data_ptr(), n, seg_cap,
                               work.data_ptr(), scale.data_ptr(), stream),
          "fixed_scale")
    check(lib.vpic_push_walk(ctypes.byref(args), stream), "push_walk")
    check(lib.vpic_acc_unfix(fix.data_ptr(), scale.data_ptr(),
                             acc.data_ptr(), acc_out.data_ptr(), acc.numel(),
                             stream), "acc_unfix")
    return out, acc_out, counters


def _push(inputs: dict, n: int, sp, g: Grid, acc, neighbor, n_walk, device,
          out=None):
    """The push entry of the kernel; counts the launch."""
    check_tensor("interp", inputs["interp"], torch.float32, (g.nv, 18),
                 device)
    check_tensor("np", inputs["np"], torch.int32, (), device)
    with _lock:
        res = _run(inputs, n, 0, segment_cap(n_walk), push_params(sp, g), g,
                   acc, neighbor, device, out)
        launches["push"] += 1
    return res


def advance_p(sp: SpeciesState, interp, acc, neighbor, g: Grid,
              n_walk: int = 4, fused: bool = True,
              count_pending: bool = True):
    """Kernel version of :func:`push.advance_p`: the same results.
    ``fused``: the push+walk kernel, which agrees with the plain version
    exactly on voxels, ``pc`` and the particle floats, and on ``acc`` to
    float32 roundoff (bit for bit with the fixed-point twin
    :func:`push.advance_p_fixed`).  Unfused: the plain push math and
    segment 1 over every slot, segment 1's currents through the deposit
    kernel (``deposit_cuda``), then the lanes still moving through the
    walk_only entry (:func:`streak_walk`).  The JAX package takes its
    deposit kernel only under ``sorted_deposit``; this one is exact for
    lanes in any order, so the unfused path always takes it, and
    ``sorted_deposit`` only sets the sort cadence (``engine/step.py``).
    ``count_pending``: the lanes left exhausted or stopped by a boundary
    code add to ``nm``; without it they are left to the boundary rounds
    (their ``pc`` and remaining displacement are in the outputs either
    way)."""
    if sp.dx.device.type == "cpu":
        return plain.advance_p(sp, interp, acc, neighbor, g, n_walk=n_walk,
                               count_pending=count_pending)
    device = cuda_device(sp.dx)
    n = sp.max_np
    for k in ("dx", "dy", "dz", "ux", "uy", "uz", "q"):
        check_tensor(k, getattr(sp, k), torch.float32, (n,), device)
    check_tensor("i", sp.i, torch.int32, (n,), device)
    if n == 0:
        return sp, acc
    if not fused:
        # imported here: deposit_cuda builds its kernel through this module
        from . import deposit_cuda
        return plain.advance_p_steps(sp, interp, acc, neighbor, g, n_walk,
                                     deposit_cuda.deposit_sorted_into,
                                     streak_walk, count_pending)

    inputs = dict(x=sp.dx, y=sp.dy, z=sp.dz, vox=sp.i, ux=sp.ux, uy=sp.uy,
                  uz=sp.uz, q=sp.q, np=sp.np, interp=interp)
    with _lock:
        out, acc, counters = _push(inputs, n, sp, g, acc, neighbor, n_walk,
                                   device)
        # pending lanes (exhausted + stopped) are drops unless boundary
        # rounds follow, as in the plain version
        nm = sp.nm + counters[0] + counters[1] if count_pending else sp.nm
    sp = sp.replace(dx=out["x_out"], dy=out["y_out"], dz=out["z_out"],
                    i=out["vox_out"], ux=out["ux_out"], uy=out["uy_out"],
                    uz=out["uz_out"], mdx=out["rx_out"], mdy=out["ry_out"],
                    mdz=out["rz_out"], pc=out["pcode_out"], nm=nm)
    return sp, acc


def advance_p_packed(psp: PackedSpecies, interp, acc, neighbor, g: Grid,
                     n_walk: int = 4):
    """Kernel version of :func:`push.advance_p_packed`: the push+walk
    kernel reads rows 0-6 of ``psp.pk`` in place and writes rows 0-5 of
    the new block.  Row 7 holds voxels as float32 and the kernel takes and
    gives int32, so the voxel row is converted before and after the launch
    (two elementwise passes over n words; the kernel keeps one voxel
    type)."""
    if psp.pk.device.type == "cpu":
        return plain.advance_p_packed(psp, interp, acc, neighbor, g,
                                      n_walk=n_walk)
    device = cuda_device(psp.pk)
    n = psp.max_np
    check_tensor("pk", psp.pk, torch.float32, (8, n), device)
    if n == 0:
        return psp, acc
    p = psp.pk
    pk = torch.empty_like(p)
    inputs = dict(x=p[0], y=p[1], z=p[2], ux=p[3], uy=p[4], uz=p[5], q=p[6],
                  vox=(p[7] + 0.5).to(torch.int32), np=psp.np, interp=interp)
    out = dict(x_out=pk[0], y_out=pk[1], z_out=pk[2], ux_out=pk[3],
               uy_out=pk[4], uz_out=pk[5])
    with _lock:
        out, acc, counters = _push(inputs, n, psp, g, acc, neighbor, n_walk,
                                   device, out)
        nm = psp.nm + counters[0] + counters[1]
    pk[6].copy_(p[6])
    pk[7].copy_(out["vox_out"])
    return psp.replace(pk=pk, nm=nm), acc


def streak_walk(st: WalkState, acc, neighbor, g: Grid, n_iter: int):
    """Kernel version of :func:`push.streak_walk` (the walk_only entry):
    continue the active lanes from their remaining displacement for up to
    ``4*n_iter + 8`` segments."""
    if st.x.device.type == "cpu":
        return plain.streak_walk(st, acc, neighbor, g, n_iter)
    device = cuda_device(st.x)
    n = st.x.shape[0]
    for k in ("x", "y", "z", "ux", "uy", "uz", "rx", "ry", "rz", "q"):
        check_tensor(k, getattr(st, k), torch.float32, (n,), device)
    check_tensor("vox", st.vox, torch.int32, (n,), device)
    check_tensor("pcode", st.pcode, torch.int32, (n,), device)
    check_tensor("active", st.active, torch.bool, (n,), device)
    if n == 0:
        return st, acc

    inputs = {k: getattr(st, k) for k in ("x", "y", "z", "vox", "ux", "uy",
                                          "uz", "q", "rx", "ry", "rz",
                                          "pcode", "active")}
    with _lock:
        out, acc, _ = _run(inputs, n, 1, 4 * n_iter + 8, (0.0,) * 4, g,
                           acc, neighbor, device)
        launches["walk_only"] += 1

    st = WalkState(x=out["x_out"], y=out["y_out"], z=out["z_out"],
                   vox=out["vox_out"], ux=out["ux_out"], uy=out["uy_out"],
                   uz=out["uz_out"], rx=out["rx_out"], ry=out["ry_out"],
                   rz=out["rz_out"], q=st.q, pcode=out["pcode_out"],
                   active=torch.zeros_like(st.active))
    return st, acc


def reset_launch_counts() -> None:
    for k in launches:
        launches[k] = 0
