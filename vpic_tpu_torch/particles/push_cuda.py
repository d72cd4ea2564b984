"""The hand-written CUDA push+walk+deposit kernel (``csrc/push_walk.cu``)
and its wrappers.

:func:`advance_p` and :func:`streak_walk` take the arguments and give the
results of their plain versions in ``push.py``.  For tensors on the CPU
they call the plain version; for CUDA tensors they launch the kernel, and a
build or launch failure raises.  There is no other fallback.

The kernel is built at first use with ``nvcc`` into ``vpic_tpu_torch/_build``
(a shared library with a plain C interface, loaded with ctypes) and rebuilt
when a source's hash changes.  Nothing is built when this module is
imported.

``launches`` counts the kernel launches of each entry: a run can show that
its main path went through the kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

from ..core.types import Grid, SpeciesState
from . import push as plain
from .push import WalkState, push_params

PKG_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas=-v")

launches = {"push": 0, "walk_only": 0}

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
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC_DIR.glob("*.cu")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libvpic_kernels_{h.hexdigest()[:16]}.so"


def build() -> ctypes.CDLL:
    """Build (if the sources changed) and load the kernels' library.  The
    compiler's resource report is kept beside it in ``<library>.log``."""
    global _lib
    if _lib is not None:
        return _lib
    so = library_path()
    if not so.exists():
        BUILD_DIR.mkdir(exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               *(str(s) for s in sorted(CSRC_DIR.glob("*.cu")))]
        r = subprocess.run(cmd, capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"nvcc failed ({r.returncode}):\n{r.stderr}")
        so.with_suffix(".log").write_text(r.stdout + r.stderr)
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    lib.vpic_push_args_size.argtypes = []
    lib.vpic_push_args_size.restype = ctypes.c_int
    lib.vpic_push_walk.argtypes = [ctypes.POINTER(_PushArgs), ctypes.c_void_p]
    lib.vpic_push_walk.restype = ctypes.c_int
    lib.vpic_acc_unfix.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int,
                                                           ctypes.c_void_p]
    lib.vpic_acc_unfix.restype = ctypes.c_int
    if lib.vpic_push_args_size() != ctypes.sizeof(_PushArgs):
        raise RuntimeError("PushArgs layout differs between push_walk.cu "
                           "and push_cuda.py")
    _lib = lib
    return lib


def _check(name, t, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


def _cuda_device(t: torch.Tensor) -> torch.device:
    if t.device.type != "cuda":
        raise ValueError(f"the CUDA kernel takes CUDA tensors, got "
                         f"{t.device}")
    return t.device


def _fixed_scale(q, seg_cap: int, n: int):
    """2^S as a float64 device scalar, with 5*max|q| * seg_cap * n < 2^62:
    every voxel's fixed-point sum fits an int64.  Computed on the device
    so the push never waits for the host."""
    bound = 5.0 * q.abs().max().to(torch.float64) * float(seg_cap * n)
    s = torch.floor(62.0 - torch.log2(bound)).clamp(-200.0, 200.0)
    return torch.exp2(s)


_OUTPUTS = ("x_out", "y_out", "z_out", "vox_out", "ux_out", "uy_out",
            "uz_out", "rx_out", "ry_out", "rz_out", "pcode_out")


def _run(inputs: dict, n: int, walk_only: int, seg_cap: int, params,
         g: Grid, acc, neighbor, device):
    """Check the grid-shaped arguments, allocate the outputs and scratch,
    launch the walk kernel on the current stream and then acc + fix/scale.
    Returns (outputs, new acc, [exhausted, stopped] lane counters)."""
    _check("acc", acc, torch.float32, (g.nv, 12), device)
    _check("neighbor", neighbor, torch.int32, (g.nv, 6), device)
    if n >= 2 ** 31 or 12 * g.nv >= 2 ** 31:
        raise ValueError("the kernel indexes with 32-bit slot counts")
    fix = torch.zeros((g.nv, 12), dtype=torch.int64, device=device)
    counters = torch.zeros((2,), dtype=torch.int32, device=device)
    scale = _fixed_scale(inputs["q"], seg_cap, n)
    out = {k: torch.empty((n,), device=device,
                          dtype=torch.int32 if k in ("vox_out", "pcode_out")
                          else torch.float32)
           for k in _OUTPUTS}
    ptr = dict.fromkeys(_POINTERS, 0)
    ptr.update(inputs, neighbor=neighbor, scale=scale, acc_fix=fix,
               counters=counters, **out)
    args = _PushArgs(*(p if isinstance(p, int) else p.data_ptr()
                       for p in (ptr[k] for k in _POINTERS)),
                     n, walk_only, seg_cap, *params)

    lib = build()
    stream = torch.cuda.current_stream(device).cuda_stream
    err = lib.vpic_push_walk(ctypes.byref(args), stream)
    if err != 0:
        raise RuntimeError(f"push_walk kernel launch failed: cudaError {err}")
    acc_out = torch.empty_like(acc)
    err = lib.vpic_acc_unfix(fix.data_ptr(), scale.data_ptr(),
                             acc.data_ptr(), acc_out.data_ptr(),
                             acc.numel(), stream)
    if err != 0:
        raise RuntimeError(f"acc_unfix kernel launch failed: cudaError {err}")
    return out, acc_out, counters


def advance_p(sp: SpeciesState, interp, acc, neighbor, g: Grid,
              n_walk: int = 4):
    """Kernel version of :func:`push.advance_p`: same arguments, same
    results.  On voxels, ``pc`` and the particle floats it agrees with the
    plain version exactly; on ``acc`` to float32 roundoff."""
    if sp.dx.device.type == "cpu":
        return plain.advance_p(sp, interp, acc, neighbor, g, n_walk=n_walk)
    device = _cuda_device(sp.dx)
    n = sp.max_np
    for k in ("dx", "dy", "dz", "ux", "uy", "uz", "q"):
        _check(k, getattr(sp, k), torch.float32, (n,), device)
    _check("i", sp.i, torch.int32, (n,), device)
    _check("np", sp.np, torch.int32, (), device)
    _check("interp", interp, torch.float32, (g.nv, 18), device)
    if n == 0:
        return sp, acc

    inputs = dict(x=sp.dx, y=sp.dy, z=sp.dz, vox=sp.i, ux=sp.ux, uy=sp.uy,
                  uz=sp.uz, q=sp.q, np=sp.np, interp=interp)
    out, acc, counters = _run(inputs, n, 0, 1 + 4 * (n_walk - 1) + 8,
                              push_params(sp, g), g, acc, neighbor, device)
    launches["push"] += 1

    # pending lanes (exhausted + stopped) are drops, as in the plain version
    nm = sp.nm + counters[0] + counters[1]
    sp = sp.replace(dx=out["x_out"], dy=out["y_out"], dz=out["z_out"],
                    i=out["vox_out"], ux=out["ux_out"], uy=out["uy_out"],
                    uz=out["uz_out"], mdx=out["rx_out"], mdy=out["ry_out"],
                    mdz=out["rz_out"], pc=out["pcode_out"], nm=nm)
    return sp, acc


def streak_walk(st: WalkState, acc, neighbor, g: Grid, n_iter: int):
    """Kernel version of :func:`push.streak_walk` (the walk_only entry):
    continue the active lanes from their remaining displacement for up to
    ``4*n_iter + 8`` segments."""
    if st.x.device.type == "cpu":
        return plain.streak_walk(st, acc, neighbor, g, n_iter)
    device = _cuda_device(st.x)
    n = st.x.shape[0]
    for k in ("x", "y", "z", "ux", "uy", "uz", "rx", "ry", "rz", "q"):
        _check(k, getattr(st, k), torch.float32, (n,), device)
    _check("vox", st.vox, torch.int32, (n,), device)
    _check("pcode", st.pcode, torch.int32, (n,), device)
    _check("active", st.active, torch.bool, (n,), device)
    if n == 0:
        return st, acc

    inputs = {k: getattr(st, k) for k in ("x", "y", "z", "vox", "ux", "uy",
                                          "uz", "q", "rx", "ry", "rz",
                                          "pcode", "active")}
    out, acc, _ = _run(inputs, n, 1, 4 * n_iter + 8, (0.0,) * 4, g, acc,
                       neighbor, device)
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
