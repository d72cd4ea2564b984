"""ctypes bindings to the repo's native dump toolchain, ``native/
vpic_dump.cpp`` (``vpic_tpu/io/native.py``): bulk particle-dump reads and
the join of per-rank banded bricks into one global volume, the role the
reference fills with C++ consumers (decks/trecon-reader, interfaces/c).

The library is compiled from that source with ``g++`` at first use into
``vpic_tpu_torch/_build/`` (named by a hash of the source and the flags,
so an edit rebuilds it) and loaded with ctypes.  A failed build raises
with the compiler's output; there is no fallback to the Python readers
(``io/readers.py``, ``io/banded.py``), which stay the reference.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

_SOURCE = Path(__file__).resolve().parents[2] / "native" / "vpic_dump.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
CXX_FLAGS = ("-O2", "-std=c++17", "-Wall", "-fPIC", "-shared")

_lib = None


class V0Header(ctypes.Structure):
    """Mirror of ``struct VpicV0Header`` in native/vpic_dump.cpp."""
    _fields_ = [
        ("version", ctypes.c_int32), ("dump_type", ctypes.c_int32),
        ("step", ctypes.c_int32), ("nx", ctypes.c_int32),
        ("ny", ctypes.c_int32), ("nz", ctypes.c_int32),
        ("dt", ctypes.c_float), ("dx", ctypes.c_float),
        ("dy", ctypes.c_float), ("dz", ctypes.c_float),
        ("x0", ctypes.c_float), ("y0", ctypes.c_float),
        ("z0", ctypes.c_float),
        ("cvac", ctypes.c_float), ("eps0", ctypes.c_float),
        ("damp", ctypes.c_float),
        ("rank", ctypes.c_int32), ("nproc", ctypes.c_int32),
        ("sp_id", ctypes.c_int32), ("q_m", ctypes.c_float),
        ("elem_size", ctypes.c_int32), ("ndim", ctypes.c_int32),
        ("dims", ctypes.c_int32 * 4), ("data_offset", ctypes.c_int64),
    ]


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(_SOURCE.read_bytes())
    return BUILD_DIR / f"libvpicdump_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library if this source has not been built; returns its
    path.  Raises RuntimeError with the compiler's output on failure."""
    so = library_path()
    if so.exists():
        return so
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the native dump library cannot "
                           "be built (set CXX or put g++ on PATH)")
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp")
    r = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(_SOURCE)],
                       capture_output=True, text=True, timeout=300)
    if r.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building {so.name} from {_SOURCE} failed "
                           f"({r.returncode}):\n{r.stdout}{r.stderr}")
    os.replace(tmp, so)
    return so


def load() -> ctypes.CDLL:
    """Build (where needed) and load the library."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build()))
    lib.vpic_read_v0_header.argtypes = [ctypes.c_char_p,
                                        ctypes.POINTER(V0Header)]
    lib.vpic_read_v0_header.restype = ctypes.c_int
    lib.vpic_read_particles.argtypes = [ctypes.c_char_p,
                                        ctypes.POINTER(ctypes.c_float),
                                        ctypes.c_long]
    lib.vpic_read_particles.restype = ctypes.c_long
    lib.vpic_join_banded.argtypes = [ctypes.POINTER(ctypes.c_char_p),
                                     ctypes.c_int, ctypes.c_int,
                                     ctypes.c_int, ctypes.c_int,
                                     ctypes.c_char_p]
    lib.vpic_join_banded.restype = ctypes.c_int
    _lib = lib
    return lib


def read_header(path) -> dict:
    """The V0 header and the first array header of a dump file."""
    h = V0Header()
    rc = load().vpic_read_v0_header(str(path).encode(), ctypes.byref(h))
    if rc != 0:
        raise IOError(f"vpic_read_v0_header({path}) -> {rc}")
    out = {k: getattr(h, k) for k, _ in V0Header._fields_ if k != "dims"}
    out["dims"] = tuple(h.dims[:h.ndim])
    return out


def read_particles(path) -> np.ndarray:
    """(n, 8) float32 particle records [dx,dy,dz,i(bits),ux,uy,uz,q]."""
    n = read_header(path)["dims"][0]
    out = np.zeros((max(n, 1), 8), np.float32)
    got = load().vpic_read_particles(
        str(path).encode(),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n)
    if got < 0:
        raise IOError(f"vpic_read_particles({path}) -> {got}")
    return out[:got]


def join_banded(paths, gpx, gpy, gpz, out_path) -> int:
    """Join per-rank BAND dumps into one global brick file; returns the
    variable count."""
    if len(paths) != gpx * gpy * gpz:
        raise ValueError(f"{len(paths)} files for a {gpx}x{gpy}x{gpz} "
                         "topology")
    arr = (ctypes.c_char_p * len(paths))(
        *[str(p).encode() for p in paths])
    rc = load().vpic_join_banded(arr, len(paths), gpx, gpy, gpz,
                                 str(out_path).encode())
    if rc < 0:
        raise IOError(f"vpic_join_banded -> {rc}")
    return rc
