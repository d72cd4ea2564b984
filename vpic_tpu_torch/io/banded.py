"""Banded and strided field and hydro dumps (``vpic_tpu/io/banded.py``; the
reference's "new dump" format, vpic.hxx:98-124 DumpParameters +
dump.cxx:1116-1557): per-variable bitmask selection, output striding, and
band (variable-major) or band-interleave (record-major) layouts, with the
V0 header extended by the dump parameters.
"""

from __future__ import annotations

import dataclasses
import struct
from pathlib import Path

import numpy as np

from ..core.types import FIELD_COMPONENTS
from ..interop import to_numpy
from .dump import FIELD_DUMP, HYDRO_DUMP, read_header_v0, write_header_v0

BAND = 0
BAND_INTERLEAVE = 1

FIELD_VARS = FIELD_COMPONENTS
HYDRO_VARS = ("jx", "jy", "jz", "rho", "px", "py", "pz", "ke",
              "txx", "tyy", "tzz", "tyz", "tzx", "txy")


@dataclasses.dataclass
class DumpParameters:
    """vpic.hxx:98-124: output strides and the variable selection."""

    stride_x: int = 1
    stride_y: int = 1
    stride_z: int = 1
    format: int = BAND
    select: tuple = ()          # variable names; () = all

    def mask(self, names):
        if not self.select:
            return (1 << len(names)) - 1
        m = 0
        for k, n in enumerate(names):
            if n in self.select:
                m |= 1 << k
        return m


def _strided(arr, g, dp: DumpParameters):
    """Owned region subsampled by the strides (dump.cxx banded loops)."""
    return arr[1:g.nz + 1:dp.stride_z,
               1:g.ny + 1:dp.stride_y,
               1:g.nx + 1:dp.stride_x]


def _write(path, g, arrays, names, dp, dump_type, step, shard, rank, nproc,
           sp_id=-1, q_m=0.0):
    """``arrays``: a function of a variable name giving its ghosted
    (nzg, nyg, nxg) array (tensor or numpy)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    mask = dp.mask(names)
    sel = [n for k, n in enumerate(names) if mask & (1 << k)]
    bands = [np.asarray(to_numpy(_strided(arrays(n), g, dp)), dtype="<f4")
             for n in sel]
    nzo, nyo, nxo = bands[0].shape
    with open(path, "wb") as f:
        write_header_v0(f, dump_type, step, g, shard, rank, nproc, sp_id,
                        q_m)
        # extended header: format, bitmask, strides, output dims
        f.write(struct.pack("<iQiii", dp.format, mask,
                            dp.stride_x, dp.stride_y, dp.stride_z))
        f.write(struct.pack("<iii", nxo, nyo, nzo))
        if dp.format == BAND:
            for b in bands:
                f.write(np.ascontiguousarray(b).tobytes())
        else:
            rec = np.stack([b.reshape(-1) for b in bands], axis=-1)
            f.write(np.ascontiguousarray(rec, dtype="<f4").tobytes())
    return path


def field_dump(state, g, path, dp: DumpParameters, step, shard=(0, 0, 0),
               rank=0, nproc=1):
    return _write(path, g, lambda n: getattr(state.field, n), FIELD_VARS,
                  dp, FIELD_DUMP, step, shard, rank, nproc)


def hydro_dump(h, g, path, dp: DumpParameters, step, sp_id, q_m,
               shard=(0, 0, 0), rank=0, nproc=1):
    h4 = h.reshape(g.nzg, g.nyg, g.nxg, -1)
    return _write(path, g, lambda n: h4[..., HYDRO_VARS.index(n)],
                  HYDRO_VARS, dp, HYDRO_DUMP, step, shard, rank, nproc,
                  sp_id, q_m)


def read_banded(path):
    with open(path, "rb") as f:
        hdr = read_header_v0(f)
        fmt, mask, sx, sy, sz = struct.unpack("<iQiii", f.read(24))
        nxo, nyo, nzo = struct.unpack("<iii", f.read(12))
        names = FIELD_VARS if hdr["dump_type"] == FIELD_DUMP else HYDRO_VARS
        sel = [n for k, n in enumerate(names) if mask & (1 << k)]
        data = np.frombuffer(f.read(), "<f4")
    out = {}
    n = nxo * nyo * nzo
    if fmt == BAND:
        for k, name in enumerate(sel):
            out[name] = data[k * n:(k + 1) * n].reshape(nzo, nyo, nxo)
    else:
        rec = data.reshape(n, len(sel))
        for k, name in enumerate(sel):
            out[name] = rec[:, k].reshape(nzo, nyo, nxo)
    return hdr, out, dict(format=fmt, strides=(sx, sy, sz))
