"""Binary dump writers in the reference's V0 format (``vpic_tpu/io/dump.py``;
src/vpic/dumpmacros.h WRITE_HEADER_V0 + src/vpic/dump.cxx:140-345): one
file per rank named ``<base>.<step>.<rank>``, little-endian, with the
binary-compatibility probe prologue.  The bytes are the JAX package's, so
either package's readers parse either's files.  Tensors are copied to the
host here, once per file.
"""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np

from ..core.types import FIELD_COMPONENTS, MATERIAL_ID_FIELDS, Grid
from ..grid.partition import shard_origin
from ..interop import to_numpy as host

# dump_type enum (dump.cxx:136-142)
GRID_DUMP, FIELD_DUMP, HYDRO_DUMP, PARTICLE_DUMP, RESTART_DUMP = range(5)
INVALID_SPECIES_ID = -1


def write_header_v0(f, dump_type: int, step: int, g: Grid, shard=(0, 0, 0),
                    rank: int = 0, nproc: int = 1,
                    sp_id: int = INVALID_SPECIES_ID, q_m: float = 0.0):
    """Exact byte layout of WRITE_HEADER_V0 (dumpmacros.h:10-44)."""
    x0, y0, z0 = shard_origin(g, shard)
    f.write(struct.pack("<5b", 8, 2, 4, 4, 8))          # sizes probe
    f.write(struct.pack("<H", 0xCAFE))                  # short probe
    f.write(struct.pack("<I", 0xDEADBEEF))              # int probe
    f.write(struct.pack("<f", 1.0))
    f.write(struct.pack("<d", 1.0))
    f.write(struct.pack("<ii", 0, dump_type))
    f.write(struct.pack("<iiii", step, g.nx, g.ny, g.nz))
    f.write(struct.pack("<ffff", g.dt, g.dx, g.dy, g.dz))
    f.write(struct.pack("<fff", x0, y0, z0))
    f.write(struct.pack("<fff", g.cvac, g.eps0, g.damp))
    f.write(struct.pack("<ii", rank, nproc))
    f.write(struct.pack("<if", sp_id, q_m))


def write_array_header(f, elem_size: int, dims):
    f.write(struct.pack("<ii", elem_size, len(dims)))
    f.write(np.asarray(dims, dtype="<i4").tobytes())


def _fname(fbase, step, rank, ftag=True):
    return f"{fbase}.{step}.{rank}" if ftag else f"{fbase}.{rank}"


def _open(path):
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    return path


def dump_fields(state, g: Grid, fbase: str, step: int, shard=(0, 0, 0),
                rank=0, nproc=1, ftag=True):
    """field_dump V0: the full ghosted field array as interleaved
    ``field_t`` records (16 f32 + 8 u16 material ids, 80 B/voxel;
    dump.cxx:190-222): the ids ematx, ematy, ematz, nmat, fmatx, fmaty,
    fmatz, cmat of the state's material grid, 0 without one."""
    rec = np.zeros((g.nv,), dtype=np.dtype([("f", "<f4", 16),
                                            ("m", "<u2", 8)]))
    for k, c in enumerate(FIELD_COMPONENTS):
        rec["f"][:, k] = host(getattr(state.field, c)).reshape(-1)
    matg = getattr(state, "material_grid", None)
    if matg is not None:
        for k, c in enumerate(MATERIAL_ID_FIELDS):
            rec["m"][:, k] = host(getattr(matg, c)).reshape(-1).astype(
                np.uint16)
    path = _open(_fname(fbase, step, rank, ftag))
    with open(path, "wb") as f:
        write_header_v0(f, FIELD_DUMP, step, g, shard, rank, nproc)
        write_array_header(f, 80, (g.nxg, g.nyg, g.nzg))
        f.write(rec.tobytes())
    return path


def dump_hydro(h, g: Grid, fbase: str, step: int, sp_id: int, q_m: float,
               shard=(0, 0, 0), rank=0, nproc=1, ftag=True):
    """hydro_dump V0: (nv, 14) moments + 2 pad floats = 64 B/voxel
    (dump.cxx:224-265)."""
    arr = np.zeros((g.nv, 16), dtype="<f4")
    arr[:, :14] = host(h)
    path = _open(_fname(fbase, step, rank, ftag))
    with open(path, "wb") as f:
        write_header_v0(f, HYDRO_DUMP, step, g, shard, rank, nproc, sp_id,
                        q_m)
        write_array_header(f, 64, (g.nxg, g.nyg, g.nzg))
        f.write(arr.tobytes())
    return path


PARTICLE_RECORD = np.dtype([("dx", "<f4"), ("dy", "<f4"), ("dz", "<f4"),
                            ("i", "<i4"), ("ux", "<f4"), ("uy", "<f4"),
                            ("uz", "<f4"), ("q", "<f4")])


def dump_particles(sp, g: Grid, fbase: str, step: int, shard=(0, 0, 0),
                   rank=0, nproc=1, ftag=True):
    """particle_dump V0: the live particles as 32 B records
    dx,dy,dz,i,ux,uy,uz,q (dump.cxx:267-325; the caller centers a copy
    first, ``push.center_p``)."""
    alive = host(sp.alive)
    rec = np.zeros((int(alive.sum()),), dtype=PARTICLE_RECORD)
    for k in PARTICLE_RECORD.names:
        rec[k] = host(getattr(sp, k))[alive]
    path = _open(_fname(fbase, step, rank, ftag))
    with open(path, "wb") as f:
        write_header_v0(f, PARTICLE_DUMP, step, g, shard, rank, nproc,
                        sp.sid, float(sp.q_m))
        write_array_header(f, 32, (rec.shape[0],))
        f.write(rec.tobytes())
    return path


def dump_grid(state, g: Grid, fbase: str, shard=(0, 0, 0), rank=0,
              nproc=1):
    """grid_dump V0 (dump.cxx:145-187): bc array, cell ranges, and the
    (nv, 6) int32 neighbor table widened to int64, written under the
    reference's (6, nxg, nyg, nzg) array header as the JAX package does."""
    path = _open(f"{fbase}.{rank}")
    bc = np.zeros((27,), dtype="<i4")
    nb = host(state.grid_arrays.neighbor).astype("<i8")
    ranges = np.arange(nproc + 1, dtype="<i8") * np.int64(g.nv)
    with open(path, "wb") as f:
        write_header_v0(f, GRID_DUMP, 0, g, shard, rank, nproc)
        write_array_header(f, 4, (3, 3, 3))
        f.write(bc.tobytes())
        write_array_header(f, 8, (nproc + 1,))
        f.write(ranges.tobytes())
        write_array_header(f, 8, (6, g.nxg, g.nyg, g.nzg))
        f.write(nb.reshape(-1).tobytes())
    return path


def dump_species_ascii(path, species):
    """dump_species (dump.cxx:82-101): one ``name\\nid\\nq_m\\n`` stanza
    per species; ``species`` is an iterable of (name, id, q_m)."""
    path = _open(path)
    with open(path, "w") as f:
        for name, sid, q_m in species:
            f.write(f"{name}\n{sid:d}\n{q_m:e}\n")
    return path


def dump_materials_ascii(path, materials):
    """dump_materials (dump.cxx:103-120): per material its name, id and
    the eps, mu and sigma rows (objects with the attributes of
    ``deck.api._Material``)."""
    path = _open(path)
    with open(path, "w") as f:
        for m in materials:
            f.write(f"{m.name}\n{m.id:d}\n"
                    f"{m.epsx:e} {m.epsy:e} {m.epsz:e}\n"
                    f"{m.mux:e} {m.muy:e} {m.muz:e}\n"
                    f"{m.sigmax:e} {m.sigmay:e} {m.sigmaz:e}\n")
    return path


def read_header_v0(f):
    """Parse a V0 header."""
    probe = struct.unpack("<5b", f.read(5))
    magic_s = struct.unpack("<H", f.read(2))[0]
    magic_i = struct.unpack("<I", f.read(4))[0]
    struct.unpack("<f", f.read(4))
    struct.unpack("<d", f.read(8))
    version, dump_type = struct.unpack("<ii", f.read(8))
    step, nx, ny, nz = struct.unpack("<iiii", f.read(16))
    dt, dx, dy, dz = struct.unpack("<ffff", f.read(16))
    x0, y0, z0 = struct.unpack("<fff", f.read(12))
    cvac, eps0, damp = struct.unpack("<fff", f.read(12))
    rank, nproc = struct.unpack("<ii", f.read(8))
    sp_id, q_m = struct.unpack("<if", f.read(8))
    return dict(probe=probe, magic_s=magic_s, magic_i=magic_i,
                version=version, dump_type=dump_type, step=step,
                nx=nx, ny=ny, nz=nz, dt=dt, dx=dx, dy=dy, dz=dz,
                x0=x0, y0=y0, z0=z0, cvac=cvac, eps0=eps0, damp=damp,
                rank=rank, nproc=nproc, sp_id=sp_id, q_m=q_m)


def read_array_header(f):
    elem, ndim = struct.unpack("<ii", f.read(8))
    dims = np.frombuffer(f.read(4 * ndim), dtype="<i4")
    return elem, tuple(int(d) for d in dims)
