"""Readers for the V0 dump files (``vpic_tpu/io/readers.py``; the
reference's post-processing stack: interfaces/matlab/load_domain_*.m,
interfaces/idl/, decks/trecon-reader/vpic-reader.cxx): per-rank dumps back
into numpy arrays, and multi-rank bricks assembled (the load_brick_*
analogue).  The files are byte-compatible between the two packages, so
these read either package's dumps.
"""

from __future__ import annotations

import numpy as np

from .dump import read_array_header, read_header_v0

FIELD_REC = np.dtype([("f", "<f4", 16), ("m", "<u2", 8)])
PARTICLE_REC = np.dtype(
    [("dx", "<f4"), ("dy", "<f4"), ("dz", "<f4"), ("i", "<i4"),
     ("ux", "<f4"), ("uy", "<f4"), ("uz", "<f4"), ("q", "<f4")])

FIELD_NAMES = ("ex", "ey", "ez", "div_e_err", "cbx", "cby", "cbz",
               "div_b_err", "tcax", "tcay", "tcaz", "rhob",
               "jfx", "jfy", "jfz", "rhof")
HYDRO_NAMES = ("jx", "jy", "jz", "rho", "px", "py", "pz", "ke",
               "txx", "tyy", "tzz", "tyz", "tzx", "txy")


def read_fields(path):
    """-> (header, dict of (nz+2, ny+2, nx+2) arrays) like
    load_domain_fields.m."""
    with open(path, "rb") as f:
        hdr = read_header_v0(f)
        _, dims = read_array_header(f)
        rec = np.frombuffer(f.read(), dtype=FIELD_REC)
    nxg, nyg, nzg = dims
    out = {name: rec["f"][:, k].reshape(nzg, nyg, nxg)
           for k, name in enumerate(FIELD_NAMES)}
    out["materials"] = rec["m"].reshape(nzg, nyg, nxg, 8)
    return hdr, out


def read_hydro(path):
    """-> (header, dict of the 14 (nz+2, ny+2, nx+2) hydro moments)."""
    with open(path, "rb") as f:
        hdr = read_header_v0(f)
        _, dims = read_array_header(f)
        arr = np.frombuffer(f.read(), "<f4").reshape(-1, 16)
    nxg, nyg, nzg = dims
    out = {name: arr[:, k].reshape(nzg, nyg, nxg)
           for k, name in enumerate(HYDRO_NAMES)}
    return hdr, out


def read_particles(path):
    """-> (header, structured array, (n, 3) global positions), the
    positions reconstructed as load_domain_particles.m and the tracer_x
    macros do (tracer.cxx:110-112)."""
    with open(path, "rb") as f:
        hdr = read_header_v0(f)
        read_array_header(f)
        rec = np.frombuffer(f.read(), dtype=PARTICLE_REC).copy()
    nxg = hdr["nx"] + 2
    nyg = hdr["ny"] + 2
    j = rec["i"] // nxg
    ix = rec["i"] - j * nxg
    iz = j // nyg
    iy = j - iz * nyg
    x = hdr["x0"] + ((ix - 1) + 0.5 * (rec["dx"] + 1.0)) * hdr["dx"]
    y = hdr["y0"] + ((iy - 1) + 0.5 * (rec["dy"] + 1.0)) * hdr["dy"]
    z = hdr["z0"] + ((iz - 1) + 0.5 * (rec["dz"] + 1.0)) * hdr["dz"]
    return hdr, rec, np.stack([x, y, z], axis=-1)


def read_energies(path):
    """Parse an energies time series -> (names, (nlines, ncols) array)."""
    names = ["step", "ex", "ey", "ez", "bx", "by", "bz"]
    rows = []
    with open(path) as f:
        for line in f:
            if line.startswith("%"):
                if "step ex" in line:
                    names += [t.strip('"') for t in line.split()[8:]]
                continue
            rows.append([float(v) for v in line.split()])
    return names, np.asarray(rows)


def assemble_brick(paths_by_rank, g_shape_per_rank, topology, component):
    """load_brick_* analogue: concatenate the owned blocks of per-rank
    field dumps into one global array.  ``topology`` = (pz, py, px);
    ``g_shape_per_rank`` is unused (each file's header gives its block)
    and kept for the JAX package's signature."""
    pz, py, px = topology
    planes = []
    rank = 0
    for _ in range(pz):
        yrows = []
        for _ in range(py):
            xrow = []
            for _ in range(px):
                hdr, flds = read_fields(paths_by_rank[rank])
                xrow.append(flds[component][1:hdr["nz"] + 1,
                                            1:hdr["ny"] + 1,
                                            1:hdr["nx"] + 1])
                rank += 1
            yrows.append(np.concatenate(xrow, axis=2))
        planes.append(np.concatenate(yrows, axis=1))
    return np.concatenate(planes, axis=0)
