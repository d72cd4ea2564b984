"""Tracer-particle trajectory output (``vpic_tpu/io/tracers.py``; the pdlfs
tracer deck library, decks/trecon-part/tracer.cxx): tracer species are
ordinary zero-charge species whose particles carry a nonzero ``tag``.

- :func:`collect_records` selects one species' tagged live lanes on the
  species' device and copies their rows to the host in one read:
  10-float rows [t, dx, dy, dz, i, ux, uy, uz, tag(lo32), tag(hi32)].
- :class:`TrajectoryAccumulator` keeps the rows per species on the host
  (the ``dump_traj`` analogue, tracer.cxx:254-301), with the flushed
  watermark of the per-tag append files and an npz form for checkpoints.
- :func:`write_traj`: one consolidated ``<dir>/<species>.traj`` per
  species, rows sorted by (tag, t), or the reference's one file per tracer
  ``<dir>/<species>.<tag:016x>`` appended step by step (tracer.cxx:281-293).
- :func:`read_traj` / :func:`read_traj_dir`: {tag: (nsteps, 8) float32
  [t, dx, dy, dz, i, ux, uy, uz]}.

The files are byte-compatible with the JAX package's: either package reads
the other's.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

REC_FLOATS = 10


def collect_records(sp_arrays: dict, step: int, dt: float,
                    capacity: int = None) -> np.ndarray:
    """(n_tagged, 10) float32 records of the live lanes with a nonzero tag,
    in lane order.  ``sp_arrays`` holds one species' 1-D ``tag``, ``alive``,
    ``dx``, ``dy``, ``dz``, ``i``, ``ux``, ``uy``, ``uz`` on one device
    (tensors or numpy arrays).  The lanes are selected and their rows built
    on that device; one host read copies ``capacity`` rows (an upper bound
    on the tagged live lanes: the tags the species was injected with; all
    slots if None) and the count."""
    a = {k: torch.as_tensor(v) for k, v in sp_arrays.items()}
    tag = a["tag"].to(torch.int64)
    sel = a["alive"] & (tag != 0)
    cap = sel.numel() if capacity is None else int(capacity)
    if cap == 0:
        return np.zeros((0, REC_FLOATS), np.float32)
    # each tagged lane's row number; the other lanes land in the spare row
    # ``cap``, which then carries the count
    dest = torch.where(sel, torch.cumsum(sel, 0) - 1, cap).clamp_(max=cap)
    # the 64-bit tag's two words, little-endian, as the reference's memcpy
    # stores them (tracer.cxx:292)
    words = tag.view(torch.int32).view(-1, 2).view(torch.float32)
    cols = [a[k].to(torch.float32) for k in ("dx", "dy", "dz", "i", "ux",
                                             "uy", "uz")]
    rows = torch.cat([torch.zeros_like(cols[0])[:, None],
                      torch.stack(cols, dim=1), words], dim=1)
    out = torch.zeros((cap + 1, REC_FLOATS), dtype=torch.float32,
                      device=tag.device).index_copy_(0, dest, rows)
    out[cap, 0] = sel.sum().to(torch.int32).view(torch.float32)
    host = out.cpu().numpy()
    n = int(host[cap, :1].view(np.int32)[0])
    if n > cap:
        raise ValueError(f"{n} tagged live lanes, more than the capacity "
                         f"{cap} of the records")
    rec = host[:n]
    rec[:, 0] = step * dt
    return rec


class TrajectoryAccumulator:
    """Accumulates tracer records across steps, per species.  Tracks a
    per-species flushed watermark so repeated per-tag-file dumps (append
    mode, tracer.cxx:281-293) never duplicate records, and serializes to
    npz so a quota-killed run can restore its accumulated trajectories
    (dump_tracer_restart/read_tracer_restart, tracer.cxx:199-253)."""

    def __init__(self):
        self._chunks: dict = {}
        self._flushed: dict = {}

    def add(self, species_name: str, rec: np.ndarray):
        self._chunks.setdefault(species_name, []).append(rec)

    def records(self, species_name: str, since: int = 0) -> np.ndarray:
        chunks = self._chunks.get(species_name, [])
        if not chunks:
            return np.zeros((0, REC_FLOATS), np.float32)
        rec = np.concatenate(chunks, axis=0)
        return rec[since:] if since else rec

    def species(self):
        return list(self._chunks)

    def clear(self):
        self._chunks.clear()
        self._flushed.clear()

    # -- checkpoint persistence (tracer.cxx:199-253 semantics) ----------
    def save_npz(self, path):
        arrays = {f"rec/{name}": self.records(name)
                  for name in self.species()}
        arrays["flushed_names"] = np.asarray(list(self._flushed), dtype=str)
        arrays["flushed_counts"] = np.asarray(
            [self._flushed[k] for k in self._flushed], np.int64)
        np.savez(path, **arrays)
        return path

    @classmethod
    def load_npz(cls, path):
        acc = cls()
        with np.load(path) as data:
            for k in data.files:
                if k.startswith("rec/"):
                    acc._chunks[k[4:]] = [data[k]]
            acc._flushed = {str(n): int(c) for n, c in
                            zip(data["flushed_names"],
                                data["flushed_counts"])}
        return acc


def _tags_of(rec: np.ndarray) -> np.ndarray:
    return rec[:, 8:10].copy().view(np.int32).reshape(
        rec.shape[0], 2).view(np.int64).reshape(-1)


def write_traj(acc: TrajectoryAccumulator, dirname,
               per_tag_files: bool = False):
    """Write accumulated trajectories (the dump_traj analogue)."""
    d = Path(dirname)
    d.mkdir(parents=True, exist_ok=True)
    out = []
    for name in acc.species():
        if per_tag_files:
            # append only records past the flushed watermark so repeated
            # dumps don't duplicate rows in the per-tag append files
            start = acc._flushed.get(name, 0)
            rec = acc.records(name, since=start)
            acc._flushed[name] = start + rec.shape[0]
            tags = _tags_of(rec)
            for tag in np.unique(tags):
                path = d / f"{name}.{int(tag) & (2**64 - 1):016x}"
                sel = rec[tags == tag]
                sel = sel[np.argsort(sel[:, 0], kind="stable")]
                with open(path, "ab") as f:
                    f.write(np.ascontiguousarray(sel, "<f4").tobytes())
                out.append(path)
        else:
            rec = acc.records(name)
            tags = _tags_of(rec)
            order = np.lexsort((rec[:, 0], tags))
            path = d / f"{name}.traj"
            with open(path, "wb") as f:
                f.write(np.ascontiguousarray(rec[order], "<f4").tobytes())
            out.append(path)
    return out


def _split_by_tag(rec: np.ndarray) -> dict:
    tags = _tags_of(rec)
    out = {}
    for tag in np.unique(tags):
        sel = rec[tags == tag][:, :8]
        out[int(tag)] = sel[np.argsort(sel[:, 0], kind="stable")]
    return out


def read_traj(path) -> dict:
    """Read a consolidated ``<species>.traj`` file -> {tag: (n, 8) rows}."""
    rec = np.fromfile(path, "<f4").reshape(-1, REC_FLOATS)
    return _split_by_tag(rec)


def read_traj_dir(dirname, species_name: str) -> dict:
    """Read either layout for one species."""
    d = Path(dirname)
    consolidated = d / f"{species_name}.traj"
    if consolidated.exists():
        return read_traj(consolidated)
    out = {}
    for path in sorted(d.glob(f"{species_name}.*")):
        rec = np.fromfile(path, "<f4").reshape(-1, REC_FLOATS)
        out.update(_split_by_tag(rec))
    return out


def globalize_voxels(g, i, shard):
    """Convert shard-local ghosted voxel indices to indices on the GLOBAL
    ghosted grid (gnx+2, gny+2, gnz+2) so multishard trajectory records
    decode with one origin (``global_positions``)."""
    i = np.asarray(i, np.int64)
    sx, sy, sz = shard
    ix = i % g.nxg
    iy = (i // g.nxg) % g.nyg
    iz = i // (g.nxg * g.nyg)
    gx = sx * g.nx + ix
    gy = sy * g.ny + iy
    gz = sz * g.nz + iz
    return gx + (g.gnx + 2) * (gy + (g.gny + 2) * gz)


def global_positions(g, rows: np.ndarray, origin=(None, None, None)):
    """Reconstruct global coordinates from (dx,dy,dz,i) trajectory rows —
    the tracer_x/tracer_y/tracer_z macros (tracer.cxx:110-112).  Voxels
    are on the global ghosted grid (``globalize_voxels``; identical to the
    local grid for single-shard runs)."""
    i = rows[:, 4].astype(np.int64)
    nxg, nyg = g.gnx + 2, g.gny + 2
    ix = i % nxg
    iy = (i // nxg) % nyg
    iz = i // (nxg * nyg)
    x0 = g.gx0 if origin[0] is None else origin[0]
    y0 = g.gy0 if origin[1] is None else origin[1]
    z0 = g.gz0 if origin[2] is None else origin[2]
    x = x0 + ((ix - 1) + (rows[:, 1] + 1) * 0.5) * g.dx
    y = y0 + ((iy - 1) + (rows[:, 2] + 1) * 0.5) * g.dy
    z = z0 + ((iz - 1) + (rows[:, 3] + 1) * 0.5) * g.dz
    return x, y, z


def write_h5part(acc: TrajectoryAccumulator, path, species_name: str):
    """H5Part-layout tracer output (decks/trecon-hdf5/dumptracer_h5part.cxx:
    24-81): one ``/Step#<n>`` group per recorded step with the reference's
    dataset names dX,dY,dZ,i,Ux,Uy,Uz,q — ``q`` carries the tracer tag as
    the reference's Int32 write does.  Requires h5py."""
    import h5py

    rec = acc.records(species_name)
    times = np.unique(rec[:, 0])
    with h5py.File(path, "w") as f:
        for n, t in enumerate(times):
            sel = rec[rec[:, 0] == t]
            grp = f.create_group(f"Step#{n}")
            grp.attrs["TimeValue"] = float(t)
            grp.create_dataset("dX", data=sel[:, 1].astype("<f4"))
            grp.create_dataset("dY", data=sel[:, 2].astype("<f4"))
            grp.create_dataset("dZ", data=sel[:, 3].astype("<f4"))
            grp.create_dataset("i", data=sel[:, 4].astype("<i4"))
            grp.create_dataset("Ux", data=sel[:, 5].astype("<f4"))
            grp.create_dataset("Uy", data=sel[:, 6].astype("<f4"))
            grp.create_dataset("Uz", data=sel[:, 7].astype("<f4"))
            grp.create_dataset("q", data=_tags_of(sel).astype("<i4"))
    return path
