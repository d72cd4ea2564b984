"""Checkpoint and restart (``vpic_tpu/io/checkpoint.py``; replaces the
reference's full-binary restart dump, src/vpic/dump.cxx:333-822).

The port's own format: an npz of the :func:`vpic_tpu_torch.interop.
state_to_numpy` arrays (named by state path, so a file says what it
holds: fields, particles, the material ids where the deck has regions,
the random state ``rng`` and each boundary handler's state, link rings
included) and a JSON sidecar with the format version, the package name, the
grid and species metadata and the caller's extras.  A sharded deck's
list of per-shard states is saved stacked, every array with leading
(gpz, gpy, gpx) axes, as the JAX package's stacked state is
(``interop.states_to_numpy``).  The deck workflow is
the JAX package's: two-slot rotation (restart1/restart2 with rtoggle,
decks/trecon-part/turbulence.cxx:1148-1247) and a quota-triggered final
checkpoint.
"""

from __future__ import annotations

import dataclasses
import json
import time
from pathlib import Path

import numpy as np

from ..core.types import SPECIES_COLUMNS, Grid, SimState
from ..interop import (state_from_numpy, state_to_numpy, states_to_numpy,
                       unstack_numpy)

# 2: ``rng`` holds the two words of the JAX package's threefry key
# (``core/random.py``), which format 1's random state cannot give
FORMAT_VERSION = 2
PACKAGE = "vpic_tpu_torch"
# the species' host metadata: the loaded state takes the template's
_STATIC = ("name", "sid", "max_np", "sort_interval", "q_m")


def save_checkpoint(path, state, g: Grid, extra: dict = None):
    """Write ``<path>.npz`` and ``<path>.json`` of a state or of a list of
    per-shard states."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    arrays = states_to_numpy(state, (g.gpz, g.gpy, g.gpx))
    np.savez(str(path) + ".npz", **arrays)
    first = state[0] if isinstance(state, list) else state
    meta = dict(
        version=FORMAT_VERSION,
        package=PACKAGE,
        grid=dataclasses.asdict(g),
        species=[dict(name=sp.name, sid=sp.sid, max_np=sp.max_np,
                      sort_interval=sp.sort_interval)
                 for sp in first.species],
        n_arrays=len(arrays),
        time=time.time(),
        extra=extra or {},
    )
    with open(str(path) + ".json", "w") as f:
        json.dump(meta, f, indent=1)
    return path


def _particle_column(key: str) -> bool:
    return key.startswith("species/") and key.rsplit("/", 1)[1] in \
        SPECIES_COLUMNS


def load_checkpoint(path, template, device="cpu"):
    """Load a checkpoint into the structure of ``template`` (a state built
    by the same deck, or the list of a sharded deck's per-shard states) on
    ``device`` (or, for a list, shard r on ``device[r % len(device)]``).

    Every saved array must have the template's shape (the reference's
    restart reader aborts on every size mismatch, dump.cxx:566-797), with
    one repair: a particle column shorter than the template's (saved at a
    smaller capacity) is zero-padded at the tail, where dead slots are
    q = 0, i = 0 and ``np`` bounds the live range."""
    meta = load_meta(path)
    if meta.get("package") != PACKAGE or meta.get("version") != \
            FORMAT_VERSION:
        raise ValueError(f"checkpoint {path} is {meta.get('package')!r} "
                         f"format {meta.get('version')}, not {PACKAGE!r} "
                         f"format {FORMAT_VERSION}")
    with np.load(str(path) + ".npz") as data:
        saved = {k: data[k] for k in data.files}
    one = not isinstance(template, list)
    templates = [template] if one else template
    devices = device if isinstance(device, (list, tuple)) else [device]
    states = [state_from_numpy(_fit(path, d, t),
                               device=devices[r % len(devices)])
              for r, (d, t) in enumerate(zip(
                  unstack_numpy(saved, len(templates)), templates))]
    return states[0] if one else states


def _fit(path, saved: dict, template: SimState) -> dict:
    """One shard's saved arrays checked against (and padded to) the
    template's."""
    want = state_to_numpy(template)
    if set(saved) != set(want):
        raise ValueError(
            f"checkpoint {path} holds {len(saved)} arrays but the "
            f"deck builds {len(want)}: the configuration (species, "
            "fields) does not match the one that wrote it")
    out = {}
    for key, tmpl in want.items():
        if key.startswith("species/") and key.rsplit("/", 1)[1] in _STATIC:
            out[key] = tmpl
            continue
        arr = saved[key]
        have, shape = arr.shape, np.shape(tmpl)
        if have != shape:
            if (_particle_column(key) and len(have) == 1
                    and have[0] < shape[0]):
                arr = np.concatenate(
                    [arr, np.zeros((shape[0] - have[0],), arr.dtype)])
            else:
                raise ValueError(
                    f"checkpoint {path} array {key}: saved shape {have}"
                    f" vs deck shape {shape}: capacity or grid mismatch "
                    "(rebuild the deck with the saved metadata, "
                    "load_meta())")
        out[key] = arr
    return out


def load_meta(path):
    with open(str(path) + ".json") as f:
        return json.load(f)


class RotatingCheckpointer:
    """Two-slot rotating restart sets and wall-clock quota
    self-termination (the deck-side defensive checkpoint pattern,
    turbulence.cxx:1148-1247)."""

    def __init__(self, base_dir, quota_hours: float = None):
        self.base = Path(base_dir)
        self.rtoggle = 0
        self.t0 = time.time()
        self.quota = quota_hours * 3600.0 if quota_hours else None

    def slot(self) -> Path:
        return self.base / f"restart{self.rtoggle + 1}" / "restart"

    def save(self, state, g: Grid, extra=None):
        slot = self.slot()
        save_checkpoint(slot, state, g, extra)
        self.rtoggle ^= 1
        return slot

    def over_quota(self) -> bool:
        return self.quota is not None and (time.time() - self.t0) > self.quota

    def latest(self):
        cands = []
        for slot in (self.base / "restart1", self.base / "restart2"):
            j = slot / "restart.json"
            if j.exists():
                cands.append((j.stat().st_mtime, slot / "restart"))
        if not cands:
            return None
        return max(cands)[1]
