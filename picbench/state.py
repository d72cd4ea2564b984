"""What the benchmark reads of the program's state: a host copy of each
species' live lanes, its counts, and the fields, read through the deck
API's ``Simulation.state`` (the layout of ``vpic_tpu_torch/core/types.py``:
``[z, y, x]`` arrays with one ghost layer, voxel ``x + (nx+2)(y + (ny+2)
z)``), and that copy in the form of the configuration's plain reference
(``mod``, :func:`picbench.judge.reference`)."""

from __future__ import annotations

import torch

from picbench import compare

COLUMNS = ("dx", "dy", "dz", "i", "ux", "uy", "uz", "q")
# The program's field arrays (``core/types.py``); a reference module's
# ``E``, ``B`` and ``J`` name the ones it compares.
FIELDS = ("ex", "ey", "ez", "cbx", "cby", "cbz", "jfx", "jfy", "jfz")


def snapshot(sim, where="cpu") -> dict:
    """Copies (on the host, or on ``where``) of the state's live lanes (in
    lane order), live and dropped counts per species, the fields, and the
    steps that the deck was asked to take so far (the reference takes as
    many)."""
    st = sim.state
    species = []
    for sp in st.species:
        n = int(sp.np)
        species.append(dict(
            name=sp.name, np=n, nm=int(sp.nm),
            **{k: getattr(sp, k)[:n].to(where, copy=True) for k in COLUMNS}))
    out = dict(step=sim.step_count, species=species,
               fields={c: getattr(st.field, c).to(where, copy=True)
                       for c in FIELDS})
    del st
    return out


def to_reference(snap: dict, box, q_m: dict, dtype, device, mod):
    """A snapshot in the form of reference ``mod``: the fields on its
    mesh (the planes :func:`mod.planes` keeps of the ghosted arrays), and
    per species cells from 0, offsets, momenta, charges."""
    nx, ny, nz = box.n
    nxg, nyg = nx + 2, ny + 2
    F = {c: snap["fields"][c][mod.planes(c, box)].to(device).to(dtype)
         for c in mod.E + mod.B + mod.J}
    species = []
    for sp in snap["species"]:
        i = sp["i"].to(device).to(torch.int64)
        cell = torch.stack([i % nxg - 1, (i // nxg) % nyg - 1,
                            i // (nxg * nyg) - 1])
        col = lambda *ks: torch.stack([sp[k].to(device).to(dtype)
                                       for k in ks])
        species.append(dict(name=sp["name"], q_m=q_m[sp["name"]], cell=cell,
                            off=col("dx", "dy", "dz"),
                            u=col("ux", "uy", "uz"),
                            q=sp["q"].to(device).to(dtype)))
    return F, species


def summary(sim, box, q_m: dict, mod) -> dict:
    """What the comparison reads of the state after a compared unit, with
    no host copy of the particles: the host copy of the fields, the
    counts, and per species its count and momentum deposited on the nodes
    and the charge density (float64, worked out on the state's device)."""
    snap = snapshot(sim, sim.state.field.ex.device)
    dev = snap["fields"]["ex"].device
    moments, rhof = [], 0
    for sp in snap["species"]:
        one = dict(snap, species=[sp])
        _, (ref,) = to_reference(one, box, q_m, torch.float64, dev, mod)
        moments.append(compare.moments(ref, box, mod).cpu())
        rhof = rhof + mod.rho([ref], box, torch.float64).cpu()
        del ref, one
    return dict(step=snap["step"], moments=moments, rhof=rhof,
                fields={c: v.cpu() for c, v in snap["fields"].items()},
                species=[dict(np=sp["np"], nm=sp["nm"])
                         for sp in snap["species"]])
