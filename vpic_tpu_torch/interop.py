"""Simulation state <-> a flat dict of numpy arrays.

:func:`state_to_numpy` reads either package's ``SimState`` by attribute
(``np.asarray`` turns a JAX array into numpy without this module importing
JAX), so a state built by ``vpic_tpu`` can be loaded into the port with
:func:`state_from_numpy` and both packages can start from one state.

Keys: ``field/<component>``, ``interpolator``, ``neighbor``,
``materials/<column>``, ``step``, and per species k ``species/<k>/<column>``
for the particle columns, ``np``, ``nm`` and the static ``name``, ``sid``,
``max_np``, ``sort_interval`` and ``q_m``.
"""

from __future__ import annotations

import numpy as np
import torch

from .core.types import (
    FIELD_COMPONENTS,
    MATERIAL_COLUMNS,
    SPECIES_COLUMNS,
    FieldState,
    GridArrays,
    MaterialTable,
    SimState,
    SpeciesState,
)

_STATIC = ("name", "sid", "max_np", "sort_interval")


def to_numpy(a) -> np.ndarray:
    """A tensor on any device, or an array of either package, as numpy."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def state_to_numpy(state) -> dict:
    if getattr(state, "material_grid", None) is not None:
        raise NotImplementedError("per-voxel material grids are not ported")
    d = {f"field/{k}": to_numpy(getattr(state.field, k)) for k in FIELD_COMPONENTS}
    d["interpolator"] = to_numpy(state.interpolator)
    d["neighbor"] = to_numpy(state.grid_arrays.neighbor)
    d.update({f"materials/{k}": to_numpy(getattr(state.materials, k))
              for k in MATERIAL_COLUMNS})
    d["step"] = to_numpy(state.step)
    for k, sp in enumerate(state.species):
        pre = f"species/{k}/"
        for c in SPECIES_COLUMNS + ("np", "nm"):
            d[pre + c] = to_numpy(getattr(sp, c))
        for c in _STATIC:
            d[pre + c] = getattr(sp, c)
        d[pre + "q_m"] = np.float32(to_numpy(sp.q_m))
    return d


def state_from_numpy(d: dict, device="cpu") -> SimState:
    t = lambda a: torch.as_tensor(np.array(a), device=device)
    species = []
    k = 0
    while f"species/{k}/name" in d:
        pre = f"species/{k}/"
        species.append(SpeciesState(
            **{c: d[pre + c] for c in _STATIC},
            q_m=float(np.float32(d[pre + "q_m"])),
            **{c: t(d[pre + c]) for c in SPECIES_COLUMNS + ("np", "nm")}))
        k += 1
    return SimState(
        field=FieldState(**{c: t(d[f"field/{c}"]) for c in FIELD_COMPONENTS}),
        interpolator=t(d["interpolator"]),
        species=tuple(species),
        grid_arrays=GridArrays(neighbor=t(d["neighbor"])),
        materials=MaterialTable(**{c: t(d[f"materials/{c}"])
                                   for c in MATERIAL_COLUMNS}),
        step=t(d["step"]))
