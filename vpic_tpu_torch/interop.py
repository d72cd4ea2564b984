"""Simulation state <-> a flat dict of numpy arrays.

:func:`state_to_numpy` reads either package's ``SimState`` by attribute
(``np.asarray`` turns a JAX array into numpy without this module importing
JAX), so a state built by ``vpic_tpu`` can be loaded into the port with
:func:`state_from_numpy` and both packages can start from one state.

Keys: ``field/<component>``, ``interpolator``, ``neighbor``,
``materials/<column>``, ``step``, per species k ``species/<k>/<column>``
for the particle columns, ``np``, ``nm`` and the static ``name``, ``sid``,
``max_np``, ``sort_interval`` and ``q_m``; per boundary handler h its
state, ``boundary_state/<h>`` (an array) or ``boundary_state/<h>/<key>``
(a dict of arrays); and ``rng``, the port's random state (the JAX
package's ``jax.random`` key has no counterpart and is not carried: a
state loaded from it takes the ``rng`` given to :func:`state_from_numpy`).
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
    if isinstance(getattr(state, "rng", None), torch.Tensor):
        d["rng"] = to_numpy(state.rng)
    for h, hs in enumerate(getattr(state, "boundary_state", ())):
        if isinstance(hs, dict):
            d.update({f"boundary_state/{h}/{k}": to_numpy(v)
                      for k, v in hs.items()})
        else:
            d[f"boundary_state/{h}"] = to_numpy(hs)
    for k, sp in enumerate(state.species):
        pre = f"species/{k}/"
        for c in SPECIES_COLUMNS + ("np", "nm"):
            d[pre + c] = to_numpy(getattr(sp, c))
        for c in _STATIC:
            d[pre + c] = getattr(sp, c)
        d[pre + "q_m"] = np.float32(to_numpy(sp.q_m))
    return d


def _boundary_state(d: dict, t) -> tuple:
    out, h = [], 0
    while True:
        pre = f"boundary_state/{h}"
        if pre in d:
            out.append(t(d[pre]))
        else:
            keys = [k for k in d if k.startswith(pre + "/")]
            if not keys:
                return tuple(out)
            out.append({k[len(pre) + 1:]: t(d[k]) for k in sorted(keys)})
        h += 1


def state_from_numpy(d: dict, device="cpu", rng=None) -> SimState:
    """The port's state from :func:`state_to_numpy`'s dict, on ``device``.
    Its random state (on the host) is ``d``'s, or, where ``d`` holds none
    (a state of the JAX package), ``rng`` (``core.random.make_key(seed)``);
    without either it is None, and a step that draws raises."""
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
        step=t(d["step"]),
        rng=torch.as_tensor(np.array(d["rng"])) if "rng" in d else rng,
        boundary_state=_boundary_state(d, t))
