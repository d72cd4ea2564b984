"""Simulation state <-> a flat dict of numpy arrays.

:func:`state_to_numpy` reads either package's ``SimState`` by attribute
(``np.asarray`` turns a JAX array into numpy without this module importing
JAX), so a state built by ``vpic_tpu`` can be loaded into the port with
:func:`state_from_numpy` and both packages can start from one state.

Keys: ``field/<component>``, ``interpolator``, ``neighbor``,
``materials/<column>``, ``material_grid/<id field>`` (int32, only for a
state with a material grid), ``step``, per species k ``species/<k>/<column>``
for the particle columns, ``np``, ``nm`` and the static ``name``, ``sid``,
``max_np``, ``sort_interval`` and ``q_m``; per boundary handler h its
state, ``boundary_state/<h>`` (an array) or ``boundary_state/<h>/<key>``
(a dict of arrays); and ``rng``, the two uint32 words of the state's
``jax.random`` key (``jax.random.key_data``; the port holds them as int64).
A JAX state's typed key is not read here, since reading it needs JAX: the
caller adds ``d["rng"] = jax.random.key_data(state.rng)``.

Several shards: the JAX package stacks them into one state whose every
leaf has leading ``(gpz, gpy, gpx)`` axes (``distributed.stack_shards``);
the port holds a list in rank order.  :func:`states_to_numpy` and
:func:`states_from_numpy` go between the list and the stacked dict, whose
species' ``name``, ``sid``, ``max_np`` and ``sort_interval`` are not
stacked (``q_m`` is, as it is a leaf of the JAX package's state).
"""

from __future__ import annotations

import numpy as np
import torch

from .core.types import (
    FIELD_COMPONENTS,
    MATERIAL_COLUMNS,
    MATERIAL_ID_FIELDS,
    SPECIES_COLUMNS,
    FieldState,
    GridArrays,
    MaterialGrid,
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
    d = {f"field/{k}": to_numpy(getattr(state.field, k)) for k in FIELD_COMPONENTS}
    d["interpolator"] = to_numpy(state.interpolator)
    d["neighbor"] = to_numpy(state.grid_arrays.neighbor)
    d.update({f"materials/{k}": to_numpy(getattr(state.materials, k))
              for k in MATERIAL_COLUMNS})
    matg = getattr(state, "material_grid", None)
    if matg is not None:
        d.update({f"material_grid/{k}": to_numpy(getattr(matg, k))
                  for k in MATERIAL_ID_FIELDS})
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
    Its random state is ``rng`` where given (an override:
    ``core.random.make_key(seed)``), else ``d["rng"]`` (the key's two
    words); without either it is None, and a step that draws raises."""
    t = lambda a: torch.as_tensor(np.array(a), device=device)
    if rng is None and "rng" in d:
        rng = np.asarray(d["rng"]).astype(np.int64)
    if rng is not None:
        rng = torch.as_tensor(rng, dtype=torch.int64, device=device)
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
        rng=rng,
        boundary_state=_boundary_state(d, t),
        material_grid=(MaterialGrid(**{k: t(d[f"material_grid/{k}"])
                                       for k in MATERIAL_ID_FIELDS})
                       if "material_grid/ematx" in d else None))


def _static(key: str) -> bool:
    return key.startswith("species/") and key.rsplit("/", 1)[1] in _STATIC


def stack_numpy(dicts: list, shards: tuple) -> dict:
    """Per-shard dicts in rank order -> one dict whose arrays carry the
    leading ``shards`` = (gpz, gpy, gpx) axes; one shard's dict as it is
    (the JAX package stacks only the states of a mesh)."""
    if len(dicts) == 1:
        return dicts[0]
    return {k: v if _static(k) else
            np.stack([d[k] for d in dicts]).reshape(shards + np.shape(v))
            for k, v in dicts[0].items()}


def unstack_numpy(d: dict, n: int) -> list:
    """:func:`stack_numpy`'s inverse for ``n`` shards."""
    if n == 1:
        return [d]
    flat = {k: v if _static(k) else
            np.asarray(v).reshape((n,) + np.shape(v)[3:])
            for k, v in d.items()}
    return [{k: v if _static(k) else v[r] for k, v in flat.items()}
            for r in range(n)]


def states_to_numpy(states, shards: tuple) -> dict:
    """The stacked dict of per-shard states (the port's list in rank
    order, or a stacked JAX state as it is)."""
    if not isinstance(states, (list, tuple)):
        return state_to_numpy(states)
    return stack_numpy([state_to_numpy(st) for st in states], shards)


def states_from_numpy(d: dict, n: int, devices, rngs=None) -> list:
    """The port's per-shard states (rank order) from a stacked dict, shard
    r on ``devices[r % len(devices)]``; ``rngs``: each shard's random
    state in place of ``d``'s (an override)."""
    return [state_from_numpy(one, devices[r % len(devices)],
                             None if rngs is None else rngs[r])
            for r, one in enumerate(unstack_numpy(d, n))]
