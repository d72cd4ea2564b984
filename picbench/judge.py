"""The comparison that decides ``correct``, run once the window has closed
and the program's device state is freed.

The reference cannot follow the program through the window: float32 and
float64 particles part across cell faces within steps.  So it checks the
start by itself (the state after set-up against its own initialization
from the deck's inputs), then follows the program step by step from the
program's own state over the compared units, and checks the steps between
(those of the window, unseen) by the charge they must conserve
(``gauss``) and the books.  A control puts the reference, computed in a
lower float type, in the program's place (:func:`readings` with
``control``).  The reference is the module that the configuration names
under ``"reference"`` (:func:`reference`; without the key ``pic``, the
periodic box)."""

from __future__ import annotations

import gc
import importlib
import sys
import time

import torch

from picbench import compare, spec, state


def config_module(name: str):
    return importlib.import_module(f"picbench.configs.{name}")


def reference(cfg: dict):
    """The plain reference that judges configuration ``cfg``: the module
    ``picbench/reference/<cfg["reference"]>.py``, ``pic`` without the
    key."""
    name = cfg.get("reference", "pic")
    if not spec.NAME.match(name) or "." in name:
        raise ValueError(f"bad reference name {name!r}")
    return importlib.import_module(f"picbench.reference.{name}")


def _advance(mod, F, species, box, start, stop, cleans):
    for t in range(start, stop):
        F, species = mod.step(F, species, box, t, cleans)
    return F, species


def _cast(F, species, dtype):
    return ({c: v.to(dtype) for c, v in F.items()},
            [dict(sp, off=sp["off"].to(dtype), u=sp["u"].to(dtype),
                  q=sp["q"].to(dtype)) for sp in species])


def readings(cfg: dict, seed: int, start: dict, units: list, device,
             control=None, pairs=()) -> dict:
    """The numbers of :mod:`picbench.compare`.  ``start``: the snapshot
    after set-up; ``units``: the snapshots around the compared units, in
    order (each unit from one to the next); ``pairs``: more compared
    units, each a snapshot before it and the :func:`state.summary` after
    it.  ``control``: a float type: the reference computed in it takes
    the program's place."""
    ref, conf = reference(cfg), config_module(cfg["name"])
    box = conf.box(cfg)
    q_m = {s["name"]: s["q_m"] for s in cfg["species"]}
    cleans = cfg["cleans"]
    f64 = torch.float64
    clock = [time.perf_counter()]

    def lap(what):
        t = time.perf_counter()
        print(f"judge: {what} {t - clock[0]:.3f} s", file=sys.stderr,
              flush=True)
        clock[0] = t

    inp = conf.inputs(cfg, seed, box, device)
    lap("inputs")
    counts = [len(s["q"]) for s in inp["species"]]
    F0, S0 = ref.initial_state(inp, box, f64, device)
    if control is None:
        Fc, Sc = state.to_reference(start, box, q_m, torch.float32, device,
                                    ref)
    else:
        Fc, Sc = ref.initial_state(inp, box, control, device)
    del inp
    lap("initial state")
    out = {}
    out["start_pos"], out["start_u"] = compare.lane_gaps(Sc, S0, box, ref)
    out["start_fields"] = compare.field_gap(Fc, F0, (ref.E, ref.B))
    rhob, scale = F0["rhob"], compare.charge_scale(S0, box, ref)
    del F0, S0, Fc, Sc
    gc.collect()
    lap("start")

    out["fields"] = out["moments"] = 0.0
    gauss = []
    if control is None:
        Fa, Sa = state.to_reference(units[0], box, q_m, torch.float32,
                                    device, ref)
        gauss.append(compare.gauss_gap(Fa, Sa, rhob, box, scale, ref))
        del Fa, Sa
    for a, b in list(pairs) + list(zip(units[:-1], units[1:])):
        Fa, Sa = state.to_reference(a, box, q_m, f64, device, ref)
        Fa["rhob"] = rhob
        if control is None and "moments" in b:
            Fc = {c: b["fields"][c][ref.planes(c, box)].to(device).double()
                  for c in ref.E + ref.B + ref.J}
            Sc = b["moments"]
        elif control is None:
            Fc, Sc = state.to_reference(b, box, q_m, torch.float32, device,
                                        ref)
        else:
            Fc, Sc = _advance(ref, *_cast(Fa, Sa, control), box, a["step"],
                              b["step"], cleans)
        Fr, Sr = _advance(ref, Fa, Sa, box, a["step"], b["step"], cleans)
        del Fa, Sa
        out["fields"] = max(out["fields"], compare.field_gap(
            Fc, Fr, (ref.E, ref.B, ref.J)))
        out["moments"] = max(out["moments"],
                             compare.moment_gap(Sc, Sr, box, ref))
        gauss.append(compare.gauss_gap(
            Fc, b["rhof"] if control is None and "rhof" in b else Sc,
            rhob, box, scale, ref))
        del Fc, Sc, Fr, Sr
        gc.collect()
        lap(f"unit from step {a['step']}")
    out["gauss"] = max(gauss)
    snaps = ([start] + units + [b for _, b in pairs] if control is None
             else [])
    out["live"] = max([abs(sum(sp["np"] for sp in s["species"])
                           - sum(counts)) for s in snaps], default=0)
    out["dropped"] = max([sum(sp["nm"] for sp in s["species"])
                          for s in snaps], default=0)
    return out


def verdict(numbers: dict, limits: dict) -> bool:
    """Every number at or under its limit; a number without a limit, or
    one that is not a number (NaN), fails."""
    return all(k in limits and v <= limits[k] for k, v in numbers.items())
