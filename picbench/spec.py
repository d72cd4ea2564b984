"""The benchmark as data: ``BENCHMARK.json`` at the checkout's root, and
under ``picbench/`` one file per piece, found by its name there:
``configs/<config>.json`` (and its reference inputs ``configs/<config>.py``),
``traffic/<traffic>.json``, ``cells/<workload>.json`` (the limits of its
compared numbers) and ``metrics/<metric>.py``."""

from __future__ import annotations

import json
import re
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def benchmark() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def _load(kind: str, name: str) -> dict:
    if not NAME.match(name):
        raise ValueError(f"bad {kind} name {name!r}")
    return json.loads((HERE / kind / f"{name}.json").read_text())


def workload(name: str, bench: dict = None) -> dict:
    """The workload entry, its configuration, traffic and cell files."""
    bench = bench or benchmark()
    found = [w for w in bench["workloads"] if w["name"] == name]
    if not found:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = found[0]
    return dict(entry=w, config=_load("configs", w["config"]),
                traffic=_load("traffic", w["traffic"]),
                cell=_load("cells", name))


def metrics_of(name: str, kind: str, bench: dict = None) -> list:
    """The ``end_to_end`` or ``per_layer`` metrics that workload ``name``
    reports."""
    bench = bench or benchmark()
    return [m for m in bench[kind] if name in m.get("workloads", [name])]


def merged(base: dict, over: dict) -> dict:
    """``base`` with ``over`` laid on it, nested dicts merged."""
    out = dict(base)
    for k, v in over.items():
        out[k] = (merged(out[k], v) if isinstance(v, dict)
                  and isinstance(out.get(k), dict) else v)
    return out
