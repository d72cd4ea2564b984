"""BENCHMARK.json and the files it names: the contract's keys, names and
units, and every cell, configuration, traffic and metric resolving by
name."""

import importlib
import json
import re

import pytest

from picbench import spec

B = spec.benchmark()
TOP = {"command", "paths", "run_seconds", "configs", "workloads",
       "end_to_end", "per_layer"}
LINE = re.compile(r"^[^\t\n]{1,200}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


def test_top_level_keys_and_limits():
    assert set(B) == TOP
    assert 1 <= B["run_seconds"] <= 51 and isinstance(B["run_seconds"], int)
    assert 1 <= len(B["paths"]) <= 16
    assert all(PATH.match(p) and ".." not in p and not p.startswith("/")
               for p in B["paths"])
    assert 1 <= len(B["command"]) <= 32
    assert all(LINE.match(w) for w in B["command"])
    assert len(json.dumps(B)) <= 64 * 1024


def _names():
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in B[kind]:
            yield kind, e["name"]
    for w in B["workloads"]:
        yield "config", w["config"]
        yield "traffic", w["traffic"]
    for c in B["configs"]:
        for k in c["reduced"]:
            yield "reduced", k


@pytest.mark.parametrize("kind,name", list(_names()))
def test_names_use_the_allowed_characters(kind, name):
    assert spec.NAME.match(name), (kind, name)


def test_names_are_unique():
    for kind in ("configs", "workloads"):
        names = [e["name"] for e in B[kind]]
        assert len(names) == len(set(names))
    metrics = [m["name"] for m in B["end_to_end"] + B["per_layer"]]
    assert len(metrics) == len(set(metrics))


@pytest.mark.parametrize("m", B["end_to_end"] + B["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_entries(m):
    assert spec.UNIT.match(m["unit"])
    assert m["better"] in ("lower", "higher")
    if m in B["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    else:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert LINE.match(m["layer"])
        assert m["moves"] in [e["name"] for e in B["end_to_end"]]
        # a reader of its own
        importlib.import_module(f"picbench.metrics.{m['name']}").read
    if m["name"].endswith("_roofline"):
        assert m["unit"] == "%"


def test_setup_s_is_an_end_to_end_metric():
    assert "setup_s" in [m["name"] for m in B["end_to_end"]]


@pytest.mark.parametrize("w", B["workloads"], ids=lambda w: w["name"])
def test_cells_resolve_by_name(w):
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    assert w["chips"] in (1, 4) and LINE.match(w["why"])
    got = spec.workload(w["name"], B)
    assert got["config"]["name"] == w["config"]
    assert set(got["cell"]["limits"]) == {
        "start_pos", "start_u", "start_fields", "fields", "moments",
        "gauss", "live", "dropped"}
    assert got["cell"]["limits"]["live"] == 0
    assert got["cell"]["limits"]["dropped"] == 0
    # every cell reports setup_s, another end-to-end metric and a
    # per-layer metric
    e2e = [m["name"] for m in spec.metrics_of(w["name"], "end_to_end", B)]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert spec.metrics_of(w["name"], "per_layer", B)


@pytest.mark.parametrize("c", B["configs"], ids=lambda c: c["name"])
def test_configs_resolve_by_name(c):
    assert set(c) == {"name", "source", "file", "reduced", "why"}
    assert c["file"] == f"picbench/configs/{c['name']}.json"
    assert c["file"].startswith(tuple(p + "/" for p in B["paths"]))
    cfg = json.loads((spec.ROOT / c["file"]).read_text())
    assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
    assert cfg["source"] == c["source"]
    # each knob and argument of the deck names the key that sizes it (or
    # the run's seed): every size is stated once
    knobs = {**cfg["deck"].get("env", {}), **cfg["deck"].get("kwargs", {})}
    assert all(k == "seed" or k in cfg for k in knobs.values())
    assert len(c["reduced"]) <= 16
    assert c["name"] in [w["config"] for w in B["workloads"]]
    mod = importlib.import_module(f"picbench.configs.{c['name']}")
    box = mod.box(cfg)
    assert box.cells == cfg["nx"] * cfg.get("ny", 1) * cfg["nz"]


def test_four_chip_cells_are_few():
    four = [w for w in B["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(B["workloads"]) // 4)


def test_a_bad_name_is_refused():
    with pytest.raises(ValueError):
        spec._load("cells", "../BENCHMARK")
