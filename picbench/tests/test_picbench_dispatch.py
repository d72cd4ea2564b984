"""The reference that judges a configuration is the module it names under
``"reference"`` (``picbench/reference/<name>.py``), ``pic`` without the
key: a configuration that names a stub module is judged by it, and
``fan_run``, which names none, by ``pic``."""

import sys
import types

import pytest
import torch

from picbench import judge, run, spec
from picbench.reference import pic
from picbench.tests.conftest import SMALL

NAME = "fan_run.steps"
SEED = 2 ** 31 + 211
INTERFACE = ("E", "B", "J", "BLOCK", "Box", "initial_state", "step", "rho",
             "div_e", "node_deposit", "nodes", "planes", "wraps", "settled")


@pytest.mark.parametrize("c", spec.benchmark()["configs"],
                         ids=lambda c: c["name"])
def test_each_configuration_names_a_reference_with_the_interface(c):
    cfg = spec.workload([w["name"] for w in spec.benchmark()["workloads"]
                         if w["config"] == c["name"]][0])["config"]
    ref = judge.reference(cfg)
    assert ref.__name__ == "picbench.reference." + cfg.get("reference",
                                                           "pic")
    for k in INTERFACE:
        assert hasattr(ref, k), k
    # the configuration's module draws its inputs for that reference
    assert type(judge.config_module(cfg["name"]).box(cfg)) is ref.Box


def test_fan_run_names_no_reference_and_is_judged_by_pic():
    cfg = spec.workload(NAME)["config"]
    assert "reference" not in cfg
    assert judge.reference(cfg) is pic


@pytest.mark.parametrize("bad", ["../run", "pic.x", "", "a b"])
def test_a_bad_reference_name_is_refused(bad):
    with pytest.raises(ValueError):
        judge.reference({"reference": bad})


@pytest.fixture(scope="module")
def snapshots():
    """One small run of fan_run: the start and the compared units."""
    cell = run.Cell(NAME, SEED, 0.2, "cpu", SMALL[NAME])
    cell.setup()
    cell.window(0.05)
    units = cell.compared_units()
    cell.release()
    return cell.cfg, cell.start, units


def _stub(monkeypatch, step):
    """``picbench.reference.stub``: ``pic`` with its own ``step``."""
    stub = types.ModuleType("picbench.reference.stub")
    stub.__dict__.update({k: v for k, v in vars(pic).items()
                          if not k.startswith("__")})
    stub.step = step
    monkeypatch.setitem(sys.modules, "picbench.reference.stub", stub)
    return stub


def test_a_configuration_that_names_a_stub_is_judged_by_it(snapshots,
                                                          monkeypatch):
    cfg, start, units = snapshots
    steps = []

    def step(F, species, box, t, cleans):
        steps.append(t)
        return pic.step(F, species, box, t, cleans)

    stub = _stub(monkeypatch, step)
    named = dict(cfg, reference="stub")
    assert judge.reference(named) is stub
    plain = judge.readings(cfg, SEED, start, units, "cpu")
    assert not steps
    same = judge.readings(named, SEED, start, units, "cpu")
    assert steps == list(range(units[0]["step"], units[-1]["step"]))
    # the stub steps as pic does: the same numbers, bit for bit
    assert same == plain


def test_a_stub_that_steps_wrong_makes_the_program_incorrect(snapshots,
                                                             monkeypatch):
    cfg, start, units = snapshots

    def step(F, species, box, t, cleans):
        F, species = pic.step(F, species, box, t, cleans)
        return dict(F, ex=F["ex"] + 0.01 * torch.ones_like(F["ex"])), species

    _stub(monkeypatch, step)
    limits = spec.workload(NAME)["cell"]["limits"]
    plain = judge.readings(cfg, SEED, start, units, "cpu")
    wrong = judge.readings(dict(cfg, reference="stub"), SEED, start, units,
                           "cpu")
    assert judge.verdict(plain, limits), plain
    assert not judge.verdict(wrong, limits), wrong
    assert wrong["fields"] > limits["fields"]
