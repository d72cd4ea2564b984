"""The harness's own guards: the whole-name check for JAX and the JAX
package, no result without a card (no CPU fallback), and no result from
a directory that holds only the benchmark."""

import ast
import os
import shutil
import subprocess
import sys
import types

import pytest

from picbench import run, spec
from picbench.tests.conftest import SMALL

ROOT = spec.ROOT
CMD = spec.benchmark()["command"]
ARGS = ["--workload", "fan_run.steps", "--seed", str(2 ** 31 + 5),
        "--seconds", "1", "--trace", "0"]


@pytest.mark.parametrize("modules,found", [
    (["vpic_tpu_torch", "vpic_tpu_torch.deck.api", "picbench.run"], []),
    (["vpic_tpu", "numpy"], ["vpic_tpu"]),
    (["vpic_tpu.core.types"], ["vpic_tpu"]),
    (["jax.numpy", "jaxlib.xla_client", "flax.linen"],
     ["flax", "jax", "jaxlib"]),
    (["jax_extras", "vpic_tpu_tools", "myjax"], []),
])
def test_forbidden_compares_whole_top_level_names(modules, found):
    assert run.forbidden(modules) == found


@pytest.mark.parametrize("module", ["jax", "vpic_tpu"])
@pytest.mark.parametrize("name", sorted(SMALL))
def test_a_loaded_jax_module_gives_no_result(name, module, monkeypatch):
    monkeypatch.setitem(sys.modules, module, types.ModuleType(module))
    assert run.run_cell(name, 3, 0.2, 0, device="cpu",
                        overrides=SMALL[name]) is None


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(ROOT)) for d in ("reference", "configs")
    for p in (ROOT / "picbench" / d).glob("*.py")))
def test_the_references_import_neither_the_program_nor_jax(path):
    tree = ast.parse((ROOT / path).read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names.add(node.module or "")
    top = {n.split(".")[0] for n in names}
    assert not top & {"jax", "jaxlib", "flax", "vpic_tpu",
                      "vpic_tpu_torch"}, (path, sorted(names))


@pytest.mark.parametrize("name", sorted(SMALL))
def test_a_run_loads_neither_jax_nor_the_jax_package(name):
    code = ("import sys; from picbench import run; "
            "from picbench.tests.conftest import SMALL; "
            f"n = {name!r}; "
            "out = run.run_cell(n, 9, 0.2, 0, device='cpu', "
            "overrides=SMALL[n]); "
            "assert out is not None and out['correct']; "
            "print(run.forbidden(sys.modules))")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip().splitlines()[-1] == "[]"


def _no_card_env():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.pop("PYTHONPATH", None)
    return env


def test_no_card_no_result():
    r = subprocess.run(CMD + ARGS, cwd=ROOT, capture_output=True, text=True,
                       timeout=300, env=_no_card_env())
    assert r.returncode != 0
    assert r.stdout == ""


def _bare(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    for p in spec.benchmark()["paths"]:
        shutil.copytree(ROOT / p, tmp_path / p,
                        ignore=shutil.ignore_patterns("__pycache__"))
    return tmp_path


def test_the_benchmark_alone_gives_no_result(tmp_path):
    r = subprocess.run(CMD + ARGS, cwd=_bare(tmp_path), capture_output=True,
                       text=True, timeout=300, env=_no_card_env())
    assert r.returncode != 0
    assert r.stdout == ""


@pytest.mark.cuda
def test_the_benchmark_alone_gives_no_result_on_the_card(tmp_path, card):
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    r = subprocess.run(CMD + ARGS, cwd=_bare(tmp_path), capture_output=True,
                       text=True, timeout=300, env=env)
    assert r.returncode != 0
    assert r.stdout == ""
