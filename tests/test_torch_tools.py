"""The port's harness tools (``vpic_tpu_torch/tools/{evidence,
scaling_bench,profile_step}.py``) against the JAX package's
(``tools/{evidence,scaling_bench,profile_step}.py``) on the CPU.

- Evidence: the JAX tool runs as a copy in a temporary ``tools/``
  directory, in a subprocess with the repository on ``PYTHONPATH``, so
  that it appends its record to the temporary directory's
  ``EVIDENCE.jsonl``; the port runs twice through its ``main`` with
  ``--out``.  Two sizes: the bench deck at 16^2 with 4096 particles over 8
  steps, where the current sheet (width 0.1 of the box) spans a few cells
  and the total energy changes by 1.07e-3 in both packages (SUSPECT), and
  at 128^2 over 16 steps (8.7e-5: OK).  Held: the same steps, energy0 to
  1e-6 relative (both load bit-identical particles), the drifts to 1e-6
  absolute of each other (``BASELINE.md:21``), the count conserved and no
  dropped mover on both sides, the same verdict and the port's exit
  status with it, every key of the JAX record, the repository's
  ``EVIDENCE.jsonl`` unchanged, and the same checksums from two port runs
  of one seed (they need not equal the JAX package's: the port sums rho in
  fixed point).
- The sweep: the JAX tool's configurations, CSV header and ``SCALE_ONLY``
  selection (its ``main`` run with a stand-in deck that records what it
  is asked to build), and ``sweep`` on the CPU at two small sizes.
- The profile: the busy-time union and the attribution of device ops to
  step parts on synthetic events, and ``main`` on a 16^2 deck on the CPU.
"""

import contextlib
import io
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType

import __graft_entry__ as ge
import chip_smoke
import tools.scaling_bench as jax_sweep
from vpic_tpu_torch.tools import evidence as ev
from vpic_tpu_torch.tools import profile_step as ps
from vpic_tpu_torch.tools import scaling_bench as sb

from tests import torch_decks  # noqa: F401  (one torch thread)

ROOT = Path(__file__).resolve().parents[1]
# (steps, npart_total, nx) and the verdict both tools give
EVIDENCE_CASES = {"16sq": (("8", "4096", "16"), "SUSPECT"),
                  "128sq": (("16", "4096", "128"), "OK")}
DRIFT_BAR = 1e-6


def verdict(stdout):
    return [line for line in stdout.splitlines()
            if line.startswith("EVIDENCE ")][-1]


@pytest.fixture(scope="module", params=list(EVIDENCE_CASES))
def evidence_runs(request, tmp_path_factory):
    args, expected = EVIDENCE_CASES[request.param]
    tmp = tmp_path_factory.mktemp("evidence")
    (tmp / "tools").mkdir()
    shutil.copy(ROOT / "tools" / "evidence.py", tmp / "tools")
    repo_file = ROOT / "EVIDENCE.jsonl"
    before = repo_file.read_bytes()
    env = dict(os.environ, PYTHONPATH=str(ROOT), JAX_PLATFORMS="cpu")
    proc = subprocess.Popen(
        [sys.executable, str(tmp / "tools" / "evidence.py"), *args],
        cwd=tmp, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    try:
        out = tmp / "port.jsonl"
        rcs, said = [], []
        for _ in range(2):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rcs.append(ev.main([*args, "--device", "cpu", "--out",
                                    str(out)]))
            said.append(verdict(buf.getvalue()))
    finally:
        stdout, stderr = proc.communicate(timeout=600)
    assert proc.returncode == 0, stderr
    jax_lines = (tmp / "EVIDENCE.jsonl").read_text().splitlines()
    assert len(jax_lines) == 1
    return dict(expected=expected, steps=int(args[0]),
                jax=json.loads(jax_lines[0]), jax_said=verdict(stdout),
                port=[json.loads(x) for x in out.read_text().splitlines()],
                rcs=rcs, said=said,
                repo_unchanged=repo_file.read_bytes() == before)


def test_evidence_matches_the_jax_tool(evidence_runs):
    jax_rec, port = evidence_runs["jax"], evidence_runs["port"][0]
    assert port["backend"] == "cpu" and port["device"] == "cpu"
    assert port["steps"] == jax_rec["steps"] == evidence_runs["steps"]
    assert port["deck"] == jax_rec["deck"]
    assert abs(port["energy0"] - jax_rec["energy0"]) <= \
        1e-6 * abs(jax_rec["energy0"])
    assert abs(port["drift"] - jax_rec["drift"]) <= DRIFT_BAR
    for rec in (jax_rec, port):
        assert rec["np_conserved"] is True
        assert rec["dropped_movers"] == {"electron": 0, "ion": 0}


def test_evidence_verdict_is_the_jax_tools(evidence_runs):
    want = "EVIDENCE " + evidence_runs["expected"]
    assert evidence_runs["jax_said"] == want
    assert evidence_runs["said"] == [want, want]
    assert ev.is_ok(evidence_runs["jax"]) == \
        ev.is_ok(evidence_runs["port"][0]) == (want == "EVIDENCE OK")
    assert evidence_runs["rcs"] == [0 if want == "EVIDENCE OK" else 1] * 2


def test_evidence_record_has_the_jax_keys(evidence_runs):
    jax_rec, port = evidence_runs["jax"], evidence_runs["port"][0]
    assert set(jax_rec) <= set(port)
    assert set(port["knobs"]) == set(jax_rec["knobs"]) - {"fix_cap"}
    for k in ("resort", "ion_mult", "n_walk", "env"):
        assert port["knobs"][k] == jax_rec["knobs"][k], k
    assert set(port["species_sha1"]) == set(jax_rec["species_sha1"])


def test_evidence_repeats_and_writes_only_out(evidence_runs):
    one, two = evidence_runs["port"]
    assert one["field_sha1"] == two["field_sha1"]
    assert one["species_sha1"] == two["species_sha1"]
    assert one["energy1"] == two["energy1"]
    assert evidence_runs["repo_unchanged"]


def test_is_ok_follows_the_jax_rule():
    rec = dict(np_conserved=True, drift=9.9e-5,
               dropped_movers={"electron": 0, "ion": 0})
    assert ev.is_ok(rec)
    assert not ev.is_ok(dict(rec, drift=-1e-4))
    assert not ev.is_ok(dict(rec, np_conserved=False))
    assert not ev.is_ok(dict(rec, dropped_movers={"electron": 0, "ion": 3}))
    assert not ev.is_ok(dict(rec, drift=None))


def test_sweep_configs_are_the_jax_tools():
    assert sb.CONFIGS == jax_sweep.CONFIGS


def jax_sweep_main(mp, only, capsys):
    """tools/scaling_bench.py's main under SCALE_ONLY=``only`` with a
    stand-in for the deck build: the (npart_total, nx, ny, nz) it asks
    for, and its CSV header."""
    asked = []

    def build(nx, ny, nz, npart, **kw):
        asked.append((2 * npart, nx, ny, nz))
        return SimpleNamespace(
            opts=SimpleNamespace(resort_interval=2), advance=lambda n: None,
            state=SimpleNamespace(species=[SimpleNamespace(
                np=np.int32(npart))] * 2))

    mp.setattr(ge, "_build", build)
    mp.setattr(sys, "argv", ["scaling_bench.py", "2"])
    if only is None:
        mp.delenv("SCALE_ONLY", raising=False)
    else:
        mp.setenv("SCALE_ONLY", only)
    capsys.readouterr()
    jax_sweep.main()
    return asked, capsys.readouterr().out.splitlines()[0]


@pytest.mark.parametrize("only", ["128", "512", "64x64x64", "256", None])
def test_scale_only_selects_as_the_jax_tool(monkeypatch, capsys, only):
    asked, _ = jax_sweep_main(monkeypatch, only, capsys)
    assert sb.selected(sb.CONFIGS, only) == asked
    assert asked


def test_sweep_header_is_the_jax_tools(monkeypatch, capsys):
    _, header = jax_sweep_main(monkeypatch, "no such size", capsys)
    assert sb.HEADER == header
    monkeypatch.setenv("SCALE_ONLY", "no such size")
    assert sb.main(["--device", "cpu"]) == 0
    assert capsys.readouterr().out.splitlines() == [header]


def test_sweep_rows_on_the_cpu():
    configs = [(4096, 16, 16, 1), (4096, 8, 8, 8)]
    rows = []
    for (row, sim), cfg in zip(sb.sweep(configs, 10, "cpu"), configs):
        assert sim.mover_counts() == {"electron": 0, "ion": 0}
        assert (sim.grid.nx, sim.grid.ny, sim.grid.nz) == cfg[1:]
        assert sim.step_count == row["period"] + 2 * row["nst"]
        rows.append(sb.csv_row(row))
    assert len(rows) == 2
    for line, cfg in zip(rows, configs):
        cols = line.split(",")
        assert len(cols) == len(sb.HEADER.split(","))
        assert tuple(int(c) for c in cols[:4]) == cfg
        ms, pps, ratio = (float(c) for c in cols[4:])
        # the JAX tool's formats: 4 significant digits of pushes/s and
        # two decimals of the ratio
        assert ms > 0 and pps > 0
        assert ratio == pytest.approx(pps / sb.REF_CPU_PUSHES_PER_S,
                                      abs=0.005)


def test_busy_us_is_the_union_of_intervals():
    assert ps._busy_us([]) == 0.0
    assert ps._busy_us([(0.0, 2.0), (1.0, 3.0)]) == 3.0      # overlapping
    assert ps._busy_us([(0.0, 10.0), (2.0, 3.0)]) == 10.0    # nested
    assert ps._busy_us([(5.0, 6.0), (0.0, 1.0)]) == 2.0      # disjoint
    assert ps._busy_us([(0.0, 1.0), (1.0, 2.0), (1.5, 4.0)]) == 4.0


def _event(name, device_type, eid, start, end):
    return SimpleNamespace(name=name, device_type=device_type, id=eid,
                           is_user_annotation=False,
                           time_range=SimpleNamespace(start=start, end=end))


def test_step_parts_place_ops_by_their_launch_call():
    cpu, cuda = DeviceType.CPU, DeviceType.CUDA
    events = [
        _event("step.push", cpu, 100, 0.0, 100.0),
        _event("step.sort", cpu, 101, 100.0, 200.0),
        _event("cudaLaunchKernel", cpu, 1, 50.0, 51.0),    # in step.push
        _event("cuLaunchKernel", cpu, 2, 150.0, 151.0),    # in step.sort
        _event("cudaLaunchKernel", cpu, 3, 250.0, 251.0),  # outside
        _event("not_a_launch", cpu, 4, 60.0, 61.0),
    ]
    dev = [_event(f"kernel{i}", cuda, i, 300.0 + i, 301.0 + i)
           for i in (1, 2, 3, 4)]
    parts, placed = ps._step_parts(events, dev)
    assert parts == ["step.push", "step.sort", None, None]
    assert placed == 3


def test_breakdown_sums_per_step_and_part():
    """Two steps of synthetic device ops: busy time is the union (the
    overlapping field ops count once), each part's busy time the union of
    its own ops, and per op name its total, count and main part."""
    cuda = DeviceType.CUDA
    ops = [_event("sortk", cuda, 1, 0.0, 100.0),
           _event("pushk", cuda, 2, 100.0, 400.0),
           _event("fieldk", cuda, 3, 400.0, 600.0),
           _event("fieldk", cuda, 4, 500.0, 700.0),
           _event("pushk", cuda, 5, 1000.0, 1100.0),
           _event("stray", cuda, 6, 2000.0, 2020.0)]
    for e in ops:
        e.time_range.elapsed_us = (lambda r=e.time_range: r.end - r.start)
    parts = ["step.sort", "step.push", "step.field", "step.field",
             "step.field", None]
    b = ps.breakdown(ops, parts, steps=2)
    assert b["busy_ms"] == pytest.approx((700 + 100 + 20) / 2 / 1e3)
    assert b["ops"] == 3.0
    assert b["parts"]["step.sort"] == pytest.approx(0.05)
    assert b["parts"]["step.push"] == pytest.approx(0.15)
    assert b["parts"]["step.field"] == pytest.approx((300 + 100) / 2e3)
    assert b["parts"][None] == pytest.approx(0.01)
    assert b["part_ops"]["step.field"] == 1.5
    assert b["part_ops"]["step.emit"] == 0.0
    assert b["op_ms"] == pytest.approx(dict(sortk=0.1, pushk=0.4,
                                            fieldk=0.4, stray=0.02))
    assert b["op_count"] == dict(sortk=1, pushk=2, fieldk=2, stray=1)
    assert b["op_part"]["pushk"] == "step.push"
    assert b["op_part"]["stray"] is None


def test_family_strips_arguments_and_suffixes():
    assert ps.family("void at::native::vectorized_elementwise_kernel<4, "
                     "at::native::AddFunctor<float>>(int, float)") == \
        "at::native::vectorized_elementwise_kernel"
    assert ps.family("Memcpy DtoH (Device -> Pageable)") == "Memcpy DtoH"
    assert ps.family("fusion.12") == "fusion"
    assert ps.family("push_walk_kernel(float*, int)") == "push_walk_kernel"


def test_chip_smoke_uses_the_tools_attribution():
    assert chip_smoke.profiled is ps.profiled
    assert chip_smoke._busy_us is ps._busy_us
    assert chip_smoke._step_parts is ps._step_parts


def test_profile_main_on_the_cpu(monkeypatch, capsys, tmp_path):
    def no_cuda(*a, **k):
        raise AssertionError("torch.cuda called on the CPU")

    monkeypatch.setattr(torch.cuda, "synchronize", no_cuda)
    monkeypatch.setattr(torch.cuda, "get_device_name", no_cuda)
    monkeypatch.setenv("PROF_DIR", str(tmp_path))
    rep = ps.main(["4096", "16", "2", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "CPU ops only" in out.splitlines()[0]
    for title in ("== busy CPU ms per step part", "== the 50 busiest CPU ops",
                  "== long tail by op family"):
        assert title in out, title
    assert rep["device"] == "cpu" and rep["steps"] == 2
    for part in ("step.sort", "step.push", "step.field"):
        assert rep["parts"][part] > 0, part
    assert rep["busy_ms"] >= max(rep["parts"].values())
    assert rep["top"] and all(n.startswith("aten::") for n in rep["top"])
    assert Path(rep["trace"]).parent == tmp_path
    assert json.loads(Path(rep["trace"]).read_text())["traceEvents"]
