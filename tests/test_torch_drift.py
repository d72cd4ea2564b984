"""The port's drift comparison (``vpic_tpu_torch/tools/drift_compare.py``)
against the JAX package's (``tools/drift_compare.py``) on the CPU: the
bench deck at 16^2 with 4096 particles over 8 steps.

The JAX tool runs as a copy in a temporary ``tools/`` directory, in a
subprocess with the repository on ``PYTHONPATH``, so that it appends its
record to the temporary directory's ``EVIDENCE.jsonl``; the repository's
file is left as it was.  The port runs through its ``main`` with
``--out``.  Held: both drifts to 1e-6 absolute of the JAX record
(``BASELINE.md:21``), every relative field RMS against the float64
reference at most 1e-5 on both sides, no dropped mover on either side;
``fold_jf`` bitwise the tool's ``_fold_jf``; the mirrored state equal to
the JAX tool's mirror of the same deck (the momenta to float32
roundoff), particles as sets ordered by (voxel, position).
"""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import __graft_entry__ as ge
import tools.drift_compare as jax_drift
from vpic_tpu_torch.decks import bench_deck
from vpic_tpu_torch.tools import drift_compare as dc

from tests import torch_decks  # noqa: F401  (one torch thread)

ROOT = Path(__file__).resolve().parents[1]
ARGS = ("8", "4096", "16")
DRIFT_BAR = 1e-6
RMS_BAR = 1e-5


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("drift")
    (tmp / "tools").mkdir()
    shutil.copy(ROOT / "tools" / "drift_compare.py", tmp / "tools")
    evidence = ROOT / "EVIDENCE.jsonl"
    before = evidence.read_bytes()
    env = dict(os.environ, PYTHONPATH=str(ROOT), JAX_PLATFORMS="cpu")
    proc = subprocess.Popen(
        [sys.executable, str(tmp / "tools" / "drift_compare.py"), *ARGS],
        cwd=tmp, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    try:
        out = tmp / "port.jsonl"
        assert dc.main([*ARGS, "--device", "cpu", "--out", str(out)]) == 0
        stdout, stderr = proc.communicate(timeout=500)
    finally:
        if proc.poll() is None:   # the body or the wait raised: no waiting
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, stderr
    assert evidence.read_bytes() == before
    jax_lines = (tmp / "EVIDENCE.jsonl").read_text().splitlines()
    port_lines = out.read_text().splitlines()
    assert len(jax_lines) == 1 and len(port_lines) == 1
    return json.loads(jax_lines[0]), json.loads(port_lines[0])


def test_drifts_match_the_jax_tool(records):
    jax_rec, port = records
    assert port["kind"] == "drift_compare" and port["backend"] == "cpu"
    assert port["steps"] == jax_rec["steps"] == 8
    for k in ("drift_fw", "drift_ref"):
        assert abs(port[k] - jax_rec[k]) <= DRIFT_BAR, (k, port[k],
                                                       jax_rec[k])
    assert abs(port["drift_excess"]) <= DRIFT_BAR


@pytest.mark.parametrize("comp", dc.EB)
def test_field_rms_within_the_bar(records, comp):
    for rec in records:
        assert rec["field_rms"][comp] <= RMS_BAR, (rec["backend"], comp)


def test_no_dropped_movers(records):
    for rec in records:
        assert rec["dropped_movers"] == {"electron": 0, "ion": 0}


def test_fold_jf_is_the_tools():
    rg = dc.reference().G(6, 5, 4)
    rng = np.random.default_rng(0)
    fr = {k: rng.normal(size=(rg.nzg, rg.nyg, rg.nxg))
          for k in ("jfx", "jfy", "jfz")}
    want = {k: v.copy() for k, v in fr.items()}
    dc.fold_jf(fr, rg)
    jax_drift._fold_jf(want, rg)
    for k in fr:
        np.testing.assert_array_equal(fr[k], want[k], err_msg=k)


def _jax_mirror(sim):
    """tools/drift_compare.py's mirror of the post-finalize state."""
    st0 = sim.state
    fr = {k: np.asarray(getattr(st0.field, k), np.float64)
          for k in dc.FIELD_COMPONENTS}
    parts = []
    for sp in st0.species:
        n = int(np.asarray(sp.np))
        parts.append((float(sp.q_m), {
            k: np.asarray(getattr(sp, k), np.float64)[:n].copy()
            for k in dc.PARTICLE_COLUMNS}
            | {"i": np.asarray(sp.i, np.int64)[:n].copy()}))
    return fr, parts


def _as_set(cols):
    order = np.lexsort((cols["dz"], cols["dy"], cols["dx"], cols["i"]))
    return {k: v[order] for k, v in cols.items()}


def test_mirror_matches_the_jax_mirror():
    kw = dict(nx=16, ny=16, nz=1, npart=2048)
    fr, parts = dc.mirror(bench_deck.build(**kw, device="cpu"))
    jfr, jparts = _jax_mirror(ge._build(**kw))
    assert sorted(fr) == sorted(jfr)
    for k in fr:
        assert fr[k].dtype == np.float64 and fr[k].shape == jfr[k].shape
        if k in ("rhof", "rhob"):
            # both species load at the same positions with opposite
            # charges, so the charge density is exactly 0: the port's
            # fixed-point deposit gives 0, the JAX package's float32
            # deposit leaves roundoff of node sums of about 2
            assert not fr[k].any(), k
            assert np.abs(jfr[k]).max() <= 1e-6, k
            continue
        np.testing.assert_array_equal(fr[k], jfr[k], err_msg=k)
    assert len(parts) == len(jparts) == 2
    for (q_m, p), (jq_m, jp) in zip(parts, jparts):
        assert q_m == jq_m
        p, jp = _as_set(p), _as_set(jp)
        assert p["i"].dtype == np.int64
        np.testing.assert_array_equal(p["i"], jp["i"])
        for k in ("dx", "dy", "dz", "q"):
            np.testing.assert_array_equal(p[k], jp[k], err_msg=k)
        # the momenta were taken back half a step at finalize, in another
        # order of float32 operations: float32 roundoff of the column's
        # scale (3.73e-9 at most, on 4 of 2048 lanes)
        for k in ("ux", "uy", "uz"):
            np.testing.assert_allclose(
                p[k], jp[k], rtol=0, atol=2.0 ** -21 * np.abs(jp[k]).max(),
                err_msg=k)


def test_reference_missing_raises_a_clear_error(monkeypatch, tmp_path):
    monkeypatch.setattr(dc, "ROOT", tmp_path)
    monkeypatch.setitem(sys.modules, "tests.ref", None)
    with pytest.raises(RuntimeError, match="tests/ref/ref_impl.py"):
        dc.reference()


def test_sort_period_follows_the_cadence():
    """resort every 2 steps, ions every 8: every species sorts again at
    step 8; one species sorting every step: period 1."""
    sim = bench_deck.build(nx=4, ny=4, nz=1, npart=256, device="cpu")
    assert dc.sort_period(sim) == 8
    sim = bench_deck.build(nx=4, ny=4, nz=1, npart=256, device="cpu",
                           resort_interval=1)
    assert dc.sort_period(sim) == 1
