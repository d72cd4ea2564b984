"""Tracer trajectories of the port (vpic_tpu_torch/io/tracers.py and the
deck API's make_tracers / collect_trajectories / dump_traj /
dump_tracers_h5part and the .traj.npz checkpoint sidecar) against the JAX
package, on the deck of tests/test_tracers_collisions.py built in both
packages from one set of numpy arrays: an 8x8 periodic box, 500 electrons
and a tracer species of every 50th (10 tags).

- Records: equal as sets keyed by (tag, t), voxels and tags exact, floats
  to the slice bar (1e-5 absolute).
- Files: the consolidated .traj files share the JAX layout (rows sorted by
  (tag, t), 10 floats each); each package's reader reads the other's
  files; per-tag files equal the consolidated ones; H5Part steps hold each
  step's tags.
- A species injected without tags is never copied to the host.
- tests/test_regressions_r3.py::test_tracer_restart_roundtrip and
  tests/test_tracers_collisions.py::test_tracers_do_not_perturb_fields for
  the port.
"""

import numpy as np
import pytest
import torch

import vpic_tpu
from vpic_tpu.io import tracers as jtr

import vpic_tpu_torch
from vpic_tpu_torch.interop import state_to_numpy
from vpic_tpu_torch.io import tracers as ttr

from tests import torch_decks  # noqa: F401  (one torch thread)

N, NX, STRIDE, STEPS = 500, 8, 50, 6
N_TR = N // STRIDE
BAR = 1e-5


def build(port, seed=3, tracer_stride=STRIDE):
    """The deck of tests/test_tracers_collisions.py:build, its particles
    drawn with numpy; ``port`` picks the package."""
    L = 1.0
    sim = (vpic_tpu_torch.Simulation(seed=seed, device="cpu") if port
           else vpic_tpu.Simulation(seed=seed))
    sim.define_units(1.0, 1.0)
    sim.define_timestep(0.9 * sim.courant_length(L, L, L, NX, NX, 1))
    sim.define_periodic_grid(0, 0, 0, L, L, L, NX, NX, 1)
    sim.define_material("vacuum")
    e = sim.define_species("electron", -1.0, 4 * N)
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0, L, (3, N))
    mom = rng.normal(0, 0.1, (3, N))
    sim.inject_particle(e, *pos, *mom, q=-1.0 / N)
    if tracer_stride:
        sim.make_tracers(e, "e_tracer", stride=tracer_stride)
    sim.finalize()
    return sim


def collect(sim, steps=STEPS):
    sim.collect_trajectories()
    for _ in range(steps):
        sim.advance(1)
        sim.collect_trajectories()
    return sim


@pytest.fixture(scope="module")
def runs():
    return collect(build(False)), collect(build(True))


def _keyed(rec):
    """Rows ordered by (tag, t)."""
    tags = ttr._tags_of(rec)
    return rec[np.lexsort((rec[:, 0], tags))], np.sort(tags)


def test_records_equal_as_sets(runs):
    jsim, tsim = runs
    j, jtags = _keyed(jsim._traj.records("e_tracer"))
    t, ttags = _keyed(tsim._traj.records("e_tracer"))
    assert t.shape == j.shape == ((STEPS + 1) * N_TR, 10)
    np.testing.assert_array_equal(ttags, jtags)
    np.testing.assert_array_equal(t[:, [0, 4, 8, 9]].view(np.int32),
                                  j[:, [0, 4, 8, 9]].view(np.int32))
    np.testing.assert_allclose(t[:, 1:8], j[:, 1:8], rtol=0, atol=BAR)
    assert tsim._traj.species() == jsim._traj.species() == ["e_tracer"]


def test_collect_records_matches_jax_on_host_arrays():
    """Same lanes in the same order: every float bitwise the JAX
    package's; a capacity below the tagged lanes raises."""
    rng = np.random.default_rng(0)
    n = 3000
    arrays = dict(tag=np.where(rng.random(n) < 0.1,
                               rng.integers(-2**31, 2**31 - 1, n), 0)
                  .astype(np.int32),
                  alive=rng.random(n) < 0.9,
                  i=rng.integers(0, 10_000, n).astype(np.int32),
                  **{k: rng.normal(size=n).astype(np.float32)
                     for k in ("dx", "dy", "dz", "ux", "uy", "uz")})
    want = jtr.collect_records(arrays, 7, 0.03)
    got = ttr.collect_records(
        {k: torch.as_tensor(v) for k, v in arrays.items()}, 7, 0.03,
        capacity=int((arrays["tag"] != 0).sum()))
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    np.testing.assert_array_equal(
        ttr.collect_records(arrays, 7, 0.03).view(np.int32),
        want.view(np.int32))
    with pytest.raises(ValueError, match="capacity"):
        ttr.collect_records(arrays, 7, 0.03, capacity=want.shape[0] - 1)


def test_untagged_species_are_never_copied(monkeypatch):
    sim = build(True)
    read = []
    real = ttr.collect_records
    monkeypatch.setattr(ttr, "collect_records",
                        lambda arrays, *a, **k: read.append(
                            int(arrays["tag"].numel())) or real(
                                arrays, *a, **k))
    collect(sim, 2)
    # only the tracer species (its one block of 1024 slots) was read, once
    # per call
    assert read == [1024] * 3
    untagged = build(True, tracer_stride=0)
    collect(untagged, 1)
    assert read == [1024] * 3
    assert untagged._traj.species() == []


def test_consolidated_files_share_the_layout(runs, tmp_path):
    jsim, tsim = runs
    (jp,) = jsim.dump_traj(tmp_path / "j")
    (tp,) = tsim.dump_traj(tmp_path / "t")
    assert jp.name == tp.name == "e_tracer.traj"
    j = np.fromfile(jp, "<f4").reshape(-1, 10)
    t = np.fromfile(tp, "<f4").reshape(-1, 10)
    assert j.shape == t.shape
    # sorted by (tag, t): the same tag and time in every row
    np.testing.assert_array_equal(t[:, [0, 4, 8, 9]], j[:, [0, 4, 8, 9]])
    np.testing.assert_allclose(t, j, rtol=0, atol=BAR)
    # each package's reader reads the other's files
    for a, b in ((ttr.read_traj_dir(tmp_path / "j", "e_tracer"),
                  jtr.read_traj_dir(tmp_path / "j", "e_tracer")),
                 (jtr.read_traj_dir(tmp_path / "t", "e_tracer"),
                  ttr.read_traj_dir(tmp_path / "t", "e_tracer"))):
        assert sorted(a) == sorted(b) == list(range(1, N_TR + 1))
        for tag in a:
            np.testing.assert_array_equal(a[tag], b[tag])


def test_tracer_trajectories(runs, tmp_path):
    """tests/test_tracers_collisions.py::test_tracer_trajectories on the
    port."""
    _, sim = runs
    paths = sim.dump_traj(tmp_path / "traj")
    assert len(paths) == 1
    trajs = ttr.read_traj_dir(tmp_path / "traj", "e_tracer")
    assert len(trajs) == N_TR
    g = sim.grid
    for rows in trajs.values():
        assert rows.shape == (STEPS + 1, 8)
        t = rows[:, 0]
        assert np.all(np.diff(t) > 0)
        np.testing.assert_allclose(np.diff(t), g.dt, rtol=1e-5)
        x, y, _ = ttr.global_positions(g, rows)
        assert np.all((x >= 0) & (x <= 1))
        assert np.all((y >= 0) & (y <= 1))
        assert np.ptp(x) + np.ptp(y) > 0

    paths2 = sim.dump_traj(tmp_path / "traj_ref", per_tag_files=True)
    assert len(paths2) == N_TR
    trajs2 = ttr.read_traj_dir(tmp_path / "traj_ref", "e_tracer")
    for tag in trajs:
        np.testing.assert_array_equal(trajs[tag], trajs2[tag])


def test_h5part_tracer_output(runs, tmp_path):
    """tests/test_tracers_collisions.py::test_h5part_tracer_output on the
    port, each step's datasets equal the JAX package's as sets."""
    h5py = pytest.importorskip("h5py")
    jsim, tsim = runs
    jp = jsim.dump_tracers_h5part(tmp_path / "j.h5part", "e_tracer")
    tp = tsim.dump_tracers_h5part(tmp_path / "t.h5part", "e_tracer")
    with h5py.File(jp, "r") as jf, h5py.File(tp, "r") as tf:
        steps = sorted(k for k in tf.keys() if k.startswith("Step#"))
        assert steps == sorted(jf.keys())
        assert len(steps) == STEPS + 1
        for s in steps:
            assert tf[s].attrs["TimeValue"] == jf[s].attrs["TimeValue"]
            to = np.argsort(np.asarray(tf[s]["q"]))
            jo = np.argsort(np.asarray(jf[s]["q"]))
            assert set(np.asarray(tf[s]["q"])) == set(range(1, N_TR + 1))
            for name in ("i", "q"):
                np.testing.assert_array_equal(np.asarray(tf[s][name])[to],
                                              np.asarray(jf[s][name])[jo])
            for name in ("dX", "dY", "dZ", "Ux", "Uy", "Uz"):
                assert tf[s][name].shape == (N_TR,)
                np.testing.assert_allclose(np.asarray(tf[s][name])[to],
                                           np.asarray(jf[s][name])[jo],
                                           rtol=0, atol=BAR)


def test_tracers_do_not_perturb_fields():
    """q = 0 tracers leave the fields bitwise as they are without them."""
    with_tr = build(True, seed=5)
    without = build(True, seed=5, tracer_stride=0)
    with_tr.advance(5)
    without.advance(5)
    a, b = state_to_numpy(with_tr.state), state_to_numpy(without.state)
    for c in ("ex", "ey", "cbz", "jfx", "jfy"):
        np.testing.assert_array_equal(a[f"field/{c}"], b[f"field/{c}"],
                                      err_msg=c)


def test_tracer_restart_roundtrip(tmp_path):
    """tests/test_regressions_r3.py::test_tracer_restart_roundtrip on the
    port: the records and the flushed watermark survive a checkpoint."""
    sim = build(True, seed=11)
    for _ in range(3):
        sim.advance(1)
        sim.collect_trajectories()
    rec_before = sim._traj.records("e_tracer").copy()
    assert rec_before.shape[0] == 3 * N_TR

    out_dir = tmp_path / "traj"
    sim.dump_traj(out_dir, per_tag_files=True)
    sizes1 = {p.name: p.stat().st_size for p in out_dir.iterdir()}
    sim.dump_traj(out_dir, per_tag_files=True)
    assert {p.name: p.stat().st_size for p in out_dir.iterdir()} == sizes1

    ck = tmp_path / "ck" / "restart"
    sim.checkpoint(ck)
    assert (tmp_path / "ck" / "restart.traj.npz").exists()
    sim2 = build(True, seed=11)
    sim2.restore(ck)
    np.testing.assert_array_equal(sim2._traj.records("e_tracer"), rec_before)
    out2 = tmp_path / "traj2"
    sim2.dump_traj(out2, per_tag_files=True)
    assert sum(p.stat().st_size for p in out2.iterdir()) == 0
    # collecting goes on after the restored records
    sim2.advance(1)
    sim2.collect_trajectories()
    assert sim2._traj.records("e_tracer").shape[0] == 4 * N_TR


def test_h5part_needs_records():
    with pytest.raises(RuntimeError, match="collect_trajectories"):
        build(True).dump_tracers_h5part("unused.h5part", "e_tracer")
