"""The slice end to end on the CPU: the bench deck built by the JAX package
(__graft_entry__._build) and by the port (vpic_tpu_torch.decks.bench_deck)
at 16x16 cells and 4096 particles per species, then 8 steps in each.

The port sorts on the fused TPU path's cadence (every 2 steps, ions every
8) while the JAX package's CPU path sorts ions only, so particles are
compared as sets ordered by (voxel, dx, dy, dz).  The port's two other
paths, switched on the built deck with ``modify_runparams``, run the same
8 steps: the unfused push (``fused_push=False``: every species sorts every
step, segment 1 through the deposit) and the packed cycle with the merge
re-sort (``merge_sort=True``), which then runs 8 steps more.

Tolerances: energies 1e-6 relative (BASELINE.md:21); after 8 steps of
field feedback the particle floats and fields agree to 1e-5 absolute (the
field values are O(0.1), the deposits sum in another order each step).
"""

import numpy as np
import pytest

import __graft_entry__ as ge

from vpic_tpu_torch.core.types import FIELD_COMPONENTS
from vpic_tpu_torch.decks import bench_deck
from vpic_tpu_torch.interop import state_to_numpy
from vpic_tpu_torch.particles import sort_cuda

DECK = dict(nx=16, ny=16, nz=1, npart=4096)
STEPS = 8


@pytest.fixture(scope="module")
def runs():
    jsim = ge._build(**DECK)
    tsim = bench_deck.build(**DECK, device="cpu")
    out = dict(j0=state_to_numpy(jsim.state), t0=state_to_numpy(tsim.state),
               je0=jsim.energies(), te0=tsim.energies())
    jsim.advance(STEPS)
    tsim.advance(STEPS)
    out.update(j1=state_to_numpy(jsim.state), t1=state_to_numpy(tsim.state),
               je1=jsim.energies(), te1=tsim.energies(),
               jnm=jsim.mover_counts(), tnm=tsim.mover_counts())
    return out


@pytest.fixture(scope="module")
def path_runs():
    out = {}
    for name, kw in (("unfused", dict(fused_push=False)),
                     ("merge", dict(merge_sort=True))):
        sim = bench_deck.build(**DECK, device="cpu")
        sim.modify_runparams(**kw)
        sort_cuda.reset_launch_counts()
        sim.advance(STEPS)
        out[name] = dict(e=sim.energies(), nm=sim.mover_counts(),
                         sorts={k: dict(v) for k, v in
                                sort_cuda.sort_counts.items()})
        if name == "merge":
            sim.advance(STEPS)
            out["merge16"] = dict(nm=sim.mover_counts(),
                                  sorts={k: dict(v) for k, v in
                                         sort_cuda.sort_counts.items()})
    return out


def test_initial_particles_identical(runs):
    """Both packages load bit-identical particles from the same seed."""
    for k in range(2):
        for c in ("dx", "dy", "dz", "i", "q", "np"):
            key = f"species/{k}/{c}"
            np.testing.assert_array_equal(runs["t0"][key], runs["j0"][key],
                                          err_msg=key)


def test_initial_state_matches(runs):
    """finalize's initialization pass (sync, div cleaning, curl B, rhob,
    interpolator, uncentering) agrees to float32 roundoff."""
    t0, j0 = runs["t0"], runs["j0"]
    for c in FIELD_COMPONENTS:
        np.testing.assert_allclose(t0[f"field/{c}"], j0[f"field/{c}"],
                                   rtol=1e-6, atol=1e-7, err_msg=c)
    np.testing.assert_allclose(t0["interpolator"], j0["interpolator"],
                               rtol=1e-6, atol=1e-7)
    for k in range(2):
        for c in ("ux", "uy", "uz"):
            key = f"species/{k}/{c}"
            np.testing.assert_allclose(t0[key], j0[key], rtol=1e-6,
                                       atol=1e-7, err_msg=key)
    for name, e in runs["je0"].items():
        np.testing.assert_allclose(runs["te0"][name], e, rtol=1e-6,
                                   atol=1e-12, err_msg=name)


def test_energies_match_after_steps(runs):
    for name, e in runs["je1"].items():
        np.testing.assert_allclose(runs["te1"][name], e, rtol=1e-6,
                                   atol=1e-12, err_msg=name)
    assert runs["tnm"] == runs["jnm"] == {"electron": 0, "ion": 0}


@pytest.mark.parametrize("path", ["unfused", "merge"])
def test_path_energies_match_after_steps(runs, path_runs, path):
    """The unfused and the packed merge-sort paths against the JAX XLA
    path, 1e-6 relative after 8 steps, no dropped movers."""
    for name, e in runs["je1"].items():
        np.testing.assert_allclose(path_runs[path]["e"][name], e, rtol=1e-6,
                                   atol=1e-12, err_msg=name)
    assert path_runs[path]["nm"] == {"electron": 0, "ion": 0}


def test_merge_path_sorts_fast_after_its_first_sort(path_runs):
    """Each species' first sort has no snapshot and sorts in full; every
    later one merges (m_cap clamps to n at this size).  Electrons sort at
    even steps, ions at steps 0 and 8."""
    assert path_runs["merge"]["sorts"] == {
        "electron": {"fast": 3, "slow": 1}, "ion": {"fast": 0, "slow": 1}}
    assert path_runs["merge16"]["sorts"] == {
        "electron": {"fast": 7, "slow": 1}, "ion": {"fast": 1, "slow": 1}}
    assert path_runs["merge16"]["nm"] == {"electron": 0, "ion": 0}


def _sorted_particles(d, k):
    pre = f"species/{k}/"
    n = int(d[pre + "np"])
    cols = {c: d[pre + c][:n] for c in ("i", "dx", "dy", "dz", "ux", "uy",
                                         "uz", "q")}
    order = np.lexsort((cols["dz"], cols["dy"], cols["dx"], cols["i"]))
    return {c: v[order] for c, v in cols.items()}


@pytest.mark.parametrize("k", [0, 1], ids=["electron", "ion"])
def test_particles_match_as_sets(runs, k):
    t = _sorted_particles(runs["t1"], k)
    j = _sorted_particles(runs["j1"], k)
    np.testing.assert_array_equal(t["i"], j["i"])
    for c in ("dx", "dy", "dz", "ux", "uy", "uz", "q"):
        np.testing.assert_allclose(t[c], j[c], rtol=0, atol=1e-5, err_msg=c)


def test_fields_match_after_steps(runs):
    for c in FIELD_COMPONENTS:
        np.testing.assert_allclose(runs["t1"][f"field/{c}"],
                                   runs["j1"][f"field/{c}"], rtol=0,
                                   atol=1e-5, err_msg=c)
    np.testing.assert_allclose(runs["t1"]["interpolator"],
                               runs["j1"]["interpolator"], rtol=0, atol=1e-5)
