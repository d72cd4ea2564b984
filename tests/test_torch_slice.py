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
The port's charge deposit sums in fixed point and matches a float64
deposit; the JAX package's float32 scatter leaves roundoff of the
species' densities, so rhof and rhob at finalize agree with it to 1e-6 of
the summed |charge| per node.
"""

import numpy as np
import pytest
import torch

import __graft_entry__ as ge

from vpic_tpu_torch.comm.facecomm import LocalComm
from vpic_tpu_torch.core.types import FIELD_COMPONENTS
from vpic_tpu_torch.decks import bench_deck
from vpic_tpu_torch.field import sync
from vpic_tpu_torch.interop import state_from_numpy, state_to_numpy
from vpic_tpu_torch.particles import aux, sort_cuda
from vpic_tpu_torch.sf import interp as sfi

from tests import torch_decks  # noqa: F401  (one torch thread)

DECK = dict(nx=16, ny=16, nz=1, npart=4096)
STEPS = 8


@pytest.fixture(scope="module")
def runs():
    jsim = ge._build(**DECK)
    tsim = bench_deck.build(**DECK, device="cpu")
    out = dict(j0=state_to_numpy(jsim.state), t0=state_to_numpy(tsim.state),
               je0=jsim.energies(), te0=tsim.energies(), g=tsim.grid)
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
                         sorts=sort_cuda.sort_counts())
        if name == "merge":
            sim.advance(STEPS)
            out["merge16"] = dict(nm=sim.mover_counts(),
                                  sorts=sort_cuda.sort_counts())
    return out


def test_initial_particles_identical(runs):
    """Both packages load bit-identical particles from the same seed."""
    for k in range(2):
        for c in ("dx", "dy", "dz", "i", "q", "np"):
            key = f"species/{k}/{c}"
            np.testing.assert_array_equal(runs["t0"][key], runs["j0"][key],
                                          err_msg=key)


def charge_float64(d, g, absolute=False):
    """Per node, the float64 charge deposit of every species (of |q| with
    ``absolute``) after the shared-face sync."""
    st = state_from_numpy(d)
    offs = torch.tensor([ox + g.nxg * (oy + g.nyg * oz)
                         for ox, oy, oz in aux._NODE_OFFS])
    rho = torch.zeros(g.nv, dtype=torch.float64)
    for sp in st.species:
        q = torch.where(sp.alive, sp.q, 0.0).double()
        w = aux.trilinear_weights(q.abs() if absolute else q, sp.dx.double(),
                                  sp.dy.double(), sp.dz.double(),
                                  aux._r8V(g))
        idx = torch.where(sp.alive, sp.i, 0).long()[:, None] + offs
        rho.index_add_(0, idx.reshape(-1), w.reshape(-1))
    f = sfi.clear_rhof(st.field, g).replace(rhof=rho.reshape(g.shape))
    return sync.synchronize_rho(f, g, LocalComm(g)).rhof.numpy()


def test_initial_state_matches(runs):
    """finalize's initialization pass (sync, div cleaning, curl B, rhob,
    interpolator, uncentering) agrees to float32 roundoff.  The charge
    density: the port's rhof, summed in fixed point, matches the float64
    deposit to the fields' bar; the deck is neutral, so both are 0 where
    the JAX package's float32 sums leave the roundoff of each species'
    density, which rhof and rhob match to 1e-6 of the summed |charge| per
    node; rhob + rhof (eps0 div E) to the fields' bar."""
    t0, j0 = runs["t0"], runs["j0"]
    for c in FIELD_COMPONENTS:
        if c in ("rhof", "rhob"):
            continue
        np.testing.assert_allclose(t0[f"field/{c}"], j0[f"field/{c}"],
                                   rtol=1e-6, atol=1e-7, err_msg=c)
    g = runs["g"]
    np.testing.assert_allclose(t0["field/rhof"], charge_float64(t0, g),
                               rtol=1e-6, atol=1e-7)
    bar = 1e-6 * charge_float64(t0, g, absolute=True)
    for c in ("rhof", "rhob"):
        err = np.abs(t0[f"field/{c}"] - j0[f"field/{c}"])
        assert np.all(err <= bar), (c, float((err - bar).max()))
    np.testing.assert_allclose(t0["field/rhob"] + t0["field/rhof"],
                               j0["field/rhob"] + j0["field/rhof"],
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
