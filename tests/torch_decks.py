"""Shared checks of the deck parity tests (test_torch_fan.py,
test_torch_trecon.py, test_torch_sigma.py, after test_torch_turbulence.py):
a deck of ``decks/`` and its copy in ``vpic_tpu_torch/decks/`` at a small
size, built once in each package.

- Both packages load identical particles from the deck's numpy stream
  (positions, voxels, charges and tags equal; the momenta, taken back half
  a step at finalize, and the initial fields to 1e-5 absolute).
- After STEPS steps: energies to 1e-6 relative; particles as sets ordered
  by (voxel, tag, position), voxels and tags exact and floats to 1e-5
  absolute; fields and interpolator to 1e-5 absolute; equal dropped-mover
  counts.
- The open decks (drifting boxes with reflux walls or an emitter,
  :func:`open_runs`): both packages from the JAX package's finalized
  state and its key, which the port draws from as the JAX package does;
  energies as above and the live lanes as sets (:func:`check_live_lanes`).
- The port's CLI (``--device cpu``, in process) runs 4 steps with a
  checkpoint at step 2; a second call restarted from it reaches step 4
  with the same bytes in every dump of step 4.  Without ``--device`` it
  asks for the card and raises where there is none.

Importing this module sets PyTorch to one CPU thread (the port's test
files all import it): the tests' tensors are small, and pytest-xdist runs
one test process per worker, so PyTorch's default of a thread per core
would oversubscribe the cores many times over.
"""

import importlib
from pathlib import Path

import numpy as np
import pytest
import torch

from vpic_tpu_torch.cli import run as cli
from vpic_tpu_torch.core.types import FIELD_COMPONENTS
from vpic_tpu_torch.interop import state_from_numpy, state_to_numpy

STEPS = 8
DRIFT_STEPS = 25
BAR = 1e-5
DECKS = Path(__file__).resolve().parents[1] / "vpic_tpu_torch" / "decks"

torch.set_num_threads(1)


def modules(mp, name, env):
    """(JAX deck module, port deck module) of ``decks/<name>.py``, reloaded
    under the environment ``env``."""
    for k, v in env.items():
        mp.setenv(k, str(v))
    return (importlib.reload(importlib.import_module(f"decks.{name}")),
            importlib.reload(importlib.import_module(
                f"vpic_tpu_torch.decks.{name}")))


def run_both(name, env):
    """Both packages' decks at ``env``: their states at finalize and after
    STEPS steps, energies and dropped movers, and the relative change of
    the total energy from finalize to step DRIFT_STEPS."""
    with pytest.MonkeyPatch.context() as mp:
        jmod, tmod = modules(mp, name, env)
        jsim = jmod.deck()
        jsim.finalize()
        tsim = tmod.deck(device="cpu")
        tsim.finalize()
    out = dict(j0=state_to_numpy(jsim.state), t0=state_to_numpy(tsim.state),
               names=[sp.name for sp in tsim.state.species])
    total = lambda sim: sum(sim.energies().values())
    e0 = total(jsim), total(tsim)
    jsim.advance(STEPS)
    tsim.advance(STEPS)
    out.update(j1=state_to_numpy(jsim.state), t1=state_to_numpy(tsim.state),
               je=jsim.energies(), te=tsim.energies(),
               jnm=jsim.mover_counts(), tnm=tsim.mover_counts())
    jsim.advance(DRIFT_STEPS - STEPS)
    tsim.advance(DRIFT_STEPS - STEPS)
    out["drift"] = tuple((total(sim) - e) / e
                         for sim, e in zip((jsim, tsim), e0))
    return out


def check_identical_load(runs):
    for k in range(len(runs["names"])):
        for c in ("dx", "dy", "dz", "i", "q", "tag", "np"):
            key = f"species/{k}/{c}"
            np.testing.assert_array_equal(runs["t0"][key], runs["j0"][key],
                                          err_msg=key)
        # finalize takes the momenta back half a step in each package's
        # float32 arithmetic (uncenter_p)
        for c in ("ux", "uy", "uz"):
            key = f"species/{k}/{c}"
            np.testing.assert_allclose(runs["t0"][key], runs["j0"][key],
                                       rtol=0, atol=BAR, err_msg=key)
        assert int(runs["t0"][f"species/{k}/np"]) > 0
    for c in FIELD_COMPONENTS:
        np.testing.assert_allclose(runs["t0"][f"field/{c}"],
                                   runs["j0"][f"field/{c}"], rtol=0,
                                   atol=BAR, err_msg=c)


def check_energies_and_movers(runs):
    for name, e in runs["je"].items():
        np.testing.assert_allclose(runs["te"][name], e, rtol=1e-6,
                                   atol=1e-12, err_msg=name)
    assert runs["tnm"] == runs["jnm"]


def _sorted_particles(d, k):
    pre = f"species/{k}/"
    n = int(d[pre + "np"])
    cols = {c: d[pre + c][:n] for c in ("i", "dx", "dy", "dz", "ux", "uy",
                                         "uz", "q", "tag")}
    order = np.lexsort((cols["dz"], cols["dy"], cols["dx"], cols["tag"],
                        cols["i"]))
    return {c: v[order] for c, v in cols.items()}


def check_particles(runs, k):
    t = _sorted_particles(runs["t1"], k)
    j = _sorted_particles(runs["j1"], k)
    np.testing.assert_array_equal(t["i"], j["i"])
    np.testing.assert_array_equal(t["tag"], j["tag"])
    for c in ("dx", "dy", "dz", "ux", "uy", "uz", "q"):
        np.testing.assert_allclose(t[c], j[c], rtol=0, atol=BAR, err_msg=c)


def open_runs(jsim, tsim, steps):
    """Two finalized decks, one of each package: the JAX package's lanes
    put in voxel order (a stable sort) and the port loaded with that state
    and its key (``jax.random.key_data``), then ``steps`` steps of each.
    A draw goes to a lane by its place in the species, so both keep one
    lane order: the JAX package sorts these decks on their species'
    sort_interval, 0 (never); the port's sort, on its resort_interval
    (made 4 * steps here), is the identity at step 0 on lanes in voxel
    order.  Returns what :func:`check_energies_and_movers` and
    :func:`check_live_lanes` read."""
    import dataclasses
    import jax
    import jax.numpy as jnp
    from vpic_tpu_torch.core.types import SPECIES_COLUMNS
    species = []
    for sp in jsim.state.species:
        i = np.asarray(sp.i)
        order = np.argsort(np.where(np.asarray(sp.alive), i, 2 ** 30),
                           kind="stable")
        species.append(sp.replace(**{
            c: jnp.asarray(np.asarray(getattr(sp, c))[order])
            for c in SPECIES_COLUMNS if np.shape(getattr(sp, c)) == i.shape}))
    jsim.state = dataclasses.replace(jsim.state, species=tuple(species))
    tsim.modify_runparams(resort_interval=4 * steps)
    d0 = state_to_numpy(jsim.state)
    tsim.state = state_from_numpy(dict(
        d0, rng=np.asarray(jax.random.key_data(jsim.state.rng))))
    jsim.advance(steps)
    tsim.advance(steps)
    return dict(je=jsim.energies(), te=tsim.energies(),
                jnm=jsim.mover_counts(), tnm=tsim.mover_counts(),
                j1=state_to_numpy(jsim.state), t1=state_to_numpy(tsim.state),
                jrng=np.asarray(jax.random.key_data(jsim.state.rng)))


def _live_lanes(d, k):
    pre = f"species/{k}/"
    live = (np.arange(len(d[pre + "i"])) < int(d[pre + "np"])) & (
        d[pre + "i"] >= 0) & (d[pre + "q"] != 0)
    cols = {c: d[pre + c][live] for c in ("i", "dx", "dy", "dz", "ux", "uy",
                                          "uz", "q")}
    order = np.lexsort((cols["dz"], cols["dy"], cols["dx"], cols["i"]))
    return {c: v[order] for c, v in cols.items()}


def check_live_lanes(runs, k=0):
    """The live lanes of species ``k`` in both runs as sets ordered by
    (voxel, position): as many, voxels exact, floats to 1e-5 absolute,
    and the random state's key equal."""
    t, j = _live_lanes(runs["t1"], k), _live_lanes(runs["j1"], k)
    np.testing.assert_array_equal(t["i"], j["i"])
    for c in ("dx", "dy", "dz", "ux", "uy", "uz", "q"):
        np.testing.assert_allclose(t[c], j[c], rtol=0, atol=BAR, err_msg=c)
    np.testing.assert_array_equal(runs["t1"]["rng"], runs["jrng"])


def check_fields(runs):
    for c in FIELD_COMPONENTS:
        np.testing.assert_allclose(runs["t1"][f"field/{c}"],
                                   runs["j1"][f"field/{c}"], rtol=0,
                                   atol=BAR, err_msg=c)
    np.testing.assert_allclose(runs["t1"]["interpolator"],
                               runs["j1"]["interpolator"], rtol=0, atol=BAR)


def run_cli(mp, name, env, out_key, out, *args):
    """The port's CLI on ``vpic_tpu_torch/decks/<name>.py`` on the CPU for
    4 steps, writing under ``out``."""
    for k, v in {**env, out_key: out}.items():
        mp.setenv(k, str(v))
    return cli.main([str(DECKS / f"{name}.py"), "--device", "cpu",
                     "--num-step", "4", "--status-interval", "2", *args])


def check_restart(first, second, kinds, count):
    """Every dump of step 4 under ``first`` (files ``*.4.0`` and the
    spectra under ``T.4``) equals its copy under ``second`` byte for byte;
    they are ``count`` files of the top directories ``kinds``."""
    dumps = sorted(p.relative_to(first) for p in first.rglob("*")
                   if p.is_file() and (p.name.endswith(".4.0")
                                       or p.parent.name == "T.4"))
    assert {p.parts[0] for p in dumps} == set(kinds)
    assert len(dumps) == count
    for rel in dumps:
        assert (first / rel).read_bytes() == (second / rel).read_bytes(), rel


def energy_steps(path):
    return [int(line.split()[0]) for line in path.read_text().splitlines()
            if not line.startswith("%")]


def check_asks_for_the_card(mp, name, env):
    mp.setattr(torch.cuda, "is_available", lambda: False)
    for k, v in env.items():
        mp.setenv(k, str(v))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main([str(DECKS / f"{name}.py"), "--num-step", "1"])


def hooked_shards(device, hook=None, px=2, py=2, pz=1, nz=1, seed=1,
                  n=1024):
    """A 16x16x``nz`` periodic box of ``px`` x ``py`` x ``pz`` shards with
    ``n`` warm electrons and ``hook`` as its ``user_field_injection`` hook
    (a deck that the CUDA graphs admit, with a place for a shard to
    fail)."""
    from vpic_tpu_torch.deck.api import Simulation
    sim = Simulation(seed=seed, device=device)
    sim.define_units(1.0, 1.0)
    sim.define_timestep(0.05)
    sim.define_periodic_grid(0, 0, 0, 1, 1, 1, 16, 16, nz, px, py, pz)
    e = sim.define_species("electron", -1.0, 2 * n)
    sim.inject_particle(e, sim.uniform(n, 0, 1), sim.uniform(n, 0, 1),
                        sim.uniform(n, 0, 1), sim.maxwellian(n, 0.1),
                        sim.maxwellian(n, 0.1), sim.maxwellian(n, 0.1),
                        q=-1.0 / n)
    sim.finalize(user_field_injection=hook)
    return sim
