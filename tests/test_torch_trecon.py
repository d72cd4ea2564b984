"""The trecon-part reconnection deck (decks/trecon.py) and its port
(vpic_tpu_torch/decks/trecon.py) at 16x8 cells in the x-z plane (ny = 1)
and 4 particles per cell: the force-free sheet with its perturbations,
electrons, ions and 1024 tagged q = 0 tracers, interval cleans every 25
steps, compared as tests/torch_decks.py sets out; the deck's dumps
(V0 fields, hydro, tracer particles, energy-band spectra); the CLI with a
restart; the tracers' trajectories in both packages.
"""

import numpy as np
import pytest

import chip_smoke as cs
from tests import torch_decks as td

NAME = "trecon"
SIZE = dict(TRECON_NX=16, TRECON_NZ=8, TRECON_PPC=4)
SPECIES = ("electron", "ion", "e_tracer")


@pytest.fixture(scope="module")
def runs():
    return td.run_both(NAME, SIZE)


def test_both_packages_load_identical_particles(runs):
    assert runs["names"] == list(SPECIES)
    td.check_identical_load(runs)
    tags = runs["t0"]["species/2/tag"]
    assert int(runs["t0"]["species/2/np"]) == 512    # min(1024, 16*8*4)
    np.testing.assert_array_equal(tags[:512], np.arange(1, 513))


def test_energies_and_movers_match(runs):
    td.check_energies_and_movers(runs)
    assert not any(runs["tnm"].values())


@pytest.mark.parametrize("k", range(len(SPECIES)), ids=SPECIES)
def test_particles_match_as_sets(runs, k):
    td.check_particles(runs, k)


def test_fields_match(runs):
    td.check_fields(runs)


def test_energy_drift_over_25_steps(runs):
    """The JAX package's total-energy change over 25 steps at this size
    exceeds 5e-3; twice it is chip_smoke.py's bar on the full deck
    (JAX_DRIFT_25).  The port's change equals it."""
    jax_drift, port_drift = runs["drift"]
    np.testing.assert_allclose(jax_drift, cs.JAX_DRIFT_25[NAME], rtol=1e-3)
    np.testing.assert_allclose(port_drift, jax_drift, rtol=1e-3)
    assert cs.recon_drift_limit(NAME) == 2 * cs.JAX_DRIFT_25[NAME] > 5e-3


DIAG_ENV = {"TRECON_ENERGY_INTERVAL": 2, "TRECON_FIELD_INTERVAL": 2,
            "TRECON_TRACER_INTERVAL": 2, "TRECON_SPECTRUM_INTERVAL": 2}


def test_diagnostics_inventory(monkeypatch, tmp_path):
    _, tmod = td.modules(monkeypatch, NAME,
                         {**SIZE, **DIAG_ENV, "TRECON_OUT": tmp_path})
    sim = tmod.deck(device="cpu")
    sim.finalize()
    for _ in range(2):
        sim.advance(1)
        tmod.diagnostics(sim)
    for rel in ("energies.txt", "fields/fields.2.0", "hydro/ehydro.2.0",
                "hydro/ihydro.2.0", "tracer/tracer.2.0",
                "hydro/T.2/electron.2.0", "hydro/T.2/spectrum-ion.2.0"):
        assert (tmp_path / rel).exists(), rel


def test_cli_restart_reproduces_every_dump(monkeypatch, tmp_path):
    env = {**SIZE, **DIAG_ENV, "TRECON_ENERGY_INTERVAL": 1}
    first, second = tmp_path / "first", tmp_path / "second"
    for out, extra in ((first, ()),
                       (second, ("--restart",
                                 str(first / "restart" / "restart1"
                                     / "restart")))):
        assert td.run_cli(monkeypatch, NAME, env, "TRECON_OUT", out,
                          "--checkpoint-dir", str(out / "restart"),
                          "--checkpoint-interval", "2", *extra) == 0
    # fields, two hydro, the tracers' particle dump, 2 x 2 spectra files
    td.check_restart(first, second, {"fields", "hydro", "tracer"}, 8)
    assert td.energy_steps(second / "energies.txt") == [3, 4]
    assert (first / "energies.txt").read_text().splitlines()[-1] == \
        (second / "energies.txt").read_text().splitlines()[-1]


def test_cli_asks_for_the_card_by_default(monkeypatch, tmp_path):
    td.check_asks_for_the_card(monkeypatch, NAME,
                               {**SIZE, "TRECON_OUT": tmp_path})


def test_tracer_trajectories_match(monkeypatch, tmp_path):
    """collect_trajectories every step on the deck in both packages: the
    records equal as sets keyed by (tag, t), and the port's consolidated
    file read back by the JAX reader, one row per tag and step, inside the
    box."""
    from vpic_tpu.io import tracers as jtr
    from vpic_tpu_torch.io import tracers as ttr
    jmod, tmod = td.modules(monkeypatch, NAME, SIZE)
    sims = (jmod.deck(), tmod.deck(device="cpu"))
    for sim in sims:
        sim.finalize()
        sim.collect_trajectories()
        for _ in range(3):
            sim.advance(1)
            sim.collect_trajectories()
    recs = []
    for sim in sims:
        rec = sim._traj.records("e_tracer")
        recs.append(rec[np.lexsort((rec[:, 0], ttr._tags_of(rec)))])
        assert sim._traj.species() == ["e_tracer"]
    j, t = recs
    assert t.shape == j.shape == (4 * 512, 10)
    np.testing.assert_array_equal(t[:, [0, 4, 8, 9]], j[:, [0, 4, 8, 9]])
    np.testing.assert_allclose(t, j, rtol=0, atol=td.BAR)
    sims[1].dump_traj(tmp_path)
    trajs = jtr.read_traj_dir(tmp_path, "e_tracer")
    g = sims[1].grid
    assert sorted(trajs) == list(range(1, 513))
    for rows in trajs.values():
        assert rows.shape == (4, 8)
        x, _, z = ttr.global_positions(g, rows)
        assert np.all((x >= g.gx0) & (x <= g.gx1))
        assert np.all((z >= g.gz0) & (z <= g.gz1))
