"""The sigma deck (decks/sigma.py) and its port (vpic_tpu_torch/decks/
sigma.py) at 16x8 cells in the x-z plane and 4 particles per cell: PEC z
walls that reflect particles, the relativistic 0.6c boosted load, two
tracer species, compared as tests/torch_decks.py sets out; the deck's
standard_diagnostics inventory; the CLI with the deck's own rotating
restart; and tests/test_regressions_r3.py::test_sigma_deck_relativistic_walls
on the port alone (32x16 cells, 8 per cell, 25 steps).
"""

import numpy as np
import pytest

import chip_smoke as cs
from tests import torch_decks as td

NAME = "sigma"
SIZE = dict(SIGMA_NX=16, SIGMA_NZ=8, SIGMA_PPC=4)
SPECIES = ("electron", "ion", "e_tracer", "i_tracer")


@pytest.fixture(scope="module")
def runs():
    return td.run_both(NAME, SIZE)


def test_both_packages_load_identical_particles(runs):
    assert runs["names"] == list(SPECIES)
    td.check_identical_load(runs)
    # the boosted load is relativistic
    u2 = sum(runs["t0"][f"species/0/u{c}"].astype(np.float64) ** 2
             for c in "xyz")
    assert u2.max() > 1.0


def test_energies_and_movers_match(runs):
    td.check_energies_and_movers(runs)
    assert not any(runs["tnm"].values())


@pytest.mark.parametrize("k", range(len(SPECIES)), ids=SPECIES)
def test_particles_match_as_sets(runs, k):
    td.check_particles(runs, k)


def test_fields_match(runs):
    td.check_fields(runs)


def test_energy_drift_over_25_steps(runs):
    """Both packages' total-energy change over 25 steps stays inside the
    5e-3 of tests/test_regressions_r3.py:196, chip_smoke.py's bar on the
    full deck."""
    jax_drift, port_drift = runs["drift"]
    np.testing.assert_allclose(port_drift, jax_drift, rtol=1e-3)
    assert abs(jax_drift) < cs.recon_drift_limit(NAME) == 5e-3


DIAG_ENV = {"SIGMA_ENERGY_INTERVAL": 2, "SIGMA_FIELD_INTERVAL": 2,
            "SIGMA_PARTICLE_INTERVAL": 2, "SIGMA_RESTART_INTERVAL": 2,
            "SIGMA_TRACER_INTERVAL": 2, "SIGMA_SPECTRUM_INTERVAL": 2}


def test_standard_inventory(monkeypatch, tmp_path):
    _, tmod = td.modules(monkeypatch, NAME,
                         {**SIZE, **DIAG_ENV, "SIGMA_OUT": tmp_path})
    sim = tmod.deck(device="cpu")
    sim.finalize()
    tmod.diagnostics(sim)             # step 0: the one-time rundata dumps
    for _ in range(2):
        sim.advance(1)
        tmod.diagnostics(sim)
    for rel in ("rundata/grid.0", "rundata/materials", "rundata/species",
                "rundata/energies", "global.vpc", "fields/fields.2.0",
                "hydro/electronhydro.2.0", "hydro/i_tracerhydro.2.0",
                "particle/electronparticle.2.0", "particle/ionparticle.2.0",
                "restart1/restart.json", "tracer/etracer.2.0",
                "tracer/itracer.2.0", "spectra/T.2/spectrum-electron.2.0"):
        assert (tmp_path / rel).exists(), rel


def test_cli_restart_reproduces_every_dump(monkeypatch, tmp_path):
    env = {**SIZE, **DIAG_ENV, "SIGMA_ENERGY_INTERVAL": 1,
           "SIGMA_PARTICLE_INTERVAL": 4, "SIGMA_SPECTRUM_INTERVAL": 4}
    first, second = tmp_path / "first", tmp_path / "second"
    assert td.run_cli(monkeypatch, NAME, env, "SIGMA_OUT", first) == 0
    assert td.run_cli(monkeypatch, NAME, env, "SIGMA_OUT", second,
                      "--restart", str(first / "restart1" / "restart")) == 0
    # fields, four hydro, two particle, two tracer, 2 x 2 spectra files
    td.check_restart(first, second,
                     {"fields", "hydro", "particle", "tracer", "spectra"},
                     1 + 4 + 2 + 2 + 4)
    assert td.energy_steps(second / "rundata" / "energies") == [3, 4]


def test_cli_asks_for_the_card_by_default(monkeypatch, tmp_path):
    td.check_asks_for_the_card(monkeypatch, NAME,
                               {**SIZE, "SIGMA_OUT": tmp_path})


def test_sigma_deck_relativistic_walls(monkeypatch):
    """tests/test_regressions_r3.py::test_sigma_deck_relativistic_walls on
    the port: 25 steps without a dropped mover, the total energy within
    5e-3, every live lane inside the box."""
    _, tmod = td.modules(monkeypatch, NAME,
                         dict(SIGMA_NX=32, SIGMA_NZ=16, SIGMA_PPC=8))
    sim = tmod.deck(device="cpu")
    sim.finalize()
    tot0 = sum(sim.energies().values())
    sim.advance(25)
    e1 = sim.energies()
    assert all(np.isfinite(v) for v in e1.values())
    assert abs(sum(e1.values()) - tot0) / tot0 < 5e-3
    assert all(c == 0 for c in sim.mover_counts().values())
    g = sim.grid
    for sp in sim.state.species:
        i = sp.i[sp.alive].numpy()
        iz = i // (g.nxg * g.nyg)
        assert i.min() >= 0 and i.max() < g.nv
        assert iz.min() >= 1 and iz.max() <= g.nz
