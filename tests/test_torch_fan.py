"""The fan-run turbulence deck (decks/turbulence_fan.py) and its port
(vpic_tpu_torch/decks/turbulence_fan.py) at 8x8x8 cells and 2 particles
per cell: a 3D periodic pair plasma with initial ex/ey and cbx/cby/cbz
wave fields and the superluminal resampling of its load, compared as
tests/torch_decks.py sets out; the deck's energies and energy-band
spectra; the CLI with a restart.
"""

import numpy as np
import pytest

import chip_smoke as cs
from tests import torch_decks as td

NAME = "turbulence_fan"
SIZE = dict(FAN_NX=8, FAN_NY=8, FAN_NZ=8, FAN_PPC=2)
SPECIES = ("electron", "positron")


@pytest.fixture(scope="module")
def runs():
    return td.run_both(NAME, SIZE)


def test_both_packages_load_identical_particles(runs):
    assert runs["names"] == list(SPECIES)
    td.check_identical_load(runs)
    # the initial E fields are set
    assert abs(runs["t0"]["field/ex"]).max() > 0
    assert abs(runs["t0"]["field/ey"]).max() > 0


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


def test_diagnostics_inventory(monkeypatch, tmp_path):
    _, tmod = td.modules(monkeypatch, NAME, {
        **SIZE, "FAN_OUT": tmp_path, "FAN_ENERGY_INTERVAL": 2,
        "FAN_SPECTRUM_INTERVAL": 2})
    sim = tmod.deck(device="cpu")
    sim.finalize()
    for _ in range(2):
        sim.advance(1)
        tmod.diagnostics(sim)
    assert td.energy_steps(tmp_path / "energies.txt") == [2]
    for name in SPECIES:
        for rel in (f"hydro/T.2/{name}.2.0", f"hydro/T.2/spectrum-{name}.2.0"):
            assert (tmp_path / rel).exists(), rel


CLI_ENV = {**SIZE, "FAN_ENERGY_INTERVAL": 1, "FAN_SPECTRUM_INTERVAL": 2}


def test_cli_restart_reproduces_every_dump(monkeypatch, tmp_path):
    first, second = tmp_path / "first", tmp_path / "second"
    for out, extra in ((first, ()),
                       (second, ("--restart",
                                 str(first / "restart" / "restart1"
                                     / "restart")))):
        assert td.run_cli(monkeypatch, NAME, CLI_ENV, "FAN_OUT", out,
                          "--checkpoint-dir", str(out / "restart"),
                          "--checkpoint-interval", "2", *extra) == 0
    td.check_restart(first, second, {"hydro"}, 4)
    assert td.energy_steps(second / "energies.txt") == [3, 4]
    assert (first / "energies.txt").read_text().splitlines()[-1] == \
        (second / "energies.txt").read_text().splitlines()[-1]


def test_cli_asks_for_the_card_by_default(monkeypatch, tmp_path):
    td.check_asks_for_the_card(monkeypatch, NAME,
                               {**SIZE, "FAN_OUT": tmp_path})
