"""The turbulence deck (decks/turbulence.py) and its port
(vpic_tpu_torch/decks/turbulence.py) at 8x8x8 cells and 2 particles per
cell: PEC z walls with reflected particles, six species (two of them q = 0
tracers), the finalize's div-E clean and, through the port's CLI, the full
production inventory of ``standard_diagnostics`` with a restart.

- Both packages load identical particles from the deck's numpy stream.
- After 8 steps: energies to 1e-6 relative, particles as sets (voxels
  exact, floats to 1e-5 absolute), fields to 1e-5 absolute (the bars of
  tests/test_torch_slice.py) and the same dropped-mover counts.
- ``diagnostics(sim)`` writes the inventory of
  tests/test_energy_diag.py:139-146.
- The CLI (``--device cpu``, in process) runs 4 steps with a restart at 2;
  a second call with ``--restart`` reaches step 4 with the same bytes in
  every dump of step 4.  Without ``--device`` it asks for the card and
  raises where there is none.
"""

import importlib
from pathlib import Path

import numpy as np
import pytest
import torch

from vpic_tpu_torch.cli import run as cli
from vpic_tpu_torch.core.types import FIELD_COMPONENTS
from vpic_tpu_torch.interop import state_to_numpy

from tests import torch_decks  # noqa: F401  (one torch thread)

DECK = Path(__file__).resolve().parents[1] / "vpic_tpu_torch" / "decks" \
    / "turbulence.py"
SIZE = dict(TURB_NX="8", TURB_NY="8", TURB_NZ="8", TURB_PPC="2")
STEPS = 8
SPECIES = ("eT", "eB", "iT", "iB", "eR", "iR")


def _decks(mp, **env):
    """(JAX deck module, port deck module), reloaded under ``env``."""
    for k, v in {**SIZE, **env}.items():
        mp.setenv(k, str(v))
    jturb = importlib.reload(importlib.import_module("decks.turbulence"))
    tturb = importlib.reload(
        importlib.import_module("vpic_tpu_torch.decks.turbulence"))
    return jturb, tturb


@pytest.fixture(scope="module")
def runs():
    with pytest.MonkeyPatch.context() as mp:
        jturb, tturb = _decks(mp)
        jsim = jturb.deck()
        jsim.finalize()
        tsim = tturb.deck(device="cpu")
        tsim.finalize()
    out = dict(j0=state_to_numpy(jsim.state), t0=state_to_numpy(tsim.state))
    jsim.advance(STEPS)
    tsim.advance(STEPS)
    out.update(j1=state_to_numpy(jsim.state), t1=state_to_numpy(tsim.state),
               je=jsim.energies(), te=tsim.energies(),
               jnm=jsim.mover_counts(), tnm=tsim.mover_counts())
    return out


def test_both_packages_load_identical_particles(runs):
    for k in range(len(SPECIES)):
        for c in ("dx", "dy", "dz", "i", "q", "tag", "np"):
            key = f"species/{k}/{c}"
            np.testing.assert_array_equal(runs["t0"][key], runs["j0"][key],
                                          err_msg=key)
    # the top/bottom split and the tracers are all populated
    assert all(int(runs["t0"][f"species/{k}/np"]) > 0 for k in range(6))


def test_energies_and_movers_match(runs):
    for name, e in runs["je"].items():
        np.testing.assert_allclose(runs["te"][name], e, rtol=1e-6,
                                   atol=1e-12, err_msg=name)
    assert runs["tnm"] == runs["jnm"]
    print("dropped movers after 8 steps:", runs["tnm"])


def _sorted_particles(d, k):
    pre = f"species/{k}/"
    n = int(d[pre + "np"])
    cols = {c: d[pre + c][:n] for c in ("i", "dx", "dy", "dz", "ux", "uy",
                                         "uz", "q", "tag")}
    order = np.lexsort((cols["dz"], cols["dy"], cols["dx"], cols["tag"],
                        cols["i"]))
    return {c: v[order] for c, v in cols.items()}


@pytest.mark.parametrize("k", range(len(SPECIES)), ids=SPECIES)
def test_particles_match_as_sets(runs, k):
    t = _sorted_particles(runs["t1"], k)
    j = _sorted_particles(runs["j1"], k)
    np.testing.assert_array_equal(t["i"], j["i"])
    np.testing.assert_array_equal(t["tag"], j["tag"])
    for c in ("dx", "dy", "dz", "ux", "uy", "uz", "q"):
        np.testing.assert_allclose(t[c], j[c], rtol=0, atol=1e-5, err_msg=c)


def test_fields_match(runs):
    for c in FIELD_COMPONENTS:
        np.testing.assert_allclose(runs["t1"][f"field/{c}"],
                                   runs["j1"][f"field/{c}"], rtol=0,
                                   atol=1e-5, err_msg=c)
    np.testing.assert_allclose(runs["t1"]["interpolator"],
                               runs["j1"]["interpolator"], rtol=0, atol=1e-5)


def test_standard_inventory(monkeypatch, tmp_path):
    _, tturb = _decks(monkeypatch, TURB_OUT=tmp_path, TURB_ENERGY_INTERVAL=2,
                      TURB_FIELD_INTERVAL=2, TURB_PARTICLE_INTERVAL=4,
                      TURB_RESTART_INTERVAL=4, TURB_TRACER_INTERVAL=4)
    sim = tturb.deck(device="cpu")
    sim.finalize()
    tturb.diagnostics(sim)             # step 0: the one-time rundata dumps
    for _ in range(4):
        sim.advance(1)
        tturb.diagnostics(sim)
    for rel in ("rundata/grid.0", "rundata/materials", "rundata/species",
                "rundata/energies", "global.vpc",
                "fields/fields.2.0", "fields/fields.4.0",
                "hydro/eThydro.2.0", "hydro/iBhydro.4.0",
                "particle/eTparticle.4.0", "particle/iBparticle.4.0",
                "restart1/restart.json",
                "tracer/etracer.4.0", "tracer/itracer.4.0"):
        assert (tmp_path / rel).exists(), rel


CLI_ENV = dict(TURB_ENERGY_INTERVAL=1, TURB_FIELD_INTERVAL=2,
               TURB_PARTICLE_INTERVAL=4, TURB_RESTART_INTERVAL=2,
               TURB_TRACER_INTERVAL=2, TURB_SPECTRUM_INTERVAL=4)


def _cli(monkeypatch, out, *args):
    for k, v in {**SIZE, **CLI_ENV, "TURB_OUT": out}.items():
        monkeypatch.setenv(k, str(v))
    return cli.main([str(DECK), "--device", "cpu", "--num-step", "4",
                     "--status-interval", "2", *args])


def test_cli_restart_reproduces_every_dump(monkeypatch, tmp_path):
    first, second = tmp_path / "first", tmp_path / "second"
    assert _cli(monkeypatch, first) == 0
    assert _cli(monkeypatch, second, "--restart",
                str(first / "restart1" / "restart")) == 0
    dumps = sorted(p.relative_to(first) for p in first.rglob("*")
                   if p.is_file() and (p.name.endswith(".4.0")
                                       or p.parent.name == "T.4"))
    kinds = {p.parts[0] for p in dumps}
    assert kinds == {"fields", "hydro", "particle", "tracer", "spectra"}
    assert len(dumps) == 1 + 6 + 4 + 2 + 8
    for rel in dumps:
        assert (first / rel).read_bytes() == (second / rel).read_bytes(), rel
    # the restart continued from step 2: its energies start at step 3
    steps = [int(line.split()[0]) for line in
             (second / "rundata" / "energies").read_text().splitlines()
             if not line.startswith("%")]
    assert steps == [3, 4]


def test_cli_asks_for_the_card_by_default(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for k, v in {**SIZE, "TURB_OUT": tmp_path}.items():
        monkeypatch.setenv(k, str(v))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main([str(DECK), "--num-step", "1"])
