"""What decides ``correct``, driven through the harness at a size a test
run holds: each cell is correct on the program; a step that returns its
state unchanged, half of the particles left out with the current of the
rest doubled, and one momentum altered where the push produces it each
make it false, and so do a PEC adjust of J left out and reflecting walls
made periodic on a walled cell; and the control, the reference in
bfloat16 in the program's place, fails the cell's limits.  On the CPU
the program steps op by op; ``-m cuda`` runs the card's graphed path."""

import pytest
import torch

from picbench import control, judge, run, spec, state
from picbench.tests.conftest import SMALL
from vpic_tpu_torch.deck.api import Simulation
from vpic_tpu_torch.field import ghost
from vpic_tpu_torch.particles import push_cuda

CELLS = sorted(SMALL)
SEED = 2 ** 31 + 101


def run_small(name, device="cpu", seed=SEED):
    return run.run_cell(name, seed, 0.2, 0, device=device,
                        overrides=SMALL[name])


@pytest.mark.parametrize("name", CELLS)
def test_the_program_is_correct(name):
    out = run_small(name)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0
    assert list(out)[-1] == "checks"


def unchanged(monkeypatch):
    build = Simulation._build_advance

    def still(self):
        build(self)
        self._advance = lambda states, flags, step: states

    monkeypatch.setattr(Simulation, "_build_advance", still)


def half_left_out(monkeypatch):
    push = push_cuda.advance_p

    def half(sp, interp, acc, nb, g, **kw):
        first = torch.arange(sp.max_np, device=sp.q.device) < sp.np // 2
        acc0 = acc.clone()
        out, acc1 = push(sp.replace(q=torch.where(first, sp.q, 0.0)),
                         interp, acc, nb, g, **kw)
        kept = {k: torch.where(first, getattr(out, k), getattr(sp, k))
                for k in ("dx", "dy", "dz", "i", "ux", "uy", "uz")}
        return out.replace(q=sp.q, **kept), acc0 + 2 * (acc1 - acc0)

    monkeypatch.setattr(push_cuda, "advance_p", half)


def altered(monkeypatch):
    push = push_cuda.advance_p

    def one_off(sp, *a, **kw):
        out, acc = push(sp, *a, **kw)
        ux = out.ux.clone()
        ux[0] += 1.0
        return out.replace(ux=ux), acc

    monkeypatch.setattr(push_cuda, "advance_p", one_off)


@pytest.mark.parametrize("fault", [unchanged, half_left_out, altered])
@pytest.mark.parametrize("name", CELLS)
def test_a_fault_in_the_timed_path_is_not_correct(name, fault, monkeypatch):
    fault(monkeypatch)
    out = run_small(name)
    assert not out["correct"], out["checks"]
    assert out["failed"] == out["attempted"]


def j_adjust_skipped(monkeypatch):
    """The PEC adjust of J left out: tangential current stays on the
    walls."""
    monkeypatch.setattr(ghost, "adjust_jf", lambda f, g, comm: f)


def walls_made_periodic(monkeypatch):
    """The neighbour table's reflecting z faces made periodic: a lane
    that reaches a wall comes in through the other."""
    push = push_cuda.advance_p

    def through(sp, interp, acc, nb, g, **kw):
        t = nb.clone()
        plane = (g.nx + 2) * (g.ny + 2)
        v = torch.arange(t.shape[0], device=t.device)
        z = v // plane
        t[:, 2] = torch.where((z == 1) & (t[:, 2] < 0),
                              v + (g.nz - 1) * plane, t[:, 2])
        t[:, 5] = torch.where((z == g.nz) & (t[:, 5] < 0),
                              v - (g.nz - 1) * plane, t[:, 5])
        return push(sp, interp, acc, t, g, **kw)

    monkeypatch.setattr(push_cuda, "advance_p", through)


WALLED = [n for n in CELLS
          if spec.workload(n)["config"].get("reference") == "walls"]


@pytest.mark.parametrize("fault", [j_adjust_skipped, walls_made_periodic])
@pytest.mark.parametrize("name", WALLED)
def test_a_fault_in_the_walls_is_not_correct(name, fault, monkeypatch):
    fault(monkeypatch)
    out = run_small(name)
    assert not out["correct"], out["checks"]


def check_control(name, device):
    limits = spec.workload(name)["cell"]["limits"]
    r = control.readings(name, SEED, 0.2, device=device,
                         overrides=SMALL[name])
    assert judge.verdict(r["program"], limits), r["program"]
    assert not judge.verdict(r["control"], limits), r["control"]
    # every float number of the control is over its limit
    for k, v in r["control"].items():
        if limits[k]:
            assert v > limits[k], (k, v)


@pytest.mark.parametrize("name", CELLS)
def test_the_control_fails(name):
    check_control(name, "cpu")


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_the_control_fails_on_the_card(name, card):
    check_control(name, card)


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_a_small_cell_is_correct_on_the_card(name, card):
    out = run_small(name, card)
    assert out["correct"], out["checks"]
    assert out["device"]["platform"] == "gpu"


def spread_pair(name, fault_in_unit, monkeypatch):
    """A small run of ``name`` with one compared unit in mid-window, read
    both ways: by a snapshot after it and by its :func:`state.summary`;
    with ``fault_in_unit`` one momentum is altered in that unit's push
    and nowhere else.  Returns (cell, before, snapshot after, summary)."""
    on = [False]
    push = push_cuda.advance_p

    def maybe(sp, *a, **kw):
        out, acc = push(sp, *a, **kw)
        if on[0]:
            ux = out.ux.clone()
            ux[0] += 1.0
            out = out.replace(ux=ux)
        return out, acc

    monkeypatch.setattr(push_cuda, "advance_p", maybe)
    cell = run.Cell(name, SEED, 0.2, "cpu", SMALL[name])
    cell.setup()
    cell.window(0.1)
    box = judge.config_module(cell.cfg["name"]).box(cell.cfg)
    q_m = {s["name"]: s["q_m"] for s in cell.cfg["species"]}
    before = state.snapshot(cell.sim)
    on[0] = fault_in_unit
    cell.advance(cell.unit)
    on[0] = False
    return cell, before, state.snapshot(cell.sim), state.summary(
        cell.sim, box, q_m, judge.reference(cell.cfg))


@pytest.mark.parametrize("name", CELLS)
def test_a_unit_read_by_its_summary_reads_as_by_its_snapshot(
        name, monkeypatch):
    cell, before, after, summ = spread_pair(name, False, monkeypatch)
    by_snap = judge.readings(cell.cfg, SEED, cell.start, [before, after],
                             "cpu")
    by_summ = judge.readings(cell.cfg, SEED, cell.start, [before], "cpu",
                             pairs=[(before, summ)])
    for k in by_snap:
        assert by_summ[k] == pytest.approx(by_snap[k], rel=1e-9, abs=1e-15)


@pytest.mark.parametrize("name", CELLS)
def test_a_fault_on_one_mid_window_step_shows_only_in_its_spread_unit(
        name, monkeypatch):
    """The reference follows the program from the program's own state, so
    the units after the window do not see a fault confined to an earlier
    step that conserves charge; a spread unit over that step does."""
    limits = spec.workload(name)["cell"]["limits"]
    cell, before, after, summ = spread_pair(name, True, monkeypatch)
    units = cell.compared_units()
    cell.release()
    late = judge.readings(cell.cfg, SEED, cell.start, units, "cpu")
    assert judge.verdict(late, limits), late
    spread = judge.readings(cell.cfg, SEED, cell.start, units, "cpu",
                            pairs=[(before, summ)])
    assert not judge.verdict(spread, limits), spread
