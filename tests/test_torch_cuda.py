"""The CUDA kernels against their plain PyTorch versions on the card, with
the checks of chip_smoke.py.  Push+walk (the push entry, the walk_only
entry and the packed push): voxels, pcode and particle floats bitwise
equal, the accumulator bitwise equal to the plain fixed-point twin
(push.advance_p_fixed, push.streak_walk_fixed) and within
1e-6 * sum|contributions| per voxel of the plain float version, and two
runs of the kernel bitwise equal; the wrapper's scratch left zero and its
scale that of deposit.fixed_scale; the unfused push (deposit kernel +
walk_only) as the plain one.  Deposit: the accumulator
within 1e-6 * sum|contributions| per word, two runs bitwise equal.  Merge
re-sort: the mark kernel's outputs and the assembly kernel's rows, key0
and anomaly bitwise equal to the plain passes', the plain fast/slow
decision, the whole re-sort bitwise the plain one's, two runs bitwise
equal.  The turbulence deck: the fixed-point rho and hydro deposits
repeat bitwise and match float64 within 1e-6 * sum|contributions|; the
push kernel on its q = 0 tracers (zero accumulator, finite scale) and on
its bulk species at full shape (3D, reflecting walls).  An open deck's
push (pending lanes left to the boundary rounds) and a round's walk_only
launch on its buffer.  The 32^2 material box (copper and a dielectric in
the bench deck's plasma) on the card and on the CPU.  Needs an NVIDIA
GPU and nvcc; skipped elsewhere.  On the card
(tests/conftest.py imports JAX, which a GPU machine need not have):

    python -m pytest tests/test_torch_cuda.py -q --noconftest
"""

import numpy as np
import pytest
import torch

import chip_smoke as cs

from vpic_tpu_torch.particles import (deposit, deposit_cuda, push, push_cuda,
                                      sort, sort_cuda)

pytestmark = pytest.mark.cuda


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "false)")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("hot", [False, True], ids=["cold", "hot"])
@pytest.mark.parametrize("pbc_name", list(cs.SMALL_FACES))
def test_push_kernel_matches_plain(device, pbc_name, hot):
    g, nb, interp, sp = cs.small_grid_case(pbc_name, hot, device)
    before = push_cuda.launches["push"]
    cs.check_push(f"{pbc_name} hot={hot}", sp, interp, nb, g, n_walk=4)
    # the kernel run and its rerun
    assert push_cuda.launches["push"] == before + 2


@pytest.mark.parametrize("hot", [False, True], ids=["cold", "hot"])
@pytest.mark.parametrize("pbc_name", list(cs.SMALL_FACES))
def test_walk_only_kernel_matches_plain(device, pbc_name, hot):
    g, nb, interp, sp = cs.small_grid_case(pbc_name, hot, device)
    st = cs.walk_state_from(sp, 5, 1.5 if hot else 0.3)
    cs.check_walk(f"{pbc_name} hot={hot}", st, nb, g, 2)


@pytest.mark.parametrize("hot", [False, True], ids=["cold", "hot"])
def test_open_push_and_round_match_plain(device, hot):
    """An open deck's push (count_pending=False: stopped lanes keep their
    codes and are not counted) and one boundary round's walk_only launch
    on its buffer of the pushed lanes, as in chip_smoke.py phase 13, on
    the small grid with an absorbing face: every pending lane is handed a
    remaining displacement to walk, as a reflux handler would."""
    from vpic_tpu_torch.particles import boundary
    g, nb, interp, sp = cs.small_grid_case("reflect+absorb", hot, device)
    cs.check_push(f"open hot={hot}", sp, interp, nb, g, n_walk=4,
                  count_pending=False)
    acc0 = torch.zeros((g.nv, 12), device=device)
    pushed, _ = push_cuda.advance_p(sp, interp, acc0, nb, g, n_walk=4,
                                    count_pending=False)
    assert int(pushed.nm) == 0 and bool((pushed.pc != 0).any())
    _, valid, b = boundary.pending_buffer(pushed, 1024)
    b["pc"] = torch.where(valid, push.PC_EXHAUSTED, 0).to(torch.int32)
    st, walkable = boundary.buffer_walk_state(b, valid)
    assert int(walkable.sum()) == int((pushed.pc != 0).sum())
    before = push_cuda.launches["walk_only"]
    cs.check_walk(f"open round hot={hot}", st, nb, g, 4)
    assert push_cuda.launches["walk_only"] == before + 2


@pytest.mark.parametrize("hot", [False, True], ids=["cold", "hot"])
@pytest.mark.parametrize("pbc_name", list(cs.SMALL_FACES))
def test_packed_push_kernel_matches_plain(device, pbc_name, hot):
    g, nb, interp, sp = cs.small_grid_case(pbc_name, hot, device)
    cs.check_packed(f"{pbc_name} hot={hot}", sp, interp, nb, g, n_walk=4)


def test_scratch_is_left_zero_with_the_plain_scale(device):
    """After a call the wrapper's int64 accumulator and work words are zero
    again, and its 2^S is deposit.fixed_scale's."""
    g, nb, interp, sp = cs.small_grid_case("periodic", True, device)
    acc0 = torch.zeros((g.nv, 12), dtype=torch.float32, device=device)
    for _ in range(2):
        push_cuda.advance_p(sp, interp, acc0, nb, g, n_walk=4)
        stream = torch.cuda.current_stream(device).cuda_stream
        fix, work, scale = push_cuda._scratch_for(device, g.nv, stream)
        assert not bool(fix.any())
        assert not bool(work[:2].any())
        want = deposit.fixed_scale(sp.q, push.segment_cap(4), sp.max_np)
        assert float(scale) == float(want)


def test_kernel_is_deterministic(device):
    g, nb, interp, sp = cs.small_grid_case("periodic", True, device)
    acc0 = torch.zeros((g.nv, 12), dtype=torch.float32, device=device)
    a, acc_a = push_cuda.advance_p(sp, interp, acc0, nb, g, n_walk=4)
    b, acc_b = push_cuda.advance_p(sp, interp, acc0, nb, g, n_walk=4)
    assert torch.equal(acc_a, acc_b)
    for name in cs.PUSH_FLOATS + ("i", "pc", "nm"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name


@pytest.mark.parametrize("case", cs.DEPOSIT_CASES,
                         ids=["sorted-5000", "sorted-1024", "unsorted-4096"])
def test_deposit_kernel_matches_plain(device, case):
    before = deposit_cuda.launches["deposit_sorted"]
    cs.check_deposit(*cs.deposit_case(case, device))
    assert deposit_cuda.launches["deposit_sorted"] == before + 2


@pytest.mark.parametrize("name", list(cs.MERGE_CASES))
def test_merge_kernel_matches_plain(device, name):
    before = dict(sort_cuda.launches)
    cs.run_merge_case(name, device)
    # each round: the kernels alone, then two merge re-sorts
    rounds = len(cs.MERGE_EXPECT_FAST[name])
    assert sort_cuda.launches["merge_mark"] - before["merge_mark"] \
        == 3 * rounds
    for k in ("merge_tables", "merge_assemble"):
        assert (sort_cuda.launches[k] - before[k]
                == 3 * sum(cs.MERGE_EXPECT_FAST[name]))


def _block(device, seed, n, np_, nvk, frac, sentinel=False,
           mover_tile=False):
    rng = np.random.default_rng(seed)
    pk, key0, ctot = cs._mk_sorted(rng, n, np_, nvk)
    pk = cs._perturb(rng, pk, np_, nvk, frac=frac)
    if sentinel:
        key0[0] = -1
    if mover_tile:   # every lane of tile 1 moves: no residual there
        tile1 = slice(sort.TILE, 2 * sort.TILE)
        pk[7, tile1] = (key0[tile1] + 1) % nvk
    t = lambda a: torch.as_tensor(a, device=device)
    return (t(pk), torch.tensor(np_, dtype=torch.int32, device=device),
            t(key0), t(ctot), nvk)


# several tiles and a ragged last one: (seed, np_, frac, sentinel, a tile
# of movers, m_cap, the merge runs)
MARK_CASES = {"multi-tile": (3, 12000, 0.05, False, False, 12388, True),
              "dead-tail": (4, 9000, 0.05, False, False, 12388, True),
              "mover-tile": (7, 12388, 0.05, False, True, 12388, True),
              "overflow": (5, 12388, 0.3, False, False, 2048, False),
              "no-snapshot": (6, 12388, 0.05, True, False, 12388, False)}


@pytest.mark.parametrize("name", list(MARK_CASES))
def test_merge_mark_and_assembly_kernels_match_plain(device, name):
    """The mark kernel's tile prefixes and first keys, counts and mover
    slots, and where the merge runs the tables and the assembly kernel's
    block, key0 and anomaly, bitwise the plain passes'; the merge re-sort
    takes the plain decision."""
    seed, np_, frac, sentinel, mover_tile, m_cap, fast = MARK_CASES[name]
    args = _block(device, seed, 3 * sort.TILE + 100, np_, 700, frac,
                  sentinel, mover_tile)
    before = dict(sort_cuda.launches)
    # the kernels alone, then two merge re-sorts
    cs.check_merge(name, *args, m_cap, fast)
    assert sort_cuda.launches["merge_mark"] - before["merge_mark"] == 3
    for k in ("merge_tables", "merge_assemble"):
        assert sort_cuda.launches[k] - before[k] == 3 * fast


def test_merge_kernels_are_deterministic(device):
    """Two runs of each merge kernel on a 50-tile block are bitwise equal
    (the mark pass's look-back order varies from run to run)."""
    pk, npt, key0, ctot, nvk = _block(device, 9, 50 * sort.TILE, 200_000,
                                      16_000, 0.05)
    m_cap = 50 * sort.TILE
    runs = [sort_cuda.mark(pk, npt, key0, ctot, nvk, m_cap)
            for _ in range(2)]
    fast, n_m = sort.fast_path(runs[0].info, m_cap)
    assert fast and torch.equal(runs[0].info, runs[1].info)
    for a, b in zip(*runs):
        assert torch.equal(a[:n_m], b[:n_m])
    plan = sort.merge_plan(runs[0], n_m)
    one, two = (sort_cuda.assemble(pk, npt, key0, ctot, runs[0], plan, nvk)
                for _ in range(2))
    assert cs._bitwise_equal(one.pk, two.pk)
    assert all(torch.equal(a, b) for a, b in zip(one[1:], two[1:]))
    assert int(one.anomaly) == 0


@pytest.fixture(scope="module")
def turb_small():
    """The turbulence deck at 16x8x8 cells, 16 per cell, on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "false)")
    return cs.turb_deck(torch.device("cuda", 0), dict(
        TURB_NX="16", TURB_NY="8", TURB_NZ="8", TURB_PPC="16"))


def test_fixed_point_deposits_repeat_and_match_float64(turb_small):
    """rho and hydro of every species: two calls bitwise equal, each node
    within 1e-6 * sum|contribution| of a float64 index_add_, plus half a
    fixed-point quantum per contribution."""
    cs.check_fixed_deposits("16x8x8", turb_small,
                            [h["name"] for h in turb_small._species])


@pytest.mark.parametrize("name", ["eR", "iR"])
def test_push_kernel_on_a_q0_species(turb_small, name):
    """A tracer (q = 0): the plain version and its twin agree with the
    kernel, every accumulator word is 0 and the scale the clamp's 2^200."""
    from vpic_tpu_torch.particles import aux
    st, g = turb_small.state, turb_small.grid
    sp = aux.sort_p(st.species[turb_small._species_by_name(name)["sid"]])
    assert int(sp.np) > 0 and not bool(sp.q.any())
    cs.check_push(name, sp, st.interpolator, st.grid_arrays.neighbor, g, 4)
    cs.check_tracer_push(sp, st.interpolator, st.grid_arrays.neighbor, g, 4)


@pytest.mark.parametrize("name", ["eT", "iB"])
def test_push_kernel_3d_reflect_walls_full_shape(device, name):
    """The turbulence deck's own shape (64x32x32 cells, 1 258 496 slots a
    species, PEC z walls reflecting particles, n_walk 4): the particle
    state bitwise the plain version's, the accumulator bitwise the
    fixed-point twin's and within 1e-6 * sum|c| plus half of 2^-S per
    contribution of the float plain version's."""
    from vpic_tpu_torch.engine.step import walk_segments
    from vpic_tpu_torch.particles import aux
    sim = cs.turb_deck(device, cs.TURB_FULL)
    st, g = sim.state, sim.grid
    n_walk = walk_segments(g, sim.opts)
    assert n_walk == 4 and (g.nx, g.ny, g.nz) == (64, 32, 32)
    sp = aux.sort_p(st.species[sim._species_by_name(name)["sid"]])
    assert sp.max_np == 1_258_496
    cs.check_push(name, sp, st.interpolator, st.grid_arrays.neighbor, g,
                  n_walk, quantum=True)


def _acc_ok(kacc, pacc, sp, interp, nb, g):
    absacc = cs.abs_deposit(push.pushed_walk_state(sp, interp, g), nb, g,
                            push.segment_cap(4))
    err = (kacc.double() - pacc.double()).abs()
    assert bool((err <= 1e-6 * absacc + 1e-30).all())


@pytest.mark.parametrize("hot", [False, True], ids=["cold", "hot"])
def test_unfused_push_matches_plain(device, hot):
    g, nb, interp, sp = cs.small_grid_case("periodic", hot, device)
    acc0 = torch.zeros((g.nv, 12), dtype=torch.float32, device=device)
    dep = deposit_cuda.launches["deposit_sorted"]
    walk = push_cuda.launches["walk_only"]
    ko, kacc = push_cuda.advance_p(sp, interp, acc0, nb, g, n_walk=4,
                                   fused=False)
    po, pacc = push.advance_p(sp, interp, acc0, nb, g, n_walk=4)
    assert deposit_cuda.launches["deposit_sorted"] == dep + 1
    assert push_cuda.launches["walk_only"] == walk + 1
    for name in cs.PUSH_FLOATS + ("i", "pc", "nm"):
        assert cs._bitwise_equal(getattr(ko, name), getattr(po, name)), name
    _acc_ok(kacc, pacc, sp, interp, nb, g)


def test_material_box_card_matches_cpu(device):
    """chip_smoke.py phase 14's 32^2 material box (8 per cell) for 16 steps
    on the card and on the CPU: the id grids and the coefficient table
    bitwise equal, energies to 1e-6, no dropped mover."""
    assert cs.material_small(device) <= 1e-6
