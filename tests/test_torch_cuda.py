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
the bench deck's plasma) on the card and on the CPU.  The probe kernels
of csrc/probes.cu (the tools path): each at its tool's shapes bitwise its
plain version and a rerun, gather3d and deposit2d on random operands at
the tool's and two ragged shapes (bitwise across a rerun, within K *
2^-24 * sum|terms|) and their launcher's refusal of a plan off its
constants, the chain at 1024 reps on every shape of
tools/vpu_layout_probe.py and at chip_smoke's ragged reps and windows,
io4d, stack8 and onehot3d at ragged and offset inputs, the refusal of a
chain or io4d plan off its block, and of a stack8 or onehot3d plan that
takes 16-byte accesses or the staged row on a pointer off 16 bytes.
The harness tools on the card: the evidence tool twice (EVIDENCE OK, the
checksums repeated, one push launch per species and step) and the
scaling sweep on one small configuration.  The threefry kernel
(csrc/threefry.cu) bitwise its twin (normal within a few ulps), its
launcher's refusals, and the reflux box graphed bitwise its eager steps.
The sharded step on the card: a 2 x 2-shard bench deck graphed bitwise
its eager steps, the shard threads on the caller's stream, a shard that
raises inside a capture failing the call with its own exception (the
next advance runs), and eager sharded steps (a migration round, a clean)
without a host read under ``torch.cuda.set_sync_debug_mode("error")``.
Needs an NVIDIA
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


@pytest.mark.parametrize("name", ["gather3d", "deposit2d", "stack8",
                                  "onehot3d", "io4d"])
def test_probe_kernel_matches_plain(device, name):
    from vpic_tpu_torch.tools import probe_batched
    before = probe_batched.launches[name]
    cs.check_probe(name, device)
    assert probe_batched.launches[name] == before + 2


@pytest.mark.parametrize("case", [0, 1, 2],
                         ids=["tool-shape", "one-split", "ragged"])
@pytest.mark.parametrize("name", ["gather3d", "deposit2d"])
def test_probe_contraction_on_random_operands(device, name, case):
    """The cluster split-K kernels on random operands, at the tool's
    shapes and at the ragged shapes of their plan: bitwise across two
    runs, within K * 2^-24 * sum|terms| of the plain float32 sum, one
    launch per wrapper call."""
    from vpic_tpu_torch.tools import probe_batched
    shapes = None if case == 0 else cs.PROBE_RAGGED[name][case - 1]
    before = probe_batched.launches[name]
    cs.check_contraction(name, device, shapes=shapes)
    assert probe_batched.launches[name] == before + 2


@pytest.mark.parametrize("field", ["bn", "chunk", "splits"])
@pytest.mark.parametrize("name", ["gather3d", "deposit2d"])
def test_probe_launcher_refuses_a_plan_off_its_constants(device, name,
                                                         field):
    """A plan whose column tile, share or cluster differ from what the
    kernel was built for is refused at launch (cudaErrorInvalidValue),
    and nothing is counted."""
    from vpic_tpu_torch.tools import probe_batched, probes_cuda
    a, oh = probe_batched.tool_inputs(name, device)
    if name == "gather3d":
        plan = probe_batched.gather3d_plan(a.shape[0], *oh.shape)
        shape, out = (a.shape[0], *oh.shape), torch.empty(
            (a.shape[0], oh.shape[0], oh.shape[2]), device=device)
    else:
        plan = probe_batched.deposit2d_plan(*a.shape[:2], *oh.shape[1:])
        shape, out = (*a.shape[:2], *oh.shape[1:]), torch.empty(
            (a.shape[0], oh.shape[1]), device=device)
    args = list(plan.args())
    index = {"bn": 3, "chunk": 11, "splits": 2}[field]
    args[index] = args[index] * 2 if field != "chunk" else args[index] + 1
    before = probe_batched.launches[name]
    with pytest.raises(RuntimeError, match="cudaError 1"):
        probes_cuda.launch(f"vpic_probe_{name}", probe_batched.launches,
                           name, device, a, oh, out, *shape, *args)
    assert probe_batched.launches[name] == before


def test_vpu_chain_kernel_matches_plain(device):
    from vpic_tpu_torch.tools import vpu_layout_probe
    before = vpu_layout_probe.launches["vpu_chain"]
    cs.check_chains(device)
    assert vpu_layout_probe.launches["vpu_chain"] == \
        before + 4 * len(vpu_layout_probe.ROWS) + 2 * len(cs.CHAIN_RAGGED)


@pytest.mark.parametrize("rows,shape,reps", cs.CHAIN_RAGGED,
                         ids=[f"rows{r}-{s[0]}x{s[1]}-reps{k}"
                              for r, s, k in cs.CHAIN_RAGGED])
def test_vpu_chain_kernel_ragged(device, rows, shape, reps):
    """The chain at reps around its 16-rep unroll and with zeros that
    start or end off a 16-byte boundary: bitwise its plain version and a
    rerun, the rows past the window zeros."""
    from vpic_tpu_torch.tools import vpu_layout_probe
    x = torch.as_tensor(np.random.default_rng(reps).uniform(
        0, 3, size=shape).astype(np.float32), device=device)
    before = vpu_layout_probe.launches["vpu_chain"]
    cs.check_chain_case(x, rows, reps)
    assert vpu_layout_probe.launches["vpu_chain"] == before + 2


def test_io4d_kernel_on_ragged_and_offset_inputs(device):
    """io4d with R*L not a multiple of 4, from a contiguous slice along
    dim 0 and from 4 bytes into its storage: the one-float path, bitwise
    its plain version and a rerun."""
    from vpic_tpu_torch.tools import probe_batched
    before = probe_batched.launches["io4d"]
    cs.check_io4d(device)
    assert probe_batched.launches["io4d"] == before + 2 * len(cs.IO4D_CASES)


@pytest.mark.parametrize("field", ["pairs", "blocks", "head", "io4d width",
                                   "io4d blocks"])
def test_chain_and_io4d_launchers_refuse_a_plan_off_the_block(device,
                                                              field):
    """A plan that would leave a float unwritten, write one twice or
    take 16-byte accesses off a 16-byte boundary is refused at launch
    (cudaErrorInvalidValue), and nothing is counted."""
    from vpic_tpu_torch.tools import probe_batched, probes_cuda
    from vpic_tpu_torch.tools import vpu_layout_probe as vp
    if field.startswith("io4d"):
        ps = cs.io4d_input("4 bytes in", device)
        b, _, r, lane = ps.shape
        plan = probe_batched.io4d_plan(b, r * lane, True)
        plan = (plan._replace(blocks=plan.blocks + 1)
                if field == "io4d blocks" else plan)
        out = torch.empty((b, 16, r, lane), device=device)
        fn, counts, key = "vpic_probe_io4d", probe_batched.launches, "io4d"
        args = (ps, out, b, r * lane, *plan)
    else:
        x = torch.ones((7, 130), device=device)
        plan = vp.chain_plan(5, 130, 7)
        plan = plan._replace(**{field: getattr(plan, field) + 1})
        fn, counts, key = "vpic_probe_vpu_chain", vp.launches, "vpu_chain"
        args = (x, torch.empty_like(x), 5, 130, 7, 17, *plan)
    before = counts[key]
    with pytest.raises(RuntimeError, match="cudaError 1"):
        probes_cuda.launch(fn, counts, key, device, *args)
    assert counts[key] == before


def test_stack8_and_onehot3d_on_ragged_and_offset_inputs(device):
    """stack8 and onehot3d on chip_smoke's cases: lane counts not a
    multiple of 4, loc and win from 4 bytes into their storage, one-row
    windows, w not a multiple of 4, a row past the shared-memory budget
    and positions outside [0, w): bitwise the plain version and a rerun
    on the plan each case expects, one launch per wrapper call."""
    from vpic_tpu_torch.tools import probe_batched
    before = dict(probe_batched.launches)
    cs.check_stack8_onehot3d(device)
    assert probe_batched.launches["stack8"] == \
        before["stack8"] + 2 * len(cs.STACK8_CASES)
    assert probe_batched.launches["onehot3d"] == \
        before["onehot3d"] + 2 * len(cs.ONEHOT3D_CASES)


@pytest.mark.parametrize("field", ["stack8 width", "stack8 stage",
                                   "stack8 chunks", "onehot3d width",
                                   "onehot3d blocks"])
def test_stack8_and_onehot3d_launchers_refuse_a_misaligned_plan(device,
                                                                field):
    """A plan that takes 16-byte accesses of a loc, or the bulk copy of a
    win row, 4 bytes into its storage, or that does not cover the output
    once, is refused at launch (cudaErrorInvalidValue): nothing runs and
    nothing is counted."""
    from vpic_tpu_torch.tools import probe_batched as pb
    from vpic_tpu_torch.tools import probes_cuda
    if field.startswith("stack8"):
        case = "win 4 bytes in" if field == "stack8 stage" else \
            "loc 4 bytes in"
        win, loc = cs.stack8_input(case, device)
        (a, w), (s, lane) = win.shape, loc.shape
        plan = pb.stack8_plan(a, w, s, lane, True, True)
        assert plan.stage == 1 and plan.width == 4
        if field == "stack8 chunks":
            plan = plan._replace(chunks=plan.chunks + 1)
            win, loc = (t.clone() for t in (win, loc))
        out = torch.empty((a, s, lane), device=device)
        fn, key, args = ("vpic_probe_stack8", "stack8",
                         (win, loc, out, a, w, s, lane, *plan))
    else:
        loc, w = cs.onehot3d_input("loc 4 bytes in", device)
        r, lane = loc.shape
        plan = pb.onehot3d_plan(r, w, lane, True)
        assert plan.width == 4
        if field == "onehot3d blocks":
            plan = plan._replace(blocks=plan.blocks + 1)
            loc = loc.clone()
        out = torch.empty((r, w, lane), device=device)
        fn, key, args = ("vpic_probe_onehot3d", "onehot3d",
                         (loc, out, r, w, lane, *plan))
    before = pb.launches[key]
    with pytest.raises(RuntimeError, match="cudaError 1"):
        probes_cuda.launch(fn, pb.launches, key, device, *args)
    assert pb.launches[key] == before


def test_evidence_on_the_card_repeats_its_checksums(device, tmp_path,
                                                    capsys):
    """The evidence tool twice at 128^2 with 4096 particles over 16 steps
    (the 16^2 sheet drifts past the tool's 1e-4 bar in both packages):
    EVIDENCE OK, one push launch per species and step, the checksums of
    the two runs equal."""
    import json
    from vpic_tpu_torch.tools import evidence
    out = tmp_path / "evidence.jsonl"
    for _ in range(2):
        push_cuda.reset_launch_counts()
        assert evidence.main(["16", "4096", "128", "--out", str(out)]) == 0
        assert push_cuda.launches["push"] == 16 * 2
    assert capsys.readouterr().out.count("EVIDENCE OK") == 2
    one, two = (json.loads(x) for x in out.read_text().splitlines())
    assert one["backend"] == "cuda" and "card" in one
    assert one["dropped_movers"] == {"electron": 0, "ion": 0}
    for k in ("field_sha1", "species_sha1", "energy1"):
        assert one[k] == two[k], k


def test_sweep_on_the_card(device):
    """scaling_bench.sweep on one 32^2 configuration: the row's count, no
    dropped mover, one push launch per species and step."""
    from vpic_tpu_torch.tools import scaling_bench as sb
    push_cuda.reset_launch_counts()
    (row, sim), = list(sb.sweep([(65_536, 32, 32, 1)], 8, device))
    assert row["npart"] == 65_536 and row["ms_per_step"] > 0
    assert sim.mover_counts() == {"electron": 0, "ion": 0}
    assert push_cuda.launches["push"] == \
        2 * (row["period"] + 2 * row["nst"])


def _bench32(device):
    from vpic_tpu_torch.decks import bench_deck
    return bench_deck.build(nx=32, ny=32, nz=1, npart=65_536, device=device)


def test_graphed_step_is_bitwise_the_eager_step(device):
    """The 32^2 bench deck through its CUDA graphs (engine/graphs.py) and
    op by op from one seed: 19 steps (two super-cycles, then an A cycle
    and a step) give the same fields, species, energies and movers, bit
    for bit, and no graphed step ran eagerly."""
    g, e = _bench32(device), _bench32(device)
    assert g.graphed
    g.advance(19)
    e.advance_eager(19)
    assert g.checksum_fields() == e.checksum_fields()
    for h in g._species:
        assert g.checksum_species(h["name"]) == e.checksum_species(h["name"])
    assert g.energies() == e.energies()
    assert g.mover_counts() == e.mover_counts() == {"electron": 0, "ion": 0}
    assert g.dispatch_counts == {"captures": 3, "replays.supercycle": 2,
                                 "replays.cycle": 1, "replays.step": 1,
                                 "graphed_steps": 19}


def test_a_replay_adds_its_graphs_launch_counts(device):
    """A graph keeps the kernel launches its capture made and adds them at
    each replay: one push launch per species and step; the capture's own
    and its warm-up's launches are not counted."""
    g = _bench32(device)
    push_cuda.reset_launch_counts()
    g.advance(8)
    assert push_cuda.launches["push"] == 8 * 2
    push_cuda.reset_launch_counts()
    g.advance(16)
    assert push_cuda.launches == {"push": 16 * 2, "walk_only": 0}
    assert g.dispatch_counts["captures"] == 1
    assert g.dispatch_counts["replays.supercycle"] == 3


def test_a_failed_capture_raises(device):
    """A deck that _graph_ok() admits, whose field-injection hook reads the
    card from the host: the capture fails and advance raises; no step runs
    eagerly in its place."""
    from vpic_tpu_torch.deck.api import Simulation

    def hook(state):
        float(state.field.ex.sum())
        return state

    sim = Simulation(device=device)
    sim.define_units(1.0, 1.0)
    sim.define_timestep(0.05)
    sim.define_periodic_grid(0, 0, 0, 1, 1, 1, 16, 16, 1)
    sim.define_species("electron", -1.0, 1024)
    sim.finalize(user_field_injection=hook)
    assert sim.graphed
    with pytest.raises(RuntimeError):
        sim.advance(2)
    assert sim.dispatch_counts["eager_steps"] == 0
    assert sim.step_count == 0
    torch.cuda.synchronize()


def test_threefry_kernel_matches_its_twin(device):
    """chip_smoke's check at the 256^2 collisions deck's lane count: split
    and uniform bitwise the plain twin on the card and on the CPU, normal
    within NORMAL_ULPS, two runs bitwise equal."""
    errs = cs.check_threefry(device)
    assert errs["split"] == errs["uniform"] == 0.0


def test_threefry_launcher_refuses_what_it_cannot_do(device):
    """A split into a misaligned output (its 16-byte stores), a draw of
    2^32 counters and a key on the CPU are refused; n = 0 launches
    nothing."""
    import ctypes
    from vpic_tpu_torch.core import random as rnd, random_cuda
    key = rnd.make_key(3, device)
    buf = torch.empty(2 * 8 + 2, dtype=torch.int64, device=device)
    with pytest.raises(ValueError, match="16-byte"):
        random_cuda._launch("split", key, buf[1:17].view(8, 2), 8)
    err = random_cuda._lib().vpic_threefry(
        key.data_ptr(), ctypes.c_void_p(buf.data_ptr() + 8), 8, 0, 0.0, 1.0,
        torch.cuda.current_stream(device).cuda_stream)
    assert err == 1     # cudaErrorInvalidValue
    with pytest.raises(ValueError, match="2\\^32"):
        rnd.uniform(key, 2 ** 32)
    with pytest.raises(ValueError, match="CUDA tensors"):
        random_cuda.split(key.cpu(), 4)
    random_cuda.reset_launch_counts()
    assert rnd.normal(key, 0).shape == (0,)
    assert random_cuda.launches["threefry_normal"] == 0


def test_an_open_deck_graphed_is_bitwise_eager(device):
    """The reflux box at 32^2 (the draws on the card every step) through
    its CUDA graphs and op by op from one seed: 12 steps give the same
    fields, species, energies, random state and movers, bit for bit, and
    each replay adds its threefry launches."""
    from vpic_tpu_torch.core import random_cuda
    g, e = (cs.open_box(device, "reflux", nx=32, ppc=16) for _ in range(2))
    assert g.graphed
    random_cuda.reset_launch_counts()
    g.advance(12)
    graphed = dict(random_cuda.launches)
    random_cuda.reset_launch_counts()
    e.advance_eager(12)
    assert graphed == random_cuda.launches
    assert graphed["threefry_normal"] == 12 * 2 * g.opts.num_comm_round
    assert g.checksum_fields() == e.checksum_fields()
    assert g.checksum_species("electron") == e.checksum_species("electron")
    assert g.energies() == e.energies()
    assert torch.equal(g.state.rng, e.state.rng)
    assert g.mover_counts() == e.mover_counts() == {"electron": 0}
    assert g.dispatch_counts["graphed_steps"] == 12


def _shards32(device):
    from vpic_tpu_torch.decks import bench_deck
    return bench_deck.build(nx=32, ny=32, nz=1, npart=65_536, px=2, py=2,
                            device=device)


def _same_shards(a, b):
    assert a.checksum_fields() == b.checksum_fields()
    for h in a._species:
        assert a.checksum_species(h["name"]) == b.checksum_species(h["name"])
    assert a.energies() == b.energies()
    for x, y in zip(a.states, b.states):
        assert torch.equal(x.rng, y.rng)


def test_sharded_graphed_step_is_bitwise_the_eager_step(device):
    """The 32^2 bench deck on 2 x 2 shards of the card through its CUDA
    graphs and op by op from one seed: 19 steps (two super-cycles, an A
    cycle and a step) give the same fields, species, energies and movers
    on every shard, bit for bit, with equal kernel launches, and no
    graphed step ran eagerly."""
    g, e = _shards32(device), _shards32(device)
    assert g.graphed and g.grid.n_shards == 4
    push_cuda.reset_launch_counts()
    g.advance(19)
    graphed = dict(push_cuda.launches)
    push_cuda.reset_launch_counts()
    e.advance_eager(19)
    assert graphed == push_cuda.launches
    assert graphed["walk_only"] == 19 * 2 * 4 * g.opts.num_comm_round
    _same_shards(g, e)
    assert g.mover_counts() == e.mover_counts() == {"electron": 0, "ion": 0}
    assert g.dispatch_counts == {"captures": 3, "replays.supercycle": 2,
                                 "replays.cycle": 1, "replays.step": 1,
                                 "graphed_steps": 19}
    assert all(c["nodes"] > 0 for c in g.capture_times)
    assert g.comms[0].rv.slots == [None] * 4


def _pool_bytes():
    out = {}
    for seg in torch.cuda.memory_snapshot():
        key = tuple(seg["segment_pool_id"])
        out[key] = out.get(key, 0) + seg["total_size"]
    return out


def test_shard_threads_capture_into_the_runners_pool(device, monkeypatch):
    """The shard threads' launches are captured, the graph bitwise the
    eager steps, and their allocations land in the runner's pool: no other
    pool grows during the capture."""
    from vpic_tpu_torch.engine import graphs
    growth, orig = [], graphs.GraphRunner._record

    def record(self, body, start, n):
        torch.cuda.synchronize()
        before = _pool_bytes()
        out = orig(self, body, start, n)
        torch.cuda.synchronize()
        after = _pool_bytes()
        growth.append((tuple(self.pool), {
            k: v - before.get(k, 0) for k, v in after.items()
            if v > before.get(k, 0)}))
        return out

    monkeypatch.setattr(graphs.GraphRunner, "_record", record)
    g, e = _shards32(device), _shards32(device)
    g.advance(8)
    e.advance_eager(8)
    _same_shards(g, e)
    (pool, grown), = growth
    assert set(grown) == {pool}, grown


def test_run_shards_runs_on_the_callers_stream(device):
    """Each shard thread takes the caller's current stream, not its own
    thread's default stream."""
    from vpic_tpu_torch.core.types import Grid
    from vpic_tpu_torch.engine import distributed as dist
    g = Grid(nx=4, ny=4, nz=4, gpx=2, gpy=2)
    comms = dist.make_comms(g, dist.make_mesh(g, [device]), timeout=30)
    side = torch.cuda.Stream(device)
    with torch.cuda.stream(side):
        got = dist.run_shards(comms, lambda c: torch.cuda.current_stream())
    assert got == [side] * 4
    assert dist.run_shards(comms, lambda c: torch.cuda.current_stream()) \
        == [torch.cuda.current_stream(device)] * 4


@pytest.mark.parametrize("how", ["raise", "host read"])
def test_a_shard_that_fails_inside_a_capture(device, how):
    """Shard 1's field-injection hook fails inside the first two captures
    (a Python exception, or a read of the card from the host, which
    invalidates the capture): each advance raises that shard's own
    exception in bounded time, keeps no graph and leaves the state as it
    was; the next advance captures (into a new pool where the capture was
    invalidated) and runs, bitwise an eager twin."""
    import threading
    import time
    from tests.torch_decks import hooked_shards
    armed = [2]

    def hook(state):
        if (armed[0] and torch.cuda.is_current_stream_capturing()
                and threading.current_thread().name == "shard-1"):
            armed[0] -= 1
            if how == "raise":
                raise KeyError("shard one")
            float(state.field.ex.sum())
        return state

    sim = hooked_shards(device, hook)
    twin = hooked_shards(device, lambda st: st)
    assert sim.graphed
    before = sim.checksum_fields()
    for _ in range(2):
        t0 = time.perf_counter()
        with pytest.raises(KeyError if how == "raise" else RuntimeError) \
                as err:
            sim.advance(2)
        assert time.perf_counter() - t0 < 60
        assert "ShardError" not in type(err.value).__name__
        assert not sim._graphs.graphs
        assert sim.step_count == 0
        assert sim.dispatch_counts["eager_steps"] == 0
        assert sim.checksum_fields() == before
    sim.advance(2)
    twin.advance_eager(2)
    _same_shards(sim, twin)
    assert sim.dispatch_counts["graphed_steps"] == 2


def test_eager_sharded_steps_read_nothing_back(device):
    """After a first step (which builds the kernels and the face tables),
    eager steps of the 2 x 2-shard bench deck (migration rounds) and of a
    two-z-shard box that cleans div E every other step (an allsum) run
    under torch.cuda.set_sync_debug_mode("error"): no host read and no
    copy from the host."""
    from tests.torch_decks import hooked_shards
    box = hooked_shards(device, px=1, py=1, pz=2, nz=4)
    box.modify_runparams(clean_div_e_interval=2, clean_div_b_interval=2)
    sims = [_shards32(device), box]
    for sim in sims:
        sim.advance_eager(1)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for sim in sims:
            sim.advance_eager(3)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert [sim.step_count for sim in sims] == [4, 4]
