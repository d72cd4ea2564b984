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
re-sort: the mark kernel's outputs and the tables and assembly kernels'
rows, key0, tables and anomaly bitwise equal to the plain passes', on
fast and slow blocks, the assembly following the decision in device
memory, the plain fast/slow decision, the whole re-sort bitwise the
plain one's, two runs bitwise equal; path B (the packed cycle with the
merge re-sort) graphed bitwise its eager steps, across a restore too, and
its eager steps without a host read.  The turbulence deck: the fixed-point rho and hydro deposits
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
The step deciding on the card (engine/cond.py): a graph of conditional
nodes replays the branch its predicate names, nested too, a body's
launches counted per run, and entry()'s step captured once replays
bitwise Simulation.advance.  The cond of several shards on the card: one
node around every shard's part of a body, on 2 and 4 shards, nested,
replaying only the branch taken on every shard (the tally words) and
bitwise the eager select, a shard failing inside a body failing the
capture with its own exception; two z shards cleaning every other step
in one capture, with conditional nodes, bitwise eager.  The device-clock
spans (engine/spans.py): replays stamp every step's parts, and the
cleans inside their conditional bodies on the clean steps only; a
profiled window between cleans aligns with its stamps within 5 us; the
spans add two kernel nodes each outside the bodies and change no bit of
the state.  Needs an NVIDIA GPU and nvcc; skipped elsewhere.  On the card
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
    # each round: the kernels alone (the assembly in both modes), then two
    # merge re-sorts, each running both branches eagerly
    rounds = len(cs.MERGE_EXPECT_FAST[name])
    for k, per_round in (("merge_mark", 3), ("merge_tables", 3),
                         ("merge_assemble", 6)):
        assert sort_cuda.launches[k] - before[k] == per_round * rounds


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
    # the kernels alone, then two merge re-sorts, fast or slow: a mark and
    # a tables launch per call, the assembly in both modes
    cs.check_merge(name, *args, m_cap, fast)
    for k, n in (("merge_mark", 3), ("merge_tables", 3),
                 ("merge_assemble", 6)):
        assert sort_cuda.launches[k] - before[k] == n


def test_merge_kernels_are_deterministic(device):
    """Two runs of each merge kernel on a 50-tile block are bitwise equal
    (the mark pass's look-back order varies from run to run)."""
    pk, npt, key0, ctot, nvk = _block(device, 9, 50 * sort.TILE, 200_000,
                                      16_000, 0.05)
    m_cap = 50 * sort.TILE
    runs = [sort_cuda.mark(pk, npt, key0, ctot, nvk, m_cap)
            for _ in range(2)]
    assert bool(sort.fast_path(runs[0].info, m_cap))
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    plan = sort.merge_plan(runs[0])
    one, two = (sort_cuda.assemble(pk, npt, key0, ctot, runs[0], plan, nvk,
                                   m_cap)
                for _ in range(2))
    assert cs._bitwise_equal(one.pk, two.pk)
    assert all(torch.equal(a, b) for a, b in zip(one[1:], two[1:]))
    assert int(one.anomaly) == 0


def test_assembly_follows_the_decision_in_device_memory(device):
    """The tables and assembly kernels take the mover count and the
    decision from the marks' info words on the card, and write one output
    buffer set each only where the decision is their own: on a fast
    block the merge, bitwise the plain assembly's, which the gather mode
    leaves as it is; with info edited on the card to say "no snapshot"
    the full sort's gather, bitwise the plain gather's, which the merge
    leaves as it is; and the mark kernel's epoch moves on across launches
    (three marks in a row give equal outputs)."""
    pk, npt, key0, ctot, nvk = _block(device, 3, 3 * sort.TILE + 100,
                                      12000, 700, 0.05)
    m_cap = 12388
    marks = [sort_cuda.mark(pk, npt, key0, ctot, nvk, m_cap)
             for _ in range(3)]
    assert all(torch.equal(a, b) for m in marks[1:]
               for a, b in zip(marks[0], m))
    plan, full = sort.merge_plan(marks[0]), sort.full_order(pk, npt, nvk)
    slow = marks[0]._replace(info=marks[0].info.clone())
    slow.info[2] = 0
    for m, fast in ((marks[0], True), (slow, False)):
        assert bool(sort.fast_path(m.info, m_cap)) is fast
        outs = []
        for asm, gat in ((sort_cuda.assemble, sort_cuda.gather),
                         (sort.assemble, sort.gather)):
            out = sort.block_buffers(pk, key0)
            for o in out:
                o.fill_(7)
            a = asm(pk, npt, key0, ctot, m, plan, nvk, m_cap, out)
            g = gat(pk, npt, full, nvk, m.info, m_cap, out)
            assert int(a.anomaly) == int(g[2]) == 0
            outs.append(out)
        (k_rows, k_key0), (p_rows, p_key0) = outs
        assert cs._bitwise_equal(k_rows, p_rows)
        assert torch.equal(k_key0, p_key0)
        want = (sort.assemble(pk, npt, key0, ctot, m, plan, nvk, m_cap).pk
                if fast else sort.full_gather(pk, npt, full, nvk)[0])
        assert cs._bitwise_equal(k_rows, want)


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


def _path_b32(device, **deck):
    from vpic_tpu_torch.decks import bench_deck
    sim = bench_deck.build(nx=32, ny=32, nz=1, npart=65_536, device=device,
                           **deck)
    sim.modify_runparams(merge_sort=True)
    return sim


@pytest.mark.parametrize("every_step", [False, True],
                         ids=["cadence", "every-step"])
def test_path_b_graphed_is_bitwise_eager(device, every_step):
    """Path B on the 32^2 bench deck through its CUDA graphs, whose
    fast-or-full decisions are conditional nodes, and op by op from one
    seed, at the deck's cadence and sorting every step: after 16 steps
    the same fields, species, energies, movers and fast and slow sorts,
    a mark launch per sort in both, the tables and the assembly per merge
    kept graphed and per sort op by op; then a checkpoint, 8 steps more
    and a restore, whose state carries no merge carry (key0 = -1, a full
    sort first), and 8 steps again, bitwise equal in both."""
    from vpic_tpu_torch.engine import cond
    kw = dict(resort_interval=1, ion_sort_mult=1) if every_step else {}
    runs, counts = [], []
    for graphed in (True, False):
        sim = _path_b32(device, **kw)
        assert sim.graphed
        advance = sim.advance_steps if graphed else sim.advance_eager
        sort_cuda.reset_launch_counts()
        cond.reset()
        advance(16)
        torch.cuda.synchronize()
        cond.settle()
        runs.append(sim)
        counts.append((sort_cuda.sort_counts(), dict(sort_cuda.launches)))
    g, e = runs
    assert counts[0][0] == counts[1][0]
    for (sorts, launches), graphed in zip(counts, (True, False)):
        assert launches == cs.merge_launches(sorts, graphed)
    # at the cadence more lanes move between two sorts than the mover
    # buffer holds, and every sort falls back
    assert (counts[0][0]["electron"]["fast"] > 0) is every_step
    assert g.dispatch_counts["eager_steps"] == 0
    assert g.checksum_fields() == e.checksum_fields()
    for h in g._species:
        assert g.checksum_species(h["name"]) == e.checksum_species(h["name"])
    assert g.energies() == e.energies()
    assert g.mover_counts() == e.mover_counts() == {"electron": 0, "ion": 0}
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        for sim, advance in ((g, g.advance_steps), (e, e.advance_eager)):
            sim.checkpoint(f"{tmp}/{id(sim)}")
            advance(8)
            sim.restore(f"{tmp}/{id(sim)}")
            advance(8)
    assert g.checksum_fields() == e.checksum_fields()
    for h in g._species:
        assert g.checksum_species(h["name"]) == e.checksum_species(h["name"])


def test_eager_path_b_steps_read_nothing_back(device):
    """After a first step, eager steps of path B at the deck's cadence (a
    super-cycle: every species' sort, then the electrons') and sorting
    every step run under torch.cuda.set_sync_debug_mode("error"): the
    merge re-sort decides on the card."""
    sims = [_path_b32(device), _path_b32(device, resort_interval=1,
                                         ion_sort_mult=1)]
    for sim in sims:
        sim.advance_eager(8)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for sim in sims:
            sim.advance_eager(8)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert [sim.step_count for sim in sims] == [16, 16]
    assert all(sim.mover_counts() == {"electron": 0, "ion": 0}
               for sim in sims)


def _graph_of(device, fn):
    """``fn()`` captured once into a CUDA graph (after a warm-up on a side
    stream), kept so its nodes can be counted: (graph, fn's output)."""
    from vpic_tpu_torch.engine import cond
    cond.prepare(device)
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream(device).wait_stream(side)
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        out = fn()
    graph.instantiate()
    return graph, out


@pytest.mark.parametrize("through", [False, True],
                         ids=["both-made", "true-passes-through"])
def test_an_if_node_graph_replays_the_branch_taken(device, through):
    """engine/cond.cond under a capture: conditional nodes at the graph's
    top level, and each replay gives the branch that the predicate's
    value at that replay names, bitwise, also where the true branch
    passes its operand through (a third node copies it)."""
    from vpic_tpu_torch.engine import cond, graphs
    assert cond.ROUTE == "native"
    x = torch.arange(1000, dtype=torch.float32, device=device)
    p = torch.zeros((), dtype=torch.bool, device=device)
    true_fn = (lambda v: v) if through else (lambda v: v * 2 + 1)
    graph, out = _graph_of(device, lambda: cond.cond(
        p, true_fn, lambda v: v - 3, (x,)))
    kinds = graphs.node_types(graph.raw_cuda_graph())
    assert kinds.get("conditional") == (3 if through else 2), kinds
    for flag in (True, False, True):
        p.fill_(flag)
        graph.replay()
        want = true_fn(x) if flag else x - 3
        assert torch.equal(out, want), flag


def test_nested_if_nodes_replay_the_branch_taken(device):
    """A cond inside a cond's branch nests its nodes: all four pairs of
    predicates replay bitwise the eager select's value."""
    from vpic_tpu_torch.engine import cond
    x = torch.arange(1000, dtype=torch.float32, device=device)
    p = torch.zeros((), dtype=torch.bool, device=device)
    q = torch.zeros((), dtype=torch.bool, device=device)

    def inner(v):
        return cond.cond(q, lambda w: w + 1, lambda w: w * 3, (v,))

    def step():
        return cond.cond(p, inner, lambda v: (v - 7) * 0.5, (x,))

    graph, out = _graph_of(device, step)
    for a in (True, False):
        for b in (True, False):
            p.fill_(a)
            q.fill_(b)
            graph.replay()
            assert torch.equal(out, step()), (a, b)


def test_a_conditional_body_counts_its_launches_per_run(device):
    """A body that counts a launch takes it back from the host count and
    tallies its runs on the card: after three replays, two of them taking
    the branch, cond.settle() adds two launches."""
    from vpic_tpu_torch.engine import cond
    x = torch.ones(16, device=device)
    p = torch.zeros((), dtype=torch.bool, device=device)

    def counted(v):
        push_cuda.launches["walk_only"] += 1
        return v + 1

    graph, out = _graph_of(device, lambda: cond.cond(
        p, counted, lambda v: v, (x,)))
    cond.settle()
    push_cuda.reset_launch_counts()
    cond.reset()
    for flag in (True, False, True):
        p.fill_(flag)
        graph.replay()
    assert push_cuda.launches["walk_only"] == 0
    cond.settle()
    assert push_cuda.launches["walk_only"] == 2


def test_the_entry_graph_replays_bitwise(device):
    """vpic_tpu_torch.entry.entry()'s step captured once and replayed 16
    times is bitwise Simulation.advance(16) of the same deck (its sorts
    and cleans decided on the card from the state's step): one capture,
    16 replays, conditional nodes in the graph."""
    from vpic_tpu_torch.decks import bench_deck
    from vpic_tpu_torch.entry import DECK
    state, counts, nodes = cs.entry_replayed(device, 16)
    assert counts == {"captures": 1, "replays.step": 16,
                      "graphed_steps": 16}
    assert nodes.get("conditional", 0) >= 2, nodes
    sim = bench_deck.build(**DECK, device=device)
    assert cs.states_equal(state, sim.advance(16))


def _shared_conds(device, n, fail=None, who=None):
    """``n`` shards of one card, each calling a cond of every shard on
    ``p`` whose true branch sums over the shards inside its body and
    nests a cond on ``q``; the leaves count a launch each (push, walk_only,
    deposit_sorted).  Returns (p, q, xs, run): ``run(states=xs)`` gives
    every shard's output from its input.  ``fail``: "raise" or "host
    read" in shard ``who``'s (default the last) true body under a
    capture."""
    from vpic_tpu_torch.core.types import Grid
    from vpic_tpu_torch.engine import cond
    from vpic_tpu_torch.engine import distributed as dist
    g = Grid(nx=4, ny=4, nz=4, gpx=n)
    comms = dist.make_comms(g, dist.make_mesh(g, [device]), timeout=30)
    p = torch.zeros((), dtype=torch.bool, device=device)
    q = torch.zeros((), dtype=torch.bool, device=device)
    xs = [torch.arange(1000, dtype=torch.float32, device=device) * (r + 1)
          for r in range(n)]
    who = n - 1 if who is None else who

    def counted(counts, name, v):
        with push_cuda._lock:
            counts[name] += 1
        return v

    def shard(comm, x):
        def true_fn(v):
            v = v * 2 + comm.allsum(v.sum()).to(torch.float32)
            if (fail and comm.rank == who
                    and torch.cuda.is_current_stream_capturing()):
                if fail == "raise":
                    raise KeyError("shard in a body")
                float(v.sum())
            return cond.cond(
                q, lambda w: counted(push_cuda.launches, "push", w + 1),
                lambda w: counted(push_cuda.launches, "walk_only", w * 3),
                (v,), comm=comm)

        def false_fn(v):
            s = comm.allsum(v.sum()).to(torch.float32)
            return counted(deposit_cuda.launches, "deposit_sorted",
                           (v - 7) * 0.5 + s)

        return cond.cond(p, true_fn, false_fn, (x,), comm=comm)

    return p, q, xs, lambda states=xs: dist.run_shards(comms, shard, states)


@pytest.mark.parametrize("n", [2, 4])
def test_a_cond_of_several_shards_replays_the_branch_taken(device, n):
    """Captured once, the cond of every shard is two conditional nodes at
    the graph's top level; each replay gives every shard the output of
    the eager select for that replay's predicates, bitwise, and runs only
    the branch taken on every shard: n launches of its leaf per replay,
    from one tally word per body."""
    from vpic_tpu_torch.engine import cond, graphs
    p, q, _, run = _shared_conds(device, n)
    graph, outs = _graph_of(device, run)
    kinds = graphs.node_types(graph.raw_cuda_graph())
    assert kinds.get("conditional") == 2, kinds
    leaves = {(True, True): "push", (True, False): "walk_only",
              (False, True): "deposit_sorted",
              (False, False): "deposit_sorted"}
    for a in (True, False):
        for b in (True, False):
            p.fill_(a)
            q.fill_(b)
            cond.settle()
            push_cuda.reset_launch_counts()
            deposit_cuda.reset_launch_counts()
            cond.reset()
            graph.replay()
            cond.settle()
            got = dict(push_cuda.launches, **deposit_cuda.launches)
            assert got == {k: (n if k == leaves[(a, b)] else 0)
                           for k in got}, (a, b)
            want = run()
            for r in range(n):
                assert torch.equal(outs[r], want[r]), (a, b, r)


@pytest.mark.parametrize("n,who,how", [
    (4, 3, "raise"), (4, 3, "host read"), (4, 0, "host read"),
    (1, 0, "host read")], ids=["last of 4 raises", "last of 4 reads",
                               "shard 0 of 4 reads", "one shard reads"])
def test_a_shard_failing_inside_a_shared_node(device, n, who, how):
    """Shard ``who`` fails inside the true body of a cond of every shard
    (of the one shard: the plain nodes) while ``engine/graphs.GraphRunner``
    captures (a Python exception, or a read of the card from the host,
    which invalidates the body's capture; shard 0 opened the node): the
    capture raises that shard's exception within seconds and keeps no
    graph (the read counted as an invalidated body, whose graph is never
    destroyed: that crashed the process); the runner's next capture, of
    shards that do not fail, replays bitwise their select."""
    import collections
    import time
    from vpic_tpu_torch.engine import cond, graphs
    invalid = cond.invalid_bodies
    runner = graphs.GraphRunner(device, collections.Counter(), [])
    p, q, xs, run = _shared_conds(device, n, fail=how, who=who)
    runner.load(xs)
    t0 = time.perf_counter()
    with pytest.raises(KeyError if how == "raise" else RuntimeError) as err:
        runner.run("step", ("shared",), 0, 1, lambda st, t, n: run(st))
    assert time.perf_counter() - t0 < 60
    assert "ShardError" not in type(err.value).__name__
    assert not runner.graphs
    assert cond.invalid_bodies - invalid == (how == "host read")
    p, q, xs, run = _shared_conds(device, n)
    p.fill_(True)
    runner.load(xs)
    runner.run("step", ("shared",), 0, 1, lambda st, t, n: run(st))
    assert runner.counts == {"captures": 2, "replays.step": 1,
                             "graphed_steps": 1}
    want = run(xs)
    assert all(torch.equal(a, b) for a, b in zip(runner.static, want))


def test_two_z_shards_cleaning_every_other_step_graphed(device):
    """The 16x16x4 box on two z shards cleaning div E and div B and
    syncing every other step: 12 steps through advance are one capture,
    its cleans conditional nodes at the graph's top level, bitwise 12
    steps op by op on every shard, with equal kernel launches."""
    from vpic_tpu_torch.engine import cond
    from tests.torch_decks import hooked_shards

    def box():
        sim = hooked_shards(device, px=1, py=1, pz=2, nz=4)
        sim.modify_runparams(clean_div_e_interval=2, clean_div_b_interval=2,
                             sync_shared_interval=2)
        return sim

    g, e = box(), box()
    assert g.graphed
    cond.settle()
    push_cuda.reset_launch_counts()
    cond.reset()
    g.advance(12)
    cond.settle()
    graphed = dict(push_cuda.launches)
    push_cuda.reset_launch_counts()
    e.advance_eager(12)
    assert graphed == push_cuda.launches
    _same_shards(g, e)
    assert g.mover_counts() == e.mover_counts() == {"electron": 0}
    assert g.dispatch_counts == {"captures": 1, "replays.step": 12,
                                 "graphed_steps": 12}
    kinds = g.capture_times[0]["node_types"]
    assert kinds.get("conditional", 0) >= 6, kinds
    assert g.comms[0].rv.slots == [None] * 2 and not g.comms[0].rv.shared


def _cleaning_box(device, on=True):
    """The 16x16 box of warm electrons cleaning div E and div B and syncing
    its shared faces every 3 steps, with the device-clock spans on or
    off."""
    from tests.torch_decks import hooked_shards
    sim = hooked_shards(device, px=1, py=1)
    sim.modify_runparams(clean_div_e_interval=3, clean_div_b_interval=3,
                         sync_shared_interval=3, spans=on)
    return sim


def test_replays_stamp_inside_conditional_bodies_on_clean_steps(device):
    """Seven steps of the box through one capture: every replay stamps its
    step's parts in order inside its graphs.unit, and the clean spans,
    stamped inside the conditional bodies, come on steps 0, 3 and 6
    only."""
    from vpic_tpu_torch.engine import spans
    from vpic_tpu_torch.engine.step import CLEANS
    sim = _cleaning_box(device)
    sim.advance(7)
    assert sim.dispatch_counts["captures"] == 1
    rec = spans.records()
    assert rec.dropped == 0
    g = [s for s in rec.spans if s.graphed]
    units = [s for s in g if s.name == "graphs.unit"]
    assert [u.step for u in units] == list(range(7))
    for u in units:
        mine = [s for s in g if s.step == u.step
                and s.name.startswith(("step.", "graphs.write_back"))]
        assert [s.name for s in mine if s.name not in CLEANS] == [
            "step.sort", "step.push", "step.field", "graphs.write_back"]
        assert all(u.t0_ns <= s.t0_ns < s.t1_ns <= u.t1_ns for s in mine)
    for name in CLEANS:
        assert [s.step for s in g if s.name == name] == [0, 3, 6], name


def test_align_places_a_profiled_graphed_window(device):
    """A torch.profiler trace of six replays between two cleans (the box
    cleaning every 8 steps; a trace places the kernels after a
    conditional body off, so align is for windows between cleans): its
    stamp kernels, 10 a step (two for each of the unit, the write-back,
    the sort, the push and the field), pair with their stamps, every
    residual within 5 us (the jumps of the profiler's clock aside)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from vpic_tpu_torch.engine import spans
    sim = _cleaning_box(device)
    sim.modify_runparams(clean_div_e_interval=8, clean_div_b_interval=8,
                         sync_shared_interval=8)
    sim.advance_steps(1)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        sim.advance_steps(6)
        torch.cuda.synchronize()
    kernels = [(e.name, e.time_range.start, e.time_range.end)
               for e in prof.events() if e.device_type == DeviceType.CUDA]
    # a trace may drop a kernel's record, and show the clean's stamps of
    # step 0 before the window (their stamps lie outside its steps)
    shown = sum("stamp_kernel" in k[0] for k in kernels)
    got = spans.align(kernels, steps=(1, 6))
    assert got.pairs == min(shown, 6 * 10) >= 5 * 10, (shown, got)
    assert got.residual_us <= 5.0, got


def test_spans_add_their_stamp_nodes(device):
    """A one-step unit of the box captured with the spans on holds 10
    kernel nodes more than with them off (two stamps for each of the
    unit, the write-back, the sort, the push and the field; the clean
    spans' lie in conditional bodies), the same conditional nodes, and
    steps bitwise alike."""
    on, off = _cleaning_box(device), _cleaning_box(device, on=False)
    on.advance(4)
    off.advance(4)
    a, b = (s.capture_times[0]["node_types"] for s in (on, off))
    assert a["kernel"] - b["kernel"] == 10, (a, b)
    assert a.get("conditional") == b.get("conditional") >= 6, (a, b)
    _same_shards(on, off)
