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
re-sort assembly: every output row bitwise equal, key0/ctot equal, no
anomaly.  Needs an NVIDIA GPU and nvcc; skipped elsewhere.  On the card
(tests/conftest.py imports JAX, which a GPU machine need not have):

    python -m pytest tests/test_torch_cuda.py -q --noconftest
"""

import pytest
import torch

import chip_smoke as cs

from vpic_tpu_torch.particles import (deposit, deposit_cuda, push, push_cuda,
                                      sort_cuda)

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
    before = sort_cuda.launches["merge_assemble"]
    cs.run_merge_case(name, device)
    assert (sort_cuda.launches["merge_assemble"] - before
            == sum(cs.MERGE_EXPECT_FAST[name]))


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
