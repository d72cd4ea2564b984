"""The CUDA push+walk kernel against its plain PyTorch version on the card,
with the checks of chip_smoke.py: voxels, pcode and particle floats bitwise
equal, the accumulator within 1e-6 * sum|contributions| per voxel, and two
runs of the kernel bitwise equal.  Needs an NVIDIA GPU and nvcc; skipped
elsewhere.  On the card (tests/conftest.py imports JAX, which a GPU
machine need not have):

    python -m pytest tests/test_torch_cuda.py -q --noconftest
"""

import pytest
import torch

import chip_smoke as cs

from vpic_tpu_torch.particles import push_cuda

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
    assert push_cuda.launches["push"] == before + 1


@pytest.mark.parametrize("hot", [False, True], ids=["cold", "hot"])
@pytest.mark.parametrize("pbc_name", list(cs.SMALL_FACES))
def test_walk_only_kernel_matches_plain(device, pbc_name, hot):
    g, nb, interp, sp = cs.small_grid_case(pbc_name, hot, device)
    st = cs.walk_state_from(sp, 5, 1.5 if hot else 0.3)
    cs.check_walk(f"{pbc_name} hot={hot}", st, nb, g, 2)


def test_kernel_is_deterministic(device):
    g, nb, interp, sp = cs.small_grid_case("periodic", True, device)
    acc0 = torch.zeros((g.nv, 12), dtype=torch.float32, device=device)
    a, acc_a = push_cuda.advance_p(sp, interp, acc0, nb, g, n_walk=4)
    b, acc_b = push_cuda.advance_p(sp, interp, acc0, nb, g, n_walk=4)
    assert torch.equal(acc_a, acc_b)
    for name in cs.PUSH_FLOATS + ("i", "pc", "nm"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name
