"""The plain fixed-point deposit (vpic_tpu_torch.particles.deposit:
fixed_scale, deposit_fixed, unfix; push.advance_p_fixed and
streak_walk_fixed), the twin that the push kernel's accumulator equals
bit for bit on the card (tests/test_torch_cuda.py, chip_smoke.py).

On the CPU: the twin does not depend on lane order (bit for bit); it
agrees with the float deposit to 1e-6 * sum|c| per word (one rounding to
2^-S per contribution, S about 40 here, and one float32 rounding of the
sum); on the cases of tests/test_torch_push.py it agrees with the JAX
package's XLA-path accumulator to that file's bound (rtol 1e-5, atol
1e-6), with the particle state equal to the plain float push's; and its
scale keeps every voxel's sum below 2^62 without wasting a bit.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vpic_tpu.particles import push as jpush

from vpic_tpu_torch.particles import deposit, push

from .test_torch_push import ACC, MAX_NP, PBCS, both_species, case, \
    particles

from tests import torch_decks  # noqa: F401  (one torch thread)

# (n, nv, sorted) as in tests/test_torch_deposit.py
DEPOSIT_CASES = [(5000, 2000, True), (1024, 130 * 130, True),
                 (4096, 3000, False)]
DEPOSIT_IDS = ["sorted-5000", "sorted-1024", "unsorted-4096"]


def deposit_inputs(n, nv, is_sorted, seed=1):
    rng = np.random.default_rng(seed)
    vox = rng.integers(1, nv - 5, n)
    vox = (np.sort(vox) if is_sorted else vox).astype(np.int32)
    cols = rng.normal(size=(12, n)).astype(np.float32)
    valid = rng.random(n) < 0.9
    q = rng.uniform(0.5, 1.5, n).astype(np.float32)
    return (torch.as_tensor(vox), tuple(torch.as_tensor(c) for c in cols),
            torch.as_tensor(valid), torch.as_tensor(q))


def fixed_sum(vox, cols, valid, nv, scale):
    fix = torch.zeros((nv, 12), dtype=torch.int64)
    fix, dropped = deposit.deposit_fixed(scale)(fix, vox, cols, valid, nv)
    assert int(dropped) == 0
    return fix


@pytest.mark.parametrize("n,nv,is_sorted", DEPOSIT_CASES, ids=DEPOSIT_IDS)
def test_fixed_deposit_ignores_lane_order(n, nv, is_sorted):
    vox, cols, valid, q = deposit_inputs(n, nv, is_sorted)
    scale = deposit.fixed_scale(q, 13, n)
    ref = fixed_sum(vox, cols, valid, nv, scale)
    for seed in range(3):
        perm = torch.as_tensor(np.random.default_rng(seed).permutation(n))
        out = fixed_sum(vox[perm], tuple(c[perm] for c in cols),
                        valid[perm], nv, scale)
        assert torch.equal(out, ref)
    acc0 = torch.zeros((nv, 12))
    assert torch.equal(deposit.unfix(acc0, ref, scale),
                       deposit.unfix(acc0, out, scale))


@pytest.mark.parametrize("n,nv,is_sorted", DEPOSIT_CASES, ids=DEPOSIT_IDS)
def test_fixed_deposit_matches_the_float_deposit(n, nv, is_sorted):
    vox, cols, valid, q = deposit_inputs(n, nv, is_sorted)
    acc0 = torch.as_tensor(np.random.default_rng(4).normal(
        size=(nv, 12)).astype(np.float32))
    scale = deposit.fixed_scale(q, 13, n)
    fixed = deposit.unfix(acc0, fixed_sum(vox, cols, valid, nv, scale),
                          scale)
    flt, _ = deposit.deposit_sorted_into(acc0, vox, cols, valid, nv)
    absacc = torch.zeros((nv, 12), dtype=torch.float64)
    c = torch.stack(cols, dim=-1).abs().to(torch.float64)
    absacc.index_add_(0, vox[valid].long(), c[valid])
    err = (fixed.double() - flt.double()).abs()
    # the float32 rounding of acc0 + the sum is shared by both sides up to
    # one ulp of |acc0| + sum|c|
    limit = 1e-6 * (absacc + acc0.double().abs()) + 1e-30
    assert bool((err <= limit).all()), float((err / limit).max())


@pytest.mark.parametrize("hot", [False, True], ids=["cold", "hot"])
@pytest.mark.parametrize("pbc_name", list(PBCS))
def test_advance_p_fixed_matches_jax(pbc_name, hot):
    jg, g, rng, interp, nb = case(pbc_name, hot)
    jsp, tsp = both_species(particles(g, rng, hot))
    _, jacc = jax.jit(lambda sp: jpush.advance_p(
        sp, jnp.asarray(interp), jnp.zeros((g.nv, 12), jnp.float32),
        jnp.asarray(nb), jg, n_walk=4, max_nm=MAX_NP))(jsp)
    args = (tsp, torch.as_tensor(interp), torch.zeros((g.nv, 12)),
            torch.as_tensor(nb), g)
    fout, facc = push.advance_p_fixed(*args, n_walk=4)
    pout, _ = push.advance_p(*args, n_walk=4)
    for name in ("dx", "dy", "dz", "ux", "uy", "uz", "mdx", "mdy", "mdz",
                 "i", "pc", "nm"):
        assert torch.equal(getattr(fout, name), getattr(pout, name)), name
    np.testing.assert_allclose(facc.numpy(), np.asarray(jacc), **ACC)


@pytest.mark.parametrize("hot", [False, True], ids=["cold", "hot"])
@pytest.mark.parametrize("pbc_name", list(PBCS))
def test_streak_walk_fixed_matches_jax(pbc_name, hot):
    jg, g, rng, interp, nb = case(pbc_name, hot)
    cols = particles(g, rng, hot)
    scale = 1.5 if hot else 0.3
    rem = {k: rng.uniform(-scale, scale, MAX_NP).astype(np.float32)
           for k in ("rx", "ry", "rz")}
    active = (np.arange(MAX_NP) < 300) & (rng.random(MAX_NP) < 0.5)
    names = dict(x="dx", y="dy", z="dz", vox="i", ux="ux", uy="uy", uz="uz",
                 q="q")
    pcode = np.zeros(MAX_NP, np.int32)
    jst = jpush.WalkState(**{k: jnp.asarray(cols[v])
                             for k, v in names.items()},
                          **{k: jnp.asarray(v) for k, v in rem.items()},
                          pcode=jnp.asarray(pcode), active=jnp.asarray(active))
    tst = push.WalkState(**{k: torch.as_tensor(cols[v])
                            for k, v in names.items()},
                         **{k: torch.as_tensor(v) for k, v in rem.items()},
                         pcode=torch.as_tensor(pcode),
                         active=torch.as_tensor(active))
    _, jacc = jax.jit(lambda st: jpush.streak_walk(
        st, jnp.zeros((g.nv, 12), jnp.float32), jnp.asarray(nb), jg, 2))(jst)
    acc0 = torch.zeros((g.nv, 12))
    fout, facc = push.streak_walk_fixed(tst, acc0, torch.as_tensor(nb), g, 2)
    pout, _ = push.streak_walk(tst, acc0, torch.as_tensor(nb), g, 2)
    for a, b, name in zip(fout, pout, push.WalkState._fields):
        assert torch.equal(a, b), name
    np.testing.assert_allclose(facc.numpy(), np.asarray(jacc), **ACC)


@pytest.mark.parametrize("qmax,seg_cap,n", [
    (1.0 / 2_000_000, 13, 2_125_824),   # the bench deck's electrons
    (1.4999, 21, 4096), (0.7, 8, 300), (3.0e-9, 13, 100_000_000)])
def test_fixed_scale_fills_62_bits(qmax, seg_cap, n):
    """5 max|q| seg_cap n 2^S < 2^62 <= 2 * 5 max|q| seg_cap n 2^S."""
    q = torch.tensor([0.25 * qmax, -qmax, 0.0], dtype=torch.float32)
    s = deposit.fixed_scale(q, seg_cap, n)
    assert s.dtype == torch.float64 and s.shape == ()
    bound = 5.0 * float(q.abs().max()) * seg_cap * n * float(s)
    assert bound < 2.0 ** 62 <= 2.0 * bound
