"""The probe kernels' plain versions (``vpic_tpu_torch/tools/``) against
the JAX tools they replace, on the CPU.

- The five probes of ``tools/probe_batched.py``, each built as the tool
  builds it and run under ``pltpu.force_tpu_interpret_mode()``, against
  the port's plain version on the port's copy of the tool's inputs:
  bitwise.
- The plain gather3d and deposit2d on random, not one-hot, operands at
  the tool's shapes and at a second shape, against a float64 contraction
  of the bf16-rounded operands: within K * 2^-24 * sum|terms| per output,
  K the contraction depth (the worst case of a float32 sum in any order).
- The plan of the tensor-core kernels (``vpic_tpu_torch/tools/
  mma_plan.py``) at the tool's, the second and a ragged shape: at least
  128 blocks and clusters of at most 8 at the tool's shapes, each (row,
  column, depth) term in exactly one block, every bulk copy on 16-byte
  boundaries, copies and cleared runs filling exactly what the products
  read, shared memory within 227 KB, the launcher's integers carrying
  the column tile and each rank's share; an emulation of the kernels
  from the plan (per-split float32 partials summed in rank order)
  bitwise the plain version at the tool's one-hot inputs and within the
  float32 sum bound on random operands; the wrappers' refusal of shapes
  outside the plan.  These check the plan, the Python model of the
  kernels' copies and sums; the kernels' own copy code in
  ``csrc/probes.cu`` is checked against the plain versions on the card
  (``tests/test_torch_cuda.py``: test_probe_contraction_on_random_operands
  at the tool's and the ragged shapes), and its launcher refuses a plan
  whose tile, cluster or share differ from its constants.
- The elementwise chain of ``tools/vpu_layout_probe.py`` at 1 and 16
  reps (``REPS_IN_KERNEL`` set on the tool's module), rows 1, 3 and 8 of
  a (max(rows, 8), 256) block drawn uniform on [0, 3).
- The launch plans of the chain, io4d, stack8 and onehot3d kernels
  (``vpu_layout_probe.chain_plan``, ``probe_batched.io4d_plan``,
  ``stack8_plan``, ``onehot3d_plan``) at the tools' shapes and the card's
  ragged and offset cases: a model of each kernel's writes from its plan
  writes every output float once, bitwise the plain version, with
  16-byte accesses (and stack8's bulk copy of a row) only on 16-byte
  boundaries; stack8 and onehot3d take the same plan on every device and
  refuse 2^31 elements on every device.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

import chip_smoke
import tools.probe_batched as jax_probes
import tools.vpu_layout_probe as jax_vpu
from vpic_tpu_torch.tools import mma_plan
from vpic_tpu_torch.tools import probe_batched as pb
from vpic_tpu_torch.tools import vpu_layout_probe as vp

from tests import torch_decks  # noqa: F401  (one torch thread)


def bits(a):
    return np.asarray(a, np.float32).view(np.int32)


@pytest.mark.parametrize("name", list(pb.PROBES))
def test_probe_matches_the_jax_tool_bitwise(name):
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jax_probes.PROBES[name]())
    got = pb.PROBES[name](*pb.tool_inputs(name, "cpu")).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_array_equal(bits(got), bits(want))


def test_tool_inputs_are_the_tools():
    """The one-hot window and lane positions as the tool builds them."""
    oh = pb.one_hot_window("cpu").numpy()
    want = (jnp.arange(jax_probes.W)[None, :, None]
            == jnp.arange(jax_probes.LANE)[None, None, :]
            + jnp.arange(jax_probes.R)[:, None, None]).astype(jnp.float32)
    np.testing.assert_array_equal(oh, np.asarray(want))
    loc = jnp.tile(jnp.arange(jax_probes.LANE, dtype=jnp.int32)[None, :],
                   (jax_probes.R, 1))
    np.testing.assert_array_equal(pb.tool_loc("cpu").numpy(),
                                  np.asarray(loc))


def _bf16_64(t):
    return t.to(torch.bfloat16).to(torch.float64).numpy()


CONTRACTIONS = {
    # name: (a shape, oh shape), the second a smaller, ragged shape
    "gather3d": [((32, 512), (8, 512, 128)), ((5, 48), (3, 48, 32))],
    "deposit2d": [((12, 8, 128), (8, 512, 128)), ((7, 3, 32), (3, 40, 32))],
}


def _float64_contraction(name, a, oh):
    """The exact product of the bf16-rounded operands, the same product
    of their magnitudes (sum|terms| per output) and the depth K."""
    a64, oh64 = _bf16_64(a), _bf16_64(oh)
    eq = "aw,rwl->arl" if name == "gather3d" else "krl,rwl->kw"
    depth = a.shape[1] if name == "gather3d" else a.shape[1] * a.shape[2]
    return (np.einsum(eq, a64, oh64),
            np.einsum(eq, np.abs(a64), np.abs(oh64)), depth)


def _within_the_sum_bound(name, got, a, oh):
    exact, mag, depth = _float64_contraction(name, a, oh)
    assert got.shape == exact.shape
    err = np.abs(got.astype(np.float64) - exact)
    assert (err <= depth * 2.0 ** -24 * mag).all(), float(
        (err / (mag * 2.0 ** -24)).max())
    assert err.max() > 0        # the operands are not one-hot


def _random_operands(name, case):
    a_shape, oh_shape = CONTRACTIONS[name][case]
    rng = np.random.default_rng(10 + case)
    return (torch.as_tensor(rng.normal(size=a_shape).astype(np.float32)),
            torch.as_tensor(rng.normal(size=oh_shape).astype(np.float32)))


@pytest.mark.parametrize("case", [0, 1], ids=["tool-shape", "second-shape"])
@pytest.mark.parametrize("name", list(CONTRACTIONS))
def test_contraction_within_the_float32_sum_bound(name, case):
    a, oh = _random_operands(name, case)
    _within_the_sum_bound(name, pb.PROBES[name](a, oh).numpy(), a, oh)


# -- the plan of the tensor-core kernels (vpic_tpu_torch/tools/mma_plan.py) --

# the tools' shapes, the second shapes above and a third, ragged in every
# dimension: 20 rows (two 16-row tiles), a short last split and column tile
PLAN_SHAPES = {
    "gather3d": CONTRACTIONS["gather3d"] + [((20, 200), (2, 200, 100))],
    "deposit2d": CONTRACTIONS["deposit2d"] + [((20, 5, 48), (5, 70, 48))],
}
PLAN_IDS = ["tool-shape", "second-shape", "ragged"]


def plan_of(name, a_shape, oh_shape):
    r, w, lane = oh_shape
    if name == "gather3d":
        return mma_plan.gather3d_plan(a_shape[0], r, w, lane)
    return mma_plan.deposit2d_plan(a_shape[0], r, w, lane)


def plan_cases():
    return [pytest.param(name, case, id=f"{name}-{PLAN_IDS[case]}")
            for name in PLAN_SHAPES for case in range(3)]


@pytest.mark.parametrize("name", list(PLAN_SHAPES))
def test_mma_plan_fills_the_card_at_the_tools_shapes(name):
    """128 blocks or more for 132 SMs, clusters of at most 8 (the portable
    size), and shared memory within the 227 KB a block may use."""
    plan = plan_of(name, *PLAN_SHAPES[name][0])
    assert plan.blocks_total >= 128
    assert plan.splits == 8 and plan.grid[2] <= mma_plan.MAX_CLUSTER
    assert plan.smem <= mma_plan.SMEM_LIMIT


@pytest.mark.parametrize("name,case", plan_cases())
def test_mma_plan_covers_each_output_and_depth_once(name, case):
    """Over all blocks, each (row, column, depth) term of C = A B lies in
    exactly one block's rows, columns and split."""
    plan = plan_of(name, *PLAN_SHAPES[name][case])
    ncols = plan.r * plan.lane if name == "gather3d" else plan.w
    depth = plan.w if name == "gather3d" else plan.r * plan.lane
    count = np.zeros((plan.m, ncols, depth), np.uint8)
    for b in plan.blocks():
        assert plan.splits <= mma_plan.MAX_CLUSTER
        count[np.ix_(np.asarray(b.rows), b.cols[b.cols >= 0], b.depth)] += 1
    assert (count == 1).all()


@pytest.mark.parametrize("name,case", plan_cases())
def test_mma_plan_copies_are_aligned_and_fill_what_the_products_read(
        name, case):
    """Every bulk copy starts and ends on 16-byte boundaries of its
    operand and of shared memory; copies and cleared runs do not overlap
    and write exactly the slab elements that the products read; the
    bytes a block expects fit the mbarrier's count."""
    plan = plan_of(name, *PLAN_SHAPES[name][case])
    assert plan.smem <= mma_plan.SMEM_LIMIT
    read = np.zeros(plan.smem // 4, bool)
    rows = plan.mt * 16
    a0, b0 = plan.a_off // 4, plan.b_off // 4
    read[a0:a0 + rows * plan.lda].reshape(rows, plan.lda)[:, :plan.depth] = 1
    b_rows, b_cols = ((plan.depth, plan.bn) if name == "gather3d"
                      else (plan.bn, plan.depth))
    read[b0:b0 + b_rows * plan.ldb].reshape(b_rows, plan.ldb)[:, :b_cols] = 1
    for b in plan.blocks():
        written = np.zeros(plan.smem // 4, np.int32)
        for _, first, n, dst in b.copies:
            assert (first * 4) % 16 == 0 and (n * 4) % 16 == 0
            assert dst % 16 == 0 and n > 0
            written[dst // 4:dst // 4 + n] += 1
        for dst, nbytes in b.zeros:
            written[dst // 4:(dst + nbytes) // 4] += 1
        np.testing.assert_array_equal(written, read.astype(np.int32))
        assert sum(n for _, _, n, _ in b.copies) * 4 < 2 ** 20


@pytest.mark.parametrize("name,case", plan_cases())
def test_mma_plan_args_carry_the_tile_and_each_ranks_share(name, case):
    """The launcher's integers are the grid, the column tile, the tiling,
    the layout, the share and the shared memory; the ranks' shares are
    contiguous, in rank order, and cover the tile once."""
    plan = plan_of(name, *PLAN_SHAPES[name][case])
    assert plan.args() == (*plan.grid, mma_plan.BN[name], plan.mt,
                           plan.depth, plan.lda, plan.ldb, plan.a_off,
                           plan.b_off, plan.p_off, plan.chunk, plan.smem)
    assert plan.mt == -(-plan.m // 16) and plan.depth % 16 == 0
    covered = [e for q in range(plan.splits) for e in plan.share(q)]
    assert covered == list(range(plan.tile))


def emulate(plan, a, oh):
    """The kernels' arithmetic on the CPU, from the plan alone (a model
    of the kernels, not their code): each
    block's shared memory starts as NaN and takes the plan's copies and
    cleared runs; its partial is the float32 product of the bf16-rounded
    slabs (the tensor cores' order within a split is not emulated); each
    block then writes its share of the tile summed over the cluster's
    partials in rank order.  Returns C and how often each element was
    written."""
    gather = plan.kind == "gather3d"
    src = {"a": a.reshape(-1), "oh": oh.reshape(-1)}
    ncols = plan.r * plan.lane if gather else plan.w
    out = torch.full((plan.m * ncols,), float("nan"))
    writes = torch.zeros(plan.m * ncols, dtype=torch.int64)
    rows, bn, depth = plan.mt * 16, plan.bn, plan.depth
    blocks, partial = list(plan.blocks()), {}
    for b in blocks:
        smem = torch.full((plan.smem // 4,), float("nan"))
        for op, first, n, dst in b.copies:
            smem[dst // 4:dst // 4 + n] = src[op][first:first + n]
        for dst, nbytes in b.zeros:
            smem[dst // 4:(dst + nbytes) // 4] = 0.0
        a0, b0 = plan.a_off // 4, plan.b_off // 4
        sa = smem[a0:a0 + rows * plan.lda].view(rows, plan.lda)[:, :depth]
        if gather:
            sb = smem[b0:b0 + depth * plan.ldb].view(depth, plan.ldb)[:, :bn]
        else:
            sb = smem[b0:b0 + bn * plan.ldb].view(bn, plan.ldb)[:, :depth].T
        partial[b.index] = (pb._bf16(sa) @ pb._bf16(sb)).reshape(-1)
    for b in blocks:
        x, y, _ = b.index
        e = torch.arange(b.share.start, b.share.stop)
        s = partial[(x, y, 0)][e]
        for q in range(1, plan.splits):
            s = s + partial[(x, y, q)][e]
        i, cols = e // bn, torch.as_tensor(b.cols)[e % bn]
        keep = (i < plan.m) & (cols >= 0)
        flat = i[keep] * ncols + cols[keep]
        out[flat] = s[keep]
        writes[flat] += 1
    shape = (plan.m, plan.r, plan.lane) if gather else (plan.m, plan.w)
    return out.view(shape), writes


@pytest.mark.parametrize("name", list(PLAN_SHAPES))
def test_split_sum_is_bitwise_the_plain_version_at_the_tools_inputs(name):
    """At the tools' one-hot operands each split's partial holds at most
    one term per output, and the rank-order sum of the splits is exact:
    bitwise the plain version, every output written once."""
    args = pb.tool_inputs(name, "cpu")
    plan = plan_of(name, *(t.shape for t in args))
    got, writes = emulate(plan, *args)
    assert bool((writes == 1).all())
    np.testing.assert_array_equal(bits(got.numpy()),
                                  bits(pb.PLAIN[name](*args).numpy()))


@pytest.mark.parametrize("name,case", plan_cases())
def test_split_sum_within_the_float32_sum_bound(name, case):
    """On random operands the per-split partials summed in rank order lie
    within K * 2^-24 * sum|terms| of the exact product, K the depth."""
    a_shape, oh_shape = PLAN_SHAPES[name][case]
    rng = np.random.default_rng(20 + case)
    a, oh = (torch.as_tensor(rng.normal(size=s).astype(np.float32))
             for s in (a_shape, oh_shape))
    got, writes = emulate(plan_of(name, a_shape, oh_shape), a, oh)
    assert bool((writes == 1).all())
    _within_the_sum_bound(name, got.numpy(), a, oh)


REFUSED = [
    ("gather3d", (33, 512), (8, 512, 128), "rows of output"),
    ("gather3d", (32, 510), (8, 510, 128), "multiples of 4"),
    ("gather3d", (32, 512), (8, 512, 126), "multiples of 4"),
    ("gather3d", (32, 8192), (1, 8192, 128), "shared memory"),
    ("deposit2d", (40, 8, 128), (8, 512, 128), "rows of output"),
    ("deposit2d", (12, 9, 128), (9, 512, 128), "r <= 8"),
    ("deposit2d", (12, 8, 120), (8, 512, 120), "multiple of 16"),
    ("deposit2d", (32, 8, 1024), (8, 64, 1024), "shared memory"),
]


@pytest.mark.parametrize("name,a_shape,oh_shape,why", REFUSED,
                         ids=[f"{c[0]}-{c[3]}" for c in REFUSED])
def test_wrappers_refuse_shapes_the_kernels_do_not_take(name, a_shape,
                                                        oh_shape, why):
    """A shape outside the kernels' plan raises ValueError on every
    device, before anything is built; the plain version is not taken."""
    a, oh = torch.zeros(a_shape), torch.zeros(oh_shape)
    with pytest.raises(ValueError, match=why):
        pb.PROBES[name](a, oh)


def test_stack8_masks_lanes_outside_the_window():
    win = torch.as_tensor(np.random.default_rng(3).normal(
        size=(4, 16)).astype(np.float32))
    loc = torch.tensor([[0, 15, 16, -1], [3, 3, 7, 100]], dtype=torch.int32)
    out = pb.stack8(win, loc).numpy()
    want = np.zeros((4, 2, 4), np.float32)
    for s in range(2):
        for l in range(4):
            w = int(loc[s, l])
            if 0 <= w < 16:
                want[:, s, l] = win[:, w].to(torch.bfloat16).float().numpy()
    np.testing.assert_array_equal(bits(out), bits(want))


C, ONE, TWO = np.float32(1.0000001), np.float32(1.0), np.float32(2.0)


def numpy_chain(a, reps):
    """IEEE float32, each operation rounded on its own."""
    for _ in range(reps):
        a = a * C
        a = a + ONE
        a = np.where(a > TWO, a - ONE, a)
    return a


def numpy_xla_chain(a, reps):
    """XLA's rewrite on the CPU: the taken branch is fl(a*c), not
    fl(fl(a*c) + 1) - 1."""
    for _ in range(reps):
        p = a * C
        t = p + ONE
        a = np.where(t > TWO, p, t)
    return a


def jax_chain(x, rows):
    """The tool's pallas_call (tools/vpu_layout_probe.py:36-42), built and
    run inside the interpret-mode context."""
    n = x.shape[1]
    with pltpu.force_tpu_interpret_mode():
        f = pl.pallas_call(
            functools.partial(jax_vpu._kernel, rows=rows, n=n),
            out_shape=jax.ShapeDtypeStruct(x.shape, jnp.float32),
            in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)],
            out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        )
        return np.asarray(jax.jit(f)(jnp.asarray(x)))


@pytest.mark.parametrize("rows", [1, 3, 8])
@pytest.mark.parametrize("reps", [1, 16])
def test_vpu_chain_against_the_jax_tool(monkeypatch, reps, rows):
    """The port's plain chain is bitwise the IEEE float32 chain done step
    by step, its rows past ``rows`` zeros; the JAX kernel is bitwise XLA's
    rewrite of it (the taken branch fl(a*c)), so the two differ.  Rows
    ``rows..7`` of the JAX output are never written and are not compared.
    Port against JAX: within reps * 2^-23, the largest difference measured
    (1.19e-7 at 1 rep, 1.91e-6 at 16 reps, on these inputs): one float32
    ulp of [1, 2) per rep where the rewrite skips a rounding."""
    monkeypatch.setattr(jax_vpu, "REPS_IN_KERNEL", reps)
    n = 256
    x = np.random.default_rng(rows).uniform(
        0, 3, size=(max(rows, 8), n)).astype(np.float32)
    port = vp.chain(torch.from_numpy(x), rows, reps).numpy()
    assert port.shape == x.shape
    np.testing.assert_array_equal(bits(port[:rows]),
                                  bits(numpy_chain(x[:rows], reps)))
    assert not port[rows:].any()
    got = jax_chain(x, rows)[:rows]
    np.testing.assert_array_equal(bits(got),
                                  bits(numpy_xla_chain(x[:rows], reps)))
    np.testing.assert_allclose(port[:rows], got, rtol=0,
                               atol=reps * 2.0 ** -23)



@pytest.mark.parametrize("name", list(pb.PROBES) + ["vpu_chain"])
def test_wrappers_refuse_tensors_off_cpu_and_card(name, monkeypatch):
    """A tensor on neither the CPU nor a card is refused before anything
    is built; the plain version is never taken for it."""
    from vpic_tpu_torch.particles import push_cuda

    def no_build():
        raise AssertionError("nothing may be built for a refused tensor")

    monkeypatch.setattr(push_cuda, "build", no_build)
    if name == "vpu_chain":
        call = lambda: vp.chain(torch.empty((8, 128), device="meta"), 1)
    else:
        args = [a.to("meta") for a in pb.tool_inputs(name, "cpu")]
        call = lambda: pb.PROBES[name](*args)
    with pytest.raises(ValueError, match="CUDA tensors"):
        call()


# -- the launch plans of the chain and io4d kernels --------------------------

# the tool's seven blocks, then chip_smoke's ragged cases (rows, shape)
CHAIN_PLAN_CASES = ([(rows, vp.block_shape(rows)) for rows in vp.ROWS]
                    + list(dict.fromkeys((rows, shape) for rows, shape, _
                                         in chip_smoke.CHAIN_RAGGED)))


def chain_model(x, rows, reps):
    """The chain kernel's writes on the CPU, from its plan alone (a model
    of the kernel, not its code): the output starts as NaN; thread g of
    the grid writes its head float, its float4 g, g + T, ... and its tail
    float of the zeros, then takes floats g and g + pairs of the window
    through the chain.  Returns the output and how often each float was
    written."""
    out_rows, n = x.shape
    plan = vp.chain_plan(rows, n, out_rows)
    flat = x.reshape(-1).numpy()
    out = np.full(flat.size, np.nan, np.float32)
    writes = np.zeros(flat.size, np.int64)
    g = np.arange(plan.blocks * vp.CHAIN_BLOCK)
    first_vec = plan.window + plan.head
    t = np.concatenate([np.arange(k, plan.vec4, g.size) for k in g])
    zeros = [plan.window + g[g < plan.head],
             (first_vec + 4 * t[:, None] + np.arange(4)).reshape(-1),
             first_vec + 4 * plan.vec4 + g[g < plan.tail]]
    for z in zeros:
        out[z] = 0.0
        np.add.at(writes, z, 1)
    g = g[g < plan.pairs]
    i = np.concatenate([g, g + plan.pairs])
    i = i[i < plan.window]
    out[i] = numpy_chain(flat[i], reps)
    np.add.at(writes, i, 1)
    return out.reshape(x.shape), writes


@pytest.mark.parametrize("rows,shape", CHAIN_PLAN_CASES,
                         ids=[f"rows{r}-{s[0]}x{s[1]}"
                              for r, s in CHAIN_PLAN_CASES])
def test_chain_plan_writes_each_float_once(rows, shape):
    """At the tool's blocks and the card's ragged cases the plan writes
    every float of the block exactly once, the chain on the window and
    zeros after it, bitwise the plain version; the float4 stores start
    on 16-byte boundaries, the head and tail are under four floats, and
    the grid has no block to spare (256 at the tool's 2^17-float
    windows)."""
    plan = vp.chain_plan(rows, shape[1], shape[0])
    x = torch.as_tensor(np.random.default_rng(rows).uniform(
        0, 3, size=shape).astype(np.float32))
    got, writes = chain_model(x, rows, 3)
    assert (writes == 1).all()
    np.testing.assert_array_equal(bits(got), bits(vp.chain_plain(x, rows, 3)))
    assert plan.window == rows * shape[1]
    assert plan.pairs == -(-plan.window // 2)
    assert 0 <= plan.head < 4 and 0 <= plan.tail < 4
    assert plan.vec4 == 0 or (plan.window + plan.head) % 4 == 0
    assert plan.blocks == -(-plan.pairs // vp.CHAIN_BLOCK)
    if plan.window == 1 << 17:
        assert plan.blocks == 256


IO4D_PLAN_CASES = {"tool": ((4, 7, pb.R, pb.LANE), True, 4),
                   "ragged": ((3, 7, 5, 6), True, 1),
                   "4 bytes in": ((2, 7, 4, 8), False, 1),
                   "one block": ((1, 7, 1, 4), True, 4)}


def io4d_model(ps, plan):
    """io4d_kernel's writes on the CPU from its plan alone: thread t of
    the grid moves ``width`` floats of one output plane.  Returns the
    output (NaN where nothing was written) and the write counts."""
    b, _, r, lane = ps.shape
    p, w = r * lane, plan.width
    src = ps.reshape(b, 7, p).numpy()
    out = np.full((b, 16, p), np.nan, np.float32)
    writes = np.zeros((b, 16, p), np.int64)
    cols = p // w
    t = np.arange(plan.blocks * pb.IO4D_BLOCK)
    t = t[t < b * 16 * cols]
    col, j, i = t % cols, t // cols % 16, t // cols // 16
    for k in range(w):
        c = col * w + k
        a = src[i, 0, c] * np.float32(2) + src[i, 1, c]
        head = np.where(a > 0, a, src[i, 2, c])
        copy = src[i, np.clip(j - 1, 0, 6), c]
        out[i, j, c] = np.where(j == 0, head,
                                np.where(j <= 7, copy, np.float32(0)))
        np.add.at(writes, (i, j, c), 1)
    return out.reshape(b, 16, r, lane), writes


@pytest.mark.parametrize("name", list(IO4D_PLAN_CASES))
def test_io4d_plan_writes_each_float_once(name):
    """16-byte accesses only where R*L is a multiple of 4 and the
    operands are aligned; the plan writes every output float exactly
    once, bitwise the plain version, with no block to spare (128 blocks
    at the tool's shape)."""
    shape, aligned, width = IO4D_PLAN_CASES[name]
    b, p = shape[0], shape[2] * shape[3]
    plan = pb.io4d_plan(b, p, aligned)
    assert plan.width == width
    assert plan.blocks == -(-b * 16 * p // width // pb.IO4D_BLOCK)
    if name == "tool":
        assert plan.blocks == 128
    ps = torch.as_tensor(np.random.default_rng(4).normal(
        size=shape).astype(np.float32))
    got, writes = io4d_model(ps, plan)
    assert (writes == 1).all()
    np.testing.assert_array_equal(bits(got), bits(pb.io4d_plain(ps)))


# -- the launch plans of stack8 and onehot3d ---------------------------------


def _aligned(nbytes):
    return nbytes % 16 == 0


def stack8_model(win, loc, plan):
    """stack8_kernel's reads and writes on the CPU from its plan alone (a
    model of the kernel, not its code): block b copies row b // chunks of
    win into shared memory or reads win directly; its threads take four
    outputs each of the block's chunk.
    Every 16-byte access and the bulk copy are checked for 16-byte
    boundaries, from the operands' true addresses (out starts on one).
    Returns the output (NaN where nothing was written) and the write
    counts."""
    a, w = win.shape
    s, lane = loc.shape
    sl, per, threads = s * lane, pb.STACK8_PER_BLOCK, pb.STACK8_THREADS
    assert plan.blocks == a * plan.chunks and plan.chunks == -(-sl // per)
    win_np, loc_np = win.numpy(), loc.reshape(-1).numpy()
    bf16 = pb._bf16(win).numpy()
    out = np.full(a * sl, np.nan, np.float32)
    writes = np.zeros(a * sl, np.int64)
    t = np.arange(threads)
    for b in range(plan.blocks):
        row, c = divmod(b, plan.chunks)
        if plan.stage:     # one bulk copy of the whole row
            assert _aligned(win.data_ptr() + 4 * row * w) and _aligned(4 * w)
            assert plan.smem == pb.STACK8_ROW_OFF + 4 * w
            assert plan.smem <= pb.STACK8_SMEM_MAX
        else:
            assert plan.smem == 0
        if plan.width == 4:
            j = (c * per + 4 * t)[:, None] + np.arange(4)
            heads = j[:, 0][j[:, 0] < sl]
            assert all(_aligned(loc.data_ptr() + 4 * h) for h in heads)
            assert all(_aligned(4 * (row * sl + h)) for h in heads)
            j = j[j[:, 0] < sl].reshape(-1)
        else:
            j = (c * per + t[:, None] + threads * np.arange(4)).reshape(-1)
            j = j[j < sl]
        pos = loc_np[j]
        inside = (pos >= 0) & (pos < w)
        out[row * sl + j] = np.where(inside, bf16[row, np.clip(pos, 0, w - 1)],
                                     np.float32(0))
        np.add.at(writes, row * sl + j, 1)
    return out.reshape(a, s, lane), writes


def onehot3d_model(loc, w, plan):
    """onehot3d_kernel's writes on the CPU from its plan alone: thread g
    loads the loc of its column and writes rows phase, phase + phases, ...
    of it.  Its 16-byte accesses are checked for 16-byte boundaries, from
    loc's true address (out starts on one).  Returns the output (NaN
    where nothing was written) and the write counts."""
    r, lane = loc.shape
    width, phases = plan.width, plan.phases
    cols = lane // width
    assert phases == -(-w // pb.ONEHOT3D_ROWS)
    loc_np = loc.reshape(-1).numpy()
    out = np.full(r * w * lane, np.nan, np.float32)
    writes = np.zeros(r * w * lane, np.int64)
    g = np.arange(plan.blocks * pb.ONEHOT3D_BLOCK)
    g = g[g < r * cols * phases]
    c, phase, row = g % cols, g // cols % phases, g // cols // phases
    first = row * lane + c * width           # the column's first l
    if width == 4:
        assert _aligned(loc.data_ptr()) and (first % 4 == 0).all()
    for k in range(pb.ONEHOT3D_ROWS):
        wk = phase + k * phases
        keep = wk < w
        base = (row * w + wk) * lane + c * width
        if width == 4:
            assert (base[keep] % 4 == 0).all()
        for e in range(width):
            dst = base[keep] + e
            out[dst] = (loc_np[first[keep] + e] == wk[keep]).astype(
                np.float32)
            np.add.at(writes, dst, 1)
    return out.reshape(r, w, lane), writes


@pytest.mark.parametrize("name", list(chip_smoke.STACK8_CASES))
def test_stack8_plan_writes_each_float_once(name):
    """At the tool's shape and chip_smoke's ragged and offset cases the
    plan takes the path each case expects (the row staged where it is on
    16 bytes, a multiple of 4 floats and within 48 KB; 16-byte accesses
    where S*L is a multiple of 4 and loc is on 16 bytes) and writes every
    output once, bitwise the plain version, positions outside [0, w)
    giving 0; 128 blocks at the tool's shape."""
    (a, w, s, lane), _, _, want = chip_smoke.STACK8_CASES[name]
    win, loc = chip_smoke.stack8_input(name, "cpu")
    plan = pb.stack8_plan(a, w, s, lane, win.data_ptr() % 16 == 0,
                          loc.data_ptr() % 16 == 0)
    assert (plan.stage, plan.width) == want
    if name == "tool shape":
        assert plan.blocks == 128
    assert ((loc < 0) | (loc >= w)).any()
    got, writes = stack8_model(win, loc, plan)
    assert (writes == 1).all()
    want_out = pb.stack8_plain(win, loc)
    np.testing.assert_array_equal(bits(got), bits(want_out.numpy()))
    np.testing.assert_array_equal(bits(pb.stack8(win, loc).numpy()),
                                  bits(want_out.numpy()))


@pytest.mark.parametrize("name", list(chip_smoke.ONEHOT3D_CASES))
def test_onehot3d_plan_writes_each_float_once(name):
    """16-byte accesses only where lane is a multiple of 4 and loc is on
    16 bytes; the plan writes every output float once, bitwise the plain
    version, with no block to spare (128 at the tool's shape)."""
    (r, w, lane), _, want = chip_smoke.ONEHOT3D_CASES[name]
    loc, w = chip_smoke.onehot3d_input(name, "cpu")
    plan = pb.onehot3d_plan(r, w, lane, loc.data_ptr() % 16 == 0)
    assert plan.width == want
    assert plan.blocks == -(-r * (lane // want) * plan.phases
                            // pb.ONEHOT3D_BLOCK)
    if name == "tool shape":
        assert plan.blocks == 128
    got, writes = onehot3d_model(loc, w, plan)
    assert (writes == 1).all()
    np.testing.assert_array_equal(bits(got),
                                  bits(pb.onehot3d_plain(loc, w).numpy()))


@pytest.mark.parametrize("name", ["stack8", "onehot3d"])
def test_wrapper_takes_its_plan_on_every_device(name, monkeypatch):
    """On the CPU the wrapper computes the plan the card would launch, so
    a lane count that is not a multiple of 4, from 4 bytes into its
    storage, takes the one-float plan on every device, and the result is
    the plain version's."""
    plans = []
    fn = f"{name}_plan"
    real = getattr(pb, fn)
    monkeypatch.setattr(pb, fn, lambda *a: plans.append(real(*a)) or
                        plans[-1])
    flat = torch.arange(1 + 3 * 6, dtype=torch.int32) % 11 - 2
    loc = flat[1:].view(3, 6)
    if name == "onehot3d":
        got, want = pb.onehot3d(loc, 7), pb.onehot3d_plain(loc, 7)
    else:
        win = torch.linspace(-1, 1, 4 * 8).view(4, 8)
        got, want = pb.stack8(win, loc), pb.stack8_plain(win, loc)
    assert len(plans) == 1 and plans[0].width == 1
    np.testing.assert_array_equal(bits(got.numpy()), bits(want.numpy()))


@pytest.mark.parametrize("name", ["stack8", "onehot3d"])
def test_wrappers_refuse_2_31_elements(name):
    """Sizes of 2^31 elements or more are refused on every device before
    anything runs: the kernels index in 32 bits."""
    if name == "onehot3d":
        call = lambda: pb.onehot3d(torch.zeros((1, 4), dtype=torch.int32),
                                   2 ** 29)
    else:
        call = lambda: pb.stack8(torch.zeros((2 ** 11, 1)),
                                 torch.zeros((2 ** 10, 2 ** 10),
                                             dtype=torch.int32))
    with pytest.raises(ValueError, match="2\\^31"):
        call()
