"""The port's packed species and merge re-sort (vpic_tpu_torch.particles.
{push,aux,sort}, the merge's passes reached through the CUDA kernels'
wrappers with CPU tensors) against the JAX package: merge_sort_packed
against vpic_tpu.particles.sort_pallas.merge_sort_packed with its Pallas
kernel in interpret mode, on the seven kernel cases of
tests/test_sort_pallas.py and a multi-tile block; pack/unpack and
sort_p_packed against vpic_tpu.particles.{push,aux}.  The mark pass is
held to numpy cumsums, and its fast-path decision, a device tensor that
the host never reads, to the two-read decision the JAX package's tables
imply and, where the JAX package's window tests pass, to its
``use_fast``.  The merge re-sort and the packed species' sort run with
every host read made to raise.

Both sorts order lanes within a voxel differently (the JAX package's
bitonic is unstable), so blocks are compared in the canonical form of
test_sort_pallas.py (lanes ordered by key and payload), bitwise; the
carried key0 and ctot and the anomaly count must be equal.
"""

import hashlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vpic_tpu.core.types import Grid as JGrid
from vpic_tpu.core.types import SpeciesState as JSpecies
from vpic_tpu.particles import aux as jaux
from vpic_tpu.particles import push as jpush
from vpic_tpu.particles import sort_pallas as sps

from vpic_tpu_torch.core.types import Grid, SpeciesState
from vpic_tpu_torch.particles import aux, push, sort, sort_cuda

from .test_sort_pallas import KW, _canon, _mk_sorted, _perturb

from tests import torch_decks  # noqa: F401  (one torch thread)

M_CAP = KW["m_cap"]


def _sentinel(key0):
    key0 = key0.copy()
    key0[0] = -1
    return key0


# the kernel cases of tests/test_sort_pallas.py:
# (seed, n, nvk, np_, perturbation kwargs or None, key0 sentinel, rounds)
CASES = {
    "perturbed-1.0": (7, 2048, 96, 2048, {}, False, 1),
    "perturbed-0.93": (7, 2048, 96, int(2048 * 0.93), {}, False, 1),
    "sentinel": (3, 2048, 96, 2048, {}, True, 1),
    "mover-overflow": (11, 2048, 96, 2048, dict(frac=0.6), False, 1),
    "sparse-wide-span": (5, 1024, 4096, 300, dict(frac=0.1), False, 1),
    "steady-chain": (23, 2048, 128, 1920, dict(frac=0.04), True, 5),
    "identity": (2, 1024, 64, 1000, None, False, 1),
}
# where the port's merge (not its full sort) must run: the JAX package's
# span test sends "sparse-wide-span" to its bitonic, the port has no span
# limit; a sentinel or more than m_cap movers force the full sort
EXPECT_FAST = {"perturbed-1.0": [True], "perturbed-0.93": [True],
               "sentinel": [False], "mover-overflow": [False],
               "sparse-wide-span": [True],
               "steady-chain": [False] + [True] * 4, "identity": [True]}


def _jax_decision(pk, np_, key0, ctot, nvk, m_cap=M_CAP, B=KW["B"],
                  W=KW["W"], win_r=KW["win_r"]):
    """(use_fast, windows_ok) of ``sort_pallas.merge_sort_packed``
    (``sort_pallas.py:209-287``) in numpy: its decision, and whether its
    window tests (``span_ok``, ``fit_ok``), which the port leaves out,
    pass."""
    n, lane, bins = pk.shape[1], 128, nvk + 1
    key = np.where(np.arange(n) < np_,
                   (pk[7] + np.float32(0.5)).astype(np.int32), nvk)
    movers = key != key0
    n_m = int(movers.sum())
    cum_r_lanes = np.cumsum(~movers)
    valid = np.arange(m_cap) < n_m
    safe = np.zeros(m_cap, np.int64)
    lanes = np.nonzero(movers)[0][:m_cap]
    safe[:lanes.shape[0]] = lanes
    key_ms = np.sort(np.where(valid, key[safe], bins))
    v = np.arange(bins + 2)
    c_old = np.minimum(np.searchsorted(np.where(valid, key0[safe], bins), v,
                                       side="left"), n_m)
    c_new = np.minimum(np.searchsorted(key_ms, v, side="left"), n_m)
    cum_res = ctot - c_old
    cum_tot = cum_res + c_new
    p = np.arange(n // B) * B
    vj = np.clip(np.searchsorted(cum_tot, p, side="right") - 1, 0, bins)
    o = p - cum_tot[vj]
    res_in = cum_res[vj + 1] - cum_res[vj]
    rlo = np.where(o < res_in, cum_res[vj] + o, cum_res[vj + 1])
    rhi = np.concatenate([rlo[1:], [cum_r_lanes[-1]]])
    vj2 = np.clip(np.searchsorted(cum_tot, p + B - 1, side="right") - 1, 0,
                  bins)
    span_ok = bool(np.all(vj2 - vj < W))
    lane_lo = np.searchsorted(cum_r_lanes, rlo + 1, side="left")
    lane_lo = np.minimum((lane_lo // lane) * lane, n - win_r)
    lane_hi = np.searchsorted(cum_r_lanes, rhi, side="left")
    fit_ok = bool(np.all(np.where(rhi > rlo, lane_hi - lane_lo < win_r,
                                  True)))
    use_fast = (key0[0] >= 0 and n_m <= m_cap and span_ok and fit_ok
                and cum_tot[bins + 1] == n)
    return bool(use_fast), span_ok and fit_ok


_JAX_RUNS: dict = {}


def _jax_merge(pk, np_, key0, ctot, nvk, **kw):
    """The JAX package's merge re-sort (interpret mode) as numpy, run once
    per input in this module: the chained rounds of CASES recur in three
    tests."""
    key = hashlib.sha1(b"".join((pk.tobytes(), key0.tobytes(), ctot.tobytes(),
                                 repr((np_, nvk, sorted(kw.items())))
                                 .encode()))).digest()
    if key not in _JAX_RUNS:
        _JAX_RUNS[key] = [np.array(a) for a in sps.merge_sort_packed(
            jnp.asarray(pk), jnp.int32(np_), jnp.asarray(key0),
            jnp.asarray(ctot), nvk, **kw)]
    return _JAX_RUNS[key]


def _both(pk, np_, key0, ctot, nvk, m_cap=M_CAP, **jax_kw):
    j = _jax_merge(pk, np_, key0, ctot, nvk, **dict(KW, m_cap=m_cap,
                                                     **jax_kw))
    t = sort_cuda.merge_sort_packed(
        torch.as_tensor(pk), torch.tensor(np_, dtype=torch.int32),
        torch.as_tensor(key0), torch.as_tensor(ctot), nvk, m_cap)
    return j, t


def _assert_same(j, t, np_):
    j_pk, j_k0, j_ct, j_anom = j
    t_pk, t_k0, t_ct, t_anom = t[:4]
    np.testing.assert_array_equal(_canon(t_pk.numpy(), np_),
                                  _canon(j_pk, np_))
    np.testing.assert_array_equal(t_pk.numpy()[:, np_:], j_pk[:, np_:])
    np.testing.assert_array_equal(t_k0.numpy(), j_k0)
    np.testing.assert_array_equal(t_ct.numpy(), j_ct)
    assert int(t_anom) == int(j_anom) == 0


@pytest.mark.parametrize("name", list(CASES))
def test_merge_sort_packed_matches_jax(name):
    """The merge re-sort, its decision a 0-d device tensor: the block, key0
    and ctot the JAX package's; the decision the host's two-read one in
    every round (fast where the merge runs, slow from a missing snapshot
    or from more movers than m_cap) and the JAX package's use_fast
    wherever its window tests pass."""
    seed, n, nvk, np_, perturb, sentinel, rounds = CASES[name]
    rng = np.random.default_rng(seed)
    pk, key0, ctot = _mk_sorted(rng, n, np_, nvk)
    if sentinel:
        key0 = _sentinel(key0)
    fast, windows = [], []
    for _ in range(rounds):
        pk_in = pk if perturb is None else _perturb(rng, pk, np_, nvk,
                                                    **perturb)
        j, t = _both(pk_in, np_, key0, ctot, nvk)
        _assert_same(j, t, np_)
        # keys sorted, the canonical form of the input kept
        assert np.all(np.diff(t[0].numpy()[7, :np_]) >= 0)
        np.testing.assert_array_equal(_canon(t[0].numpy(), np_),
                                      _canon(pk_in, np_))
        assert t.fast.dtype == torch.bool and t.fast.shape == ()
        fast.append(bool(t.fast))
        assert fast[-1] == _two_read_decision(pk_in, np_, key0, ctot, nvk,
                                              M_CAP)
        use_fast, windows_ok = _jax_decision(pk_in, np_, key0, ctot, nvk)
        windows.append(windows_ok)
        if windows_ok:
            assert fast[-1] == use_fast
        pk, key0, ctot = j[0], j[1], j[2]
    assert fast == EXPECT_FAST[name]
    # the JAX package's span test sends the sparse, wide-span deck to its
    # full sort; every other merge of the port is the JAX package's merge
    if name == "sparse-wide-span":
        assert not any(windows)
    else:
        assert all(w for w, f in zip(windows, fast) if f)
    if name == "identity":
        np.testing.assert_array_equal(t[0].numpy(), pk_in)


def test_small_block_below_the_jax_window_is_exact():
    """n = 512: the JAX package's provisioning gives m_cap = 512 < B + 128
    = 640, a negative mover-window start (aux.py:250).  The port has no
    windows: its merge runs and the result is the exact sort."""
    n, np_, nvk = 512, 500, 64
    m_cap = sort.mover_capacity(n, 2)
    assert m_cap == 512 < 512 + 128
    rng = np.random.default_rng(4)
    pk, key0, ctot = _mk_sorted(rng, n, np_, nvk)
    pk2 = _perturb(rng, pk, np_, nvk, frac=0.05)
    j, t = _both(pk2, np_, key0, ctot, nvk, m_cap=m_cap, B=512, W=512,
                 win_r=512)
    _assert_same(j, t, np_)
    assert bool(t.fast)
    order = np.lexsort(pk2[::-1, :np_])
    np.testing.assert_array_equal(_canon(t[0].numpy(), np_),
                                  pk2[:, :np_][:, order])


def _two_read_decision(pk, np_, key0, ctot, nvk, m_cap):
    """The port's decision before the mark pass (and the JAX package's,
    less its window tests): snapshot and mover count first, then the plan's
    tables and ``cum_tot[nvk + 2] == n``, in numpy."""
    n = pk.shape[1]
    key = np.where(np.arange(n) < np_,
                   (pk[7] + np.float32(0.5)).astype(np.int32), nvk)
    movers = key != key0
    n_m = int(movers.sum())
    if not (key0[0] >= 0 and n_m <= m_cap):
        return False
    bins = nvk + 1
    valid = np.arange(m_cap) < n_m
    safe = np.zeros(m_cap, np.int64)
    safe[:n_m] = np.nonzero(movers)[0]
    key_ms = np.sort(np.where(valid, key[safe], bins), kind="stable")
    old = np.where(valid, key0[safe], bins)
    v = np.arange(bins + 2)
    c_old = np.minimum(np.searchsorted(old, v, side="left"), n_m)
    c_new = np.minimum(np.searchsorted(key_ms, v, side="left"), n_m)
    return bool((ctot - c_old + c_new)[nvk + 2] == n)


def _marks(pk, np_, key0, ctot, nvk, m_cap):
    return sort_cuda.mark(torch.as_tensor(pk),
                          torch.tensor(np_, dtype=torch.int32),
                          torch.as_tensor(key0), torch.as_tensor(ctot), nvk,
                          m_cap)


def _decision_inputs():
    """(label, pk, np_, key0, ctot, nvk, m_cap) of every round of the
    seven cases, the n = 512 case and a multi-tile mover overflow."""
    for name, (seed, n, nvk, np_, perturb, sentinel, rounds) in CASES.items():
        rng = np.random.default_rng(seed)
        pk, key0, ctot = _mk_sorted(rng, n, np_, nvk)
        if sentinel:
            key0 = _sentinel(key0)
        for r in range(rounds):
            pk_in = pk if perturb is None else _perturb(rng, pk, np_, nvk,
                                                        **perturb)
            yield f"{name}/{r}", pk_in, np_, key0, ctot, nvk, M_CAP
            j = _jax_merge(pk_in, np_, key0, ctot, nvk, **KW)
            pk, key0, ctot = j[0], j[1], j[2]
    rng = np.random.default_rng(4)
    pk, key0, ctot = _mk_sorted(rng, 512, 500, 64)
    yield ("n=512", _perturb(rng, pk, 500, 64, frac=0.05), 500, key0, ctot,
           64, sort.mover_capacity(512, 2))
    rng = np.random.default_rng(8)
    n = 3 * sort.TILE + 100
    pk, key0, ctot = _mk_sorted(rng, n, n - 40, 700)
    pk = _perturb(rng, pk, n - 40, 700, frac=0.2)
    yield "multi-tile overflow", pk, n - 40, key0, ctot, 700, 1024


def test_one_read_decision_matches_two_reads():
    """The mark pass's counts, turned on the device into the decision,
    take the same path as the plan's table test read after the snapshot
    and mover-count tests; a ctot that does not add up to n falls back in
    both."""
    seen = set()
    for label, pk, np_, key0, ctot, nvk, m_cap in _decision_inputs():
        want = _two_read_decision(pk, np_, key0, ctot, nvk, m_cap)
        fast = bool(sort.fast_path(
            _marks(pk, np_, key0, ctot, nvk, m_cap).info, m_cap))
        assert fast == want, label
        seen.add(fast)
        if fast:
            bad = ctot.copy()
            bad[nvk + 2] -= 1
            assert not _two_read_decision(pk, np_, key0, bad, nvk, m_cap)
            assert not bool(sort.fast_path(
                _marks(pk, np_, key0, bad, nvk, m_cap).info, m_cap))
    assert seen == {True, False}


@pytest.mark.parametrize("case", ["multi-tile", "overflow", "sentinel",
                                  "ragged-dead", "mover-tile"])
def test_mark_pass_against_cumsum(case):
    """n_m, the flags, each tile's residual prefix and first residual key
    and the movers' lanes and keys in lane order, against numpy cumsums
    over the lanes; the slots past the movers hold the sentinel."""
    rng = np.random.default_rng(31)
    n, nvk = 3 * sort.TILE + 100, 900
    np_ = n - 333 if case == "ragged-dead" else n
    pk, key0, ctot = _mk_sorted(rng, n, np_, nvk)
    pk = _perturb(rng, pk, np_, nvk, frac=0.3 if case == "overflow" else 0.05)
    if case == "sentinel":
        key0 = _sentinel(key0)
    if case == "mover-tile":   # every lane of tile 1 moves: no residual
        tile1 = slice(sort.TILE, 2 * sort.TILE)
        pk[7, tile1] = (key0[tile1] + 1) % nvk
    m_cap = 2048 if case == "overflow" else n
    marks = _marks(pk, np_, key0, ctot, nvk, m_cap)

    key = np.where(np.arange(n) < np_,
                   (pk[7] + np.float32(0.5)).astype(np.int32), nvk)
    movers = key != key0
    n_m = int(movers.sum())
    res_before = np.concatenate([[0], np.cumsum(~movers)])
    np.testing.assert_array_equal(marks.res_base.numpy(),
                                  res_before[::sort.TILE][:4])
    tiles = [slice(t * sort.TILE, (t + 1) * sort.TILE) for t in range(4)]
    first_key = [key[t][~movers[t]][0] if (~movers[t]).any() else -1
                 for t in tiles]
    assert (case == "mover-tile") == (first_key[1] == -1)
    np.testing.assert_array_equal(marks.res_key.numpy(), first_key)
    lanes = np.nonzero(movers)[0][:m_cap]
    k = lanes.shape[0]
    np.testing.assert_array_equal(marks.mov_lane.numpy()[:k], lanes)
    np.testing.assert_array_equal(marks.mov_key.numpy()[:k], key[lanes])
    np.testing.assert_array_equal(marks.mov_old.numpy()[:k], key0[lanes])
    for slots in (marks.mov_lane, marks.mov_key, marks.mov_old):
        assert slots.shape == (m_cap,)
        assert (slots.numpy()[k:] == sort.SENTINEL).all()
    out_of_range = int(((key < 0) | (key > nvk) | (key0 < 0)
                        | (key0 > nvk)).sum())
    assert marks.info.tolist() == [n_m, out_of_range, int(key0[0] >= 0),
                                   int(ctot[nvk + 2] == n)]
    fast = bool(sort.fast_path(marks.info, m_cap))
    assert fast == (case in ("multi-tile", "ragged-dead", "mover-tile"))
    assert (n_m > m_cap) == (case == "overflow")


def test_multi_tile_merge_matches_jax():
    """A block of three tiles and a ragged fourth, 5 % movers: the merge
    runs, and its block, key0 and ctot equal the JAX package's; the
    assembly's destinations form a permutation of the lanes."""
    rng = np.random.default_rng(17)
    n, nvk = 3 * sort.TILE + 512, 640
    np_ = n - 200
    pk, key0, ctot = _mk_sorted(rng, n, np_, nvk)
    pk = _perturb(rng, pk, np_, nvk, frac=0.05)
    m_cap = sort.mover_capacity(n, 1)
    j, t = _both(pk, np_, key0, ctot, nvk, m_cap=m_cap)
    assert t.fast
    _assert_same(j, t, np_)
    args = (torch.as_tensor(pk), torch.tensor(np_, dtype=torch.int32),
            torch.as_tensor(key0), torch.as_tensor(ctot), nvk)
    marks = sort.mark(*args, m_cap)
    plan = sort.merge_plan(marks)
    cum_res, cum_mov, _ = sort.tables(plan.key_ms, marks.mov_old, args[3])
    d = sort.destinations(*args[:3], marks, plan, cum_res, cum_mov, nvk)
    assert int(d.bad) == 0
    written = d.dest[d.dest < n]
    assert written.shape[0] == n
    assert torch.equal(torch.sort(written).values, torch.arange(n))


def _species_2d(seed):
    """A 16x16 2D grid (the JAX package's kernel space there is
    "interior", not the plain voxel) and the same sorted particles in
    both packages."""
    kw = dict(nx=16, ny=16, nz=1, dt=0.04)
    jg, g = JGrid(**kw), Grid(**kw)
    rng = np.random.default_rng(seed)
    n, max_np = 700, 1024
    vox = np.sort(np.asarray(g.voxel(rng.integers(1, 17, n),
                                     rng.integers(1, 17, n), 1), np.int32))
    cols = {k: rng.uniform(-1, 1, n) for k in ("dx", "dy", "dz")}
    cols.update({k: rng.normal(0, 0.2, n) for k in ("ux", "uy", "uz")})
    cols["q"] = rng.uniform(0.5, 1.5, n)
    pad = lambda a, dt: np.concatenate([a, np.zeros(max_np - n)]).astype(dt)
    cols = {k: pad(v, np.float32) for k, v in cols.items()}
    cols["i"] = pad(vox, np.int32)
    jsp = JSpecies.create("e", 0, -1.0, max_np).replace(
        np=jnp.int32(n), **{k: jnp.asarray(v) for k, v in cols.items()})
    tsp = SpeciesState.create("e", 0, -1.0, max_np).replace(
        np=torch.tensor(n, dtype=torch.int32),
        **{k: torch.as_tensor(v) for k, v in cols.items()})
    return jg, g, jsp, tsp, n


def test_pack_unpack_round_trip_matches_jax():
    jg, g, jsp, tsp, n = _species_2d(9)
    jpk = jpush.pack_species(jsp, jg)
    tpk = push.pack_species(tsp, g)
    np.testing.assert_array_equal(tpk.pk.numpy()[:7], np.asarray(jpk.pk)[:7])
    np.testing.assert_array_equal(tpk.pk.numpy()[7],
                                  tsp.i.numpy().astype(np.float32))
    assert (tpk.key0.numpy() == -1).all() and tpk.ctot.shape == (g.nv + 3,)
    jback = jpush.unpack_species(jpk, jg)
    tback = push.unpack_species(tpk, g)
    for c in ("dx", "dy", "dz", "i", "ux", "uy", "uz", "q", "mdx", "mdy",
              "mdz", "pc", "np", "nm"):
        np.testing.assert_array_equal(getattr(tback, c).numpy(),
                                      np.asarray(getattr(jback, c)),
                                      err_msg=c)
        np.testing.assert_array_equal(getattr(tback, c).numpy(),
                                      getattr(tsp, c).numpy(), err_msg=c)


def test_sort_p_packed_matches_jax():
    """Both sort a block of perturbed plain voxels (row 7) in full and
    invalidate the merge carry."""
    jg, g, jsp, tsp, n = _species_2d(10)
    tpk = push.pack_species(tsp, g)
    rows = _perturb(np.random.default_rng(12), tpk.pk.numpy(), n, g.nv,
                    frac=0.2)
    tpk = tpk.replace(pk=torch.as_tensor(rows))
    jpk = jpush.pack_species(jsp, jg).replace(pk=jnp.asarray(rows))
    jout = jaux.sort_p_packed(jpk, jg)
    tout = aux.sort_p_packed(tpk, g)
    t_rows, j_rows = tout.pk.numpy(), np.asarray(jout.pk)
    assert np.all(np.diff(t_rows[7, :n]) >= 0)
    np.testing.assert_array_equal(_canon(t_rows, n), _canon(j_rows, n))
    np.testing.assert_array_equal(_canon(t_rows, n), _canon(rows, n))
    assert not t_rows[:, n:].any() and not j_rows[:, n:].any()
    assert (tout.key0.numpy() == -1).all()
    assert (np.asarray(jout.key0) == -1).all()


def test_merge_plan_over_every_slot_starts_with_todays():
    """The movers' sort over all m_cap slots: its first min(n_m, m_cap)
    entries are the stable sort of the movers' slots alone, the rest the
    sentinel slots; where the merge runs, the tables over every slot are
    those over the movers'."""
    for label, pk, np_, key0, ctot, nvk, m_cap in _decision_inputs():
        marks = _marks(pk, np_, key0, ctot, nvk, m_cap)
        k = min(int(marks.info[0]), m_cap)
        plan = sort.merge_plan(marks)
        key_ms, order = torch.sort(marks.mov_key[:k], stable=True)
        assert torch.equal(plan.key_ms[:k], key_ms), label
        assert torch.equal(plan.order[:k], order), label
        assert (plan.key_ms[k:] == sort.SENTINEL).all(), label
        assert (plan.order[k:] >= k).all(), label
        if bool(sort.fast_path(marks.info, m_cap)):
            ctot_t = torch.as_tensor(ctot)
            for a, b in zip(sort.tables(plan.key_ms, marks.mov_old, ctot_t),
                            sort.tables(key_ms, marks.mov_old[:k], ctot_t)):
                assert torch.equal(a, b), label


def _no_host_reads(monkeypatch):
    """Make every host read of a tensor raise: ``tolist``, ``item``,
    ``nonzero`` and the conversions a Python branch on a tensor makes."""
    def refuse(*args, **kw):
        raise AssertionError("a host read on the merge re-sort's path")
    for name in ("tolist", "item", "nonzero", "__bool__", "__int__",
                 "__float__", "__index__"):
        monkeypatch.setattr(torch.Tensor, name, refuse)
    monkeypatch.setattr(torch, "nonzero", refuse)


def test_the_merge_re_sort_reads_nothing(monkeypatch):
    """``sort.merge_sort_packed`` (a fast, a no-snapshot and an overflow
    case) and ``aux.sort_p_packed_merge`` (a packed species' full first
    sort, then a merge) run with every host read raising; the decisions
    and the species' sort counts come out afterwards."""
    blocks = []
    for name in ("perturbed-1.0", "sentinel", "mover-overflow"):
        seed, n, nvk, np_, perturb, sentinel, _ = CASES[name]
        rng = np.random.default_rng(seed)
        pk, key0, ctot = _mk_sorted(rng, n, np_, nvk)
        if sentinel:
            key0 = _sentinel(key0)
        blocks.append((torch.as_tensor(_perturb(rng, pk, np_, nvk,
                                                **perturb)),
                       torch.tensor(np_, dtype=torch.int32),
                       torch.as_tensor(key0), torch.as_tensor(ctot), nvk))
    jg, g, jsp, tsp, n = _species_2d(13)
    psp = push.pack_species(tsp, g).replace(name="reads-nothing")
    sort_cuda.reset_launch_counts()
    with monkeypatch.context() as mp:
        _no_host_reads(mp)
        results = [sort.merge_sort_packed(*b, M_CAP) for b in blocks]
        first = aux.sort_p_packed_merge(psp, g, 1)
        rows = first.pk.clone()
        rows[7, :5] = rows[7, 5:10]   # five lanes move
        second = aux.sort_p_packed_merge(first.replace(pk=rows), g, 1)
    assert [bool(r.fast) for r in results] == [True, False, False]
    assert sort_cuda.sort_counts()["reads-nothing"] == {"fast": 1,
                                                         "slow": 1}
    assert int(second.nm) == 0
    assert bool((second.key0[1:] >= second.key0[:-1]).all())
