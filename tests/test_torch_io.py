"""The port's diagnostics and IO against the JAX package, from one state
loaded into both through vpic_tpu_torch.interop (the turbulence deck at
8x8x8 cells, 2 per cell, after 2 steps of the JAX package), and the
port's checkpoints.

- Byte for byte: the V0 field and grid dumps, the banded field dumps, the
  species and materials listings and global.vpc; the particle and hydro
  dumps' headers; the JAX package's readers parse the port's files.
- The particle dump's records: positions, voxels and charges equal,
  momenta (center_p) within rtol 1e-6, atol 1e-6.
- Hydro moments within 1e-6 * max|column| per column: the JAX package
  sums in float32, the port in int64 fixed point.
- checksum_fields / checksum_species: the JAX digests.
- The energy-band distribution and spectrum files equal; on 200 000 hot
  random lanes each lane's band and spectrum bin are counted against the
  JAX package's numpy arithmetic, at most 1 in 10^4 may move one bin.
- Checkpoints (tests/test_io.py:136-230 for the port): save, restore and
  advance bitwise equal to the run without the checkpoint; under the
  packed cycle the restored state is bitwise and the continued run
  within the slice bars; short particle columns padded; other shape
  mismatches and other formats rejected; the rotating checkpointer.
- time_phases, PhaseTimers and sim_log.
- The fixed-point rho and hydro deposits: bitwise the same for lanes in
  any order, within 1e-6 * sum|contribution| of a float64 deposit plus
  half a fixed-point quantum per contribution.
"""

import importlib
import json

import numpy as np
import pytest
import torch

import chip_smoke as cs
import vpic_tpu_torch.decks.turbulence as tturb
from vpic_tpu.core import diagnostics as jdiag
from vpic_tpu.diag import energy_dist as jed
from vpic_tpu.io import banded as jbanded
from vpic_tpu.io import dump as jdump

from vpic_tpu_torch.core import diagnostics as tdiag
from vpic_tpu_torch.core.types import FIELD_COMPONENTS, FieldState
from vpic_tpu_torch.decks import bench_deck
from vpic_tpu_torch.diag import energy_dist as ted
from vpic_tpu_torch.interop import state_from_numpy, state_to_numpy
from vpic_tpu_torch.io import banded, dump
from vpic_tpu_torch.io.checkpoint import RotatingCheckpointer
from vpic_tpu_torch.particles import aux

from tests import torch_decks  # noqa: F401  (one torch thread)

TURB = dict(TURB_NX="8", TURB_NY="8", TURB_NZ="8", TURB_PPC="2")
HEADER = 103            # bytes of a V0 header


@pytest.fixture(scope="module")
def pair():
    with pytest.MonkeyPatch.context() as mp:
        for k, v in TURB.items():
            mp.setenv(k, v)
        jturb = importlib.import_module("decks.turbulence")
        jsim = jturb.deck()
        jsim.finalize()
        jsim.advance(2)
        tsim = tturb.deck(device="cpu")
        tsim.finalize()
    tsim.state = state_from_numpy(state_to_numpy(jsim.state))
    tsim.step_count = jsim.step_count
    return jsim, tsim


def both(tmp_path, fn):
    """fn(sim, directory) for each package; returns the two results."""
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    return fn(0, tmp_path / "j"), fn(1, tmp_path / "t")


def _fields(sim, d):
    sim.dump_fields(str(d / "f"))
    return d / f"f.{sim.step_count}.0"


def _grid(sim, d):
    sim.dump_grid(str(d / "grid"))
    return d / "grid.0"


def _species(sim, d):
    sim.dump_species(str(d / "sp"))
    return d / "sp"


def _materials(sim, d):
    sim.dump_materials(str(d / "m"))
    return d / "m"


def _global(sim, d):
    sim.write_global_header(str(d / "global"))
    return d / "global.vpc"


V0 = {"fields": _fields, "grid": _grid, "species": _species,
      "materials": _materials, "global": _global}


@pytest.mark.parametrize("kind", list(V0))
def test_dumps_byte_identical(pair, tmp_path, kind):
    jp, tp = both(tmp_path, lambda k, d: V0[kind](pair[k], d))
    assert jp.read_bytes() == tp.read_bytes()


DPS = {"band": {}, "strided-interleaved": dict(
    stride_x=2, stride_z=3, format=banded.BAND_INTERLEAVE,
    select=("ex", "cbz", "rhof", "jfy"))}


@pytest.mark.parametrize("dp", list(DPS))
def test_banded_field_dump_byte_identical(pair, tmp_path, dp):
    jsim, tsim = pair
    jp = jbanded.field_dump(jsim.state, jsim.grid, tmp_path / "j", jbanded
                            .DumpParameters(**DPS[dp]), jsim.step_count)
    tp = banded.field_dump(tsim.state, tsim.grid, tmp_path / "t", banded
                           .DumpParameters(**DPS[dp]), tsim.step_count)
    assert jp.read_bytes() == tp.read_bytes()
    # the JAX package's reader parses the port's file
    hdr, out, info = jbanded.read_banded(tp)
    assert hdr["dump_type"] == jdump.FIELD_DUMP and hdr["step"] == 2
    for name, arr in out.items():
        want = banded._strided(getattr(tsim.state.field, name), tsim.grid,
                               banded.DumpParameters(**DPS[dp])).numpy()
        np.testing.assert_array_equal(arr, want, err_msg=name)


def test_jax_reader_parses_port_v0_dump(pair, tmp_path):
    _, tsim = pair
    path = V0["fields"](tsim, tmp_path)
    g = tsim.grid
    with open(path, "rb") as f:
        hdr = jdump.read_header_v0(f)
        assert (hdr["magic_s"], hdr["magic_i"]) == (0xCAFE, 0xDEADBEEF)
        assert (hdr["nx"], hdr["ny"], hdr["nz"]) == (g.nx, g.ny, g.nz)
        assert jdump.read_array_header(f) == (80, (g.nxg, g.nyg, g.nzg))
        rec = np.frombuffer(f.read(), np.dtype([("f", "<f4", 16),
                                                ("m", "<u2", 8)]))
    for k, c in enumerate(FIELD_COMPONENTS):
        np.testing.assert_array_equal(
            rec["f"][:, k], getattr(tsim.state.field, c).numpy().ravel())
    assert not rec["m"].any()


@pytest.mark.parametrize("name", ["eT", "iB", "eR"])
def test_particle_dump(pair, tmp_path, name):
    def run(k, d):
        pair[k].dump_particles(name, str(d / "p"))
        return d / f"p.{pair[k].step_count}.0"
    jp, tp = both(tmp_path, run)
    jb, tb = jp.read_bytes(), tp.read_bytes()
    assert jb[:HEADER + 12] == tb[:HEADER + 12]
    j = np.frombuffer(jb[HEADER + 12:], dump.PARTICLE_RECORD)
    t = np.frombuffer(tb[HEADER + 12:], dump.PARTICLE_RECORD)
    assert j.shape == t.shape and j.shape[0] > 0
    for c in ("dx", "dy", "dz", "i", "q"):
        np.testing.assert_array_equal(t[c], j[c], err_msg=c)
    # center_p's half push may round a multiply-add differently (see
    # tests/test_torch_push.py); where it cancels to a small momentum the
    # few ulp of the operands take the absolute bar
    for c in ("ux", "uy", "uz"):
        np.testing.assert_allclose(t[c], j[c], rtol=1e-6, atol=1e-6,
                                   err_msg=c)


def assert_hydro_close(t, j, label):
    """Each of the 14 columns within 1e-6 * max|column|."""
    t, j = t.reshape(-1, t.shape[-1]), j.reshape(-1, j.shape[-1])
    for c in range(14):
        scale = np.abs(j[:, c]).max()
        np.testing.assert_allclose(t[:, c], j[:, c], rtol=0,
                                   atol=1e-6 * scale,
                                   err_msg=f"{label} column {c}")


@pytest.mark.parametrize("name", ["eT", "eB", "iT", "iB", "eR", "iR"])
def test_hydro_dumps(pair, tmp_path, name):
    jsim, tsim = pair
    def run(k, d):
        pair[k].dump_hydro(name, str(d / "h"))
        return d / f"h.{pair[k].step_count}.0"
    jp, tp = both(tmp_path, run)
    jb, tb = jp.read_bytes(), tp.read_bytes()
    assert jb[:HEADER + 20] == tb[:HEADER + 20]
    j = np.frombuffer(jb[HEADER + 20:], "<f4").reshape(-1, 16)
    t = np.frombuffer(tb[HEADER + 20:], "<f4").reshape(-1, 16)
    assert_hydro_close(t[:, :14], j[:, :14], name)
    assert not t[:, 14:].any()
    if name in ("eR", "iR"):            # q = 0 tracers deposit nothing
        assert not t.any()
    # the banded hydro dump of the same moments
    g = tsim.grid
    sid = tsim._species_by_name(name)["sid"]
    path = banded.hydro_dump(tsim._hydro(name), g, tmp_path / "bh",
                             banded.DumpParameters(), 2, sid, 1.0)
    _, out, _ = jbanded.read_banded(path)
    got = np.stack([out[v] for v in banded.HYDRO_VARS], axis=-1)
    want = j[:, :14].reshape(g.nzg, g.nyg, g.nxg, 14)[1:-1, 1:-1, 1:-1]
    assert_hydro_close(got, want, name + " banded")


def test_checksums_are_the_jax_digests(pair):
    jsim, tsim = pair
    assert tsim.checksum_fields() == jsim.checksum_fields()
    for h in tsim._species:
        assert tsim.checksum_species(h["name"]) == \
            jsim.checksum_species(h["name"])
    assert tdiag.checksum_fields(tsim.state) == \
        jdiag.checksum_fields(jsim.state)


@pytest.mark.parametrize("name", ["eT", "iB"])
def test_energy_diag_files_equal(pair, tmp_path, name):
    vth = 0.6 if name.startswith("e") else 0.6 / 5.0
    jp, tp = both(tmp_path, lambda k, d: pair[k].dump_energy_diag(
        name, d, nex=40, emax=tturb.EMAX, vth=vth)[0])
    for a, b in zip(jp, tp):
        assert a.read_bytes() == b.read_bytes(), a.name
    dist, edist = jed.read_energy_diag(tmp_path / "t", 2, name, 0, 40,
                                       pair[1].grid.nv)
    assert dist.shape == (40, pair[1].grid.nv) and edist.sum() > 0


def test_energy_bins_of_hot_lanes():
    """Per lane, the band of the port's float32 arithmetic against the
    JAX package's numpy one, and the spectrum bin (log10 of each side's
    library): at most 1 lane in 10^4 moves, by one bin."""
    rng = np.random.default_rng(4)
    n, nex, emax, vth = 200_000, 200, 50.0, 0.6
    u = [rng.normal(0, 2.0, n).astype(np.float32) for _ in range(3)]
    ke_j = jed.relativistic_ke(*u)
    ke_t = ted.relativistic_ke(*(torch.as_tensor(c) for c in u))
    np.testing.assert_array_equal(ke_t.numpy(), ke_j)
    dke = emax * (vth * vth / 2.0) / nex
    band_j = np.minimum((ke_j / dke).astype(np.int64), nex - 1)
    band_t = torch.clamp(ted._div(ke_t, dke).to(torch.int64), max=nex - 1)
    moved = band_t.numpy() != band_j
    pos = ke_j > 0
    dloge = (np.log10(1e4) - np.log10(1e-4)) / 800
    bin_j = ((np.log10(ke_j[pos]) - np.log10(1e-4)) / dloge + 1) \
        .astype(np.int64)
    t = torch.log10(ke_t[torch.as_tensor(pos)]).double() - np.log10(1e-4)
    bin_t = (t / torch.full_like(t, dloge) + 1).to(torch.int64).numpy()
    moved_bins = bin_t != bin_j
    print(f"lanes moving one band: {int(moved.sum())}, one spectrum bin: "
          f"{int(moved_bins.sum())} of {n}")
    for m, a, b in ((moved, band_t.numpy(), band_j),
                    (moved_bins, bin_t, bin_j)):
        assert m.sum() <= n * 1e-4
        assert np.all(np.abs(a[m] - b[m]) == 1)
    alive = torch.ones(n, dtype=torch.bool)
    spec = ted.energy_spectrum(*(torch.as_tensor(c) for c in u), alive, vth)
    want = jed.energy_spectrum(*u, np.ones(n, bool), vth)
    assert np.abs(spec.numpy() - want).sum() <= 2 * moved_bins.sum()


# -- checkpoints (tests/test_io.py:136-230) ---------------------------------

def small_deck(**kw):
    return bench_deck.build(nx=6, ny=6, nz=1, npart=512, seed=5,
                            device="cpu", **kw)


def fields_of(sim):
    return {c: getattr(sim.state.field, c).clone() for c in FIELD_COMPONENTS}


def test_checkpoint_restore_determinism(tmp_path):
    sim = small_deck()
    sim.advance(3)
    sim.checkpoint(tmp_path / "ck")
    sim.advance(4)
    ref, ref_p = fields_of(sim), sim.state.species[0].ux.clone()

    sim2 = small_deck()
    sim2.restore(tmp_path / "ck")
    assert sim2.step_count == 3
    sim2.advance(4)
    for c, v in ref.items():
        assert torch.equal(getattr(sim2.state.field, c), v), c
    assert torch.equal(sim2.state.species[0].ux, ref_p)


def test_checkpoint_restore_under_the_packed_cycle(tmp_path):
    """A checkpoint taken under the packed cycle holds the unpacked state
    and restores bit for bit through the ``state`` setter.  The merge
    re-sort's carry (key0/ctot) is not saved, so the restored run's first
    sort is a full sort, which may order lanes of one voxel otherwise; the
    CPU's plain deposit sums in lane order, so the continued run matches
    to the bars of tests/test_torch_slice.py, not bitwise."""
    sim = small_deck()
    sim.modify_runparams(merge_sort=True)
    sim.advance(3)
    sim.checkpoint(tmp_path / "ck")
    saved = state_to_numpy(sim.state)
    sim.advance(4)

    sim2 = small_deck()
    sim2.modify_runparams(merge_sort=True)
    sim2.restore(tmp_path / "ck")
    for k, v in state_to_numpy(sim2.state).items():
        np.testing.assert_array_equal(v, saved[k], err_msg=k)
    sim2.advance(4)
    assert sim2._pstate is not None and sim2.step_count == 7
    for c, v in fields_of(sim).items():
        np.testing.assert_allclose(getattr(sim2.state.field, c), v, rtol=0,
                                   atol=1e-5, err_msg=c)
    for a, b in zip(sim.state.species, sim2.state.species):
        assert int(a.np) == int(b.np) and int(a.nm) == int(b.nm) == 0
        n = int(a.np)
        key = lambda s: np.lexsort((s.dx[:n].numpy(), s.i[:n].numpy()))
        ka, kb = key(a), key(b)
        np.testing.assert_array_equal(a.i[:n].numpy()[ka],
                                      b.i[:n].numpy()[kb])
        for c in ("dx", "dy", "dz", "ux", "uy", "uz"):
            np.testing.assert_allclose(getattr(b, c)[:n].numpy()[kb],
                                       getattr(a, c)[:n].numpy()[ka],
                                       rtol=0, atol=1e-5, err_msg=c)


def test_checkpoint_pads_unaligned_capacity(tmp_path):
    sim = small_deck()
    sim.advance(2)
    sim.checkpoint(tmp_path / "ck")
    path = str(tmp_path / "ck") + ".npz"
    data = dict(np.load(path))
    max_np = sim.state.species[0].max_np
    short = max(300, int(sim.state.species[0].np))
    for k, v in data.items():
        if k.startswith("species/") and v.ndim == 1 and v.shape[0] == max_np:
            data[k] = v[:short]
    np.savez(path, **data)
    sim.advance(3)
    ref = fields_of(sim)

    sim2 = small_deck()
    sim2.restore(tmp_path / "ck")
    sim2.advance(3)
    for c, v in ref.items():
        assert torch.equal(getattr(sim2.state.field, c), v), c


def test_checkpoint_rejects_mismatches(tmp_path):
    sim = small_deck()
    sim.checkpoint(tmp_path / "ck")
    path = str(tmp_path / "ck") + ".npz"
    data = dict(np.load(path))
    data["field/ex"] = data["field/ex"][:-1]
    np.savez(path, **data)
    with pytest.raises(ValueError, match="shape"):
        small_deck().restore(tmp_path / "ck")

    sim.checkpoint(tmp_path / "other")
    meta = json.loads((tmp_path / "other.json").read_text())
    meta["package"] = "vpic_tpu"
    (tmp_path / "other.json").write_text(json.dumps(meta))
    with pytest.raises(ValueError, match="format"):
        small_deck().restore(tmp_path / "other")


def test_rotating_checkpointer(tmp_path):
    sim = small_deck()
    rc = RotatingCheckpointer(tmp_path, quota_hours=1e9)
    slots = [rc.save(sim.state, sim.grid) for _ in range(3)]
    assert [s.parent.name for s in slots] == ["restart1", "restart2",
                                              "restart1"]
    assert rc.latest() is not None
    assert not rc.over_quota()


def test_time_phases_and_phase_timers(capsys):
    sim = small_deck()
    t = sim.time_phases(1)
    parts = {f"{k}[{n}]" for n in ("electron", "ion")
             for k in ("sort", "advance_p")}
    assert set(t) == parts | {"advance_b", "advance_e", "synchronize_jf",
                              "load_interpolator", "unload_accumulator"}
    assert all(v >= 0 for v in t.values())
    timers = tdiag.PhaseTimers()
    timers.add("particle", 0.003)
    timers.steps = 2
    assert timers.report().split()[0] == "particle=1.50ms"
    tdiag.sim_log("hello")
    assert capsys.readouterr().err == "[vpic_tpu_torch] hello\n"


# -- the fixed-point deposits -------------------------------------------------

def test_fixed_point_deposits_do_not_depend_on_lane_order(pair):
    """rho and hydro of a permuted species equal bit for bit; every
    species' deposits within 1e-6 * sum|contribution| per node of a
    float64 deposit, plus half a fixed-point quantum per contribution
    (chip_smoke.check_fixed_deposits, as on the card)."""
    _, tsim = pair
    g, st = tsim.grid, tsim.state
    sp = st.species[0]
    n = int(sp.np)
    perm = torch.cat([torch.randperm(n, generator=torch.Generator()
                                     .manual_seed(1)),
                      torch.arange(n, sp.max_np)])
    shuffled = sp.replace(**{k: getattr(sp, k)[perm] for k in
                             ("dx", "dy", "dz", "i", "ux", "uy", "uz", "q",
                              "tag")})
    f0 = FieldState.zeros(g)
    rho = aux.accumulate_rho_p(f0, sp, g).rhof
    assert torch.equal(rho, aux.accumulate_rho_p(f0, shuffled, g).rhof)
    h0 = torch.zeros((g.nv, 14))
    hy = aux.accumulate_hydro_p(h0, sp, st.interpolator, g, chunk=128)
    assert torch.equal(hy, aux.accumulate_hydro_p(
        h0, shuffled, st.interpolator, g, chunk=100))
    cs.check_fixed_deposits("8x8x8", tsim, [h["name"] for h in tsim._species])
