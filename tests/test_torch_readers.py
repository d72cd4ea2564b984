"""The port's dump readers (vpic_tpu_torch/io/readers.py), its native dump
library bindings (io/native.py, built from native/vpic_dump.cpp with g++)
and its field post-processing (post/fields.py) against the JAX package.

- Readers: one state (a small 2D box of the JAX package after 2 steps,
  loaded into the port through interop) dumped once by each package;
  each package's reader parses both packages' files to equal arrays, and
  the port's files read back as the port's state: fields and hydro
  bitwise, particles as ``center_p`` of the state.  assemble_brick joins
  the per-rank field dumps the JAX package writes on two shards as the
  JAX reader does.
- Native (tests/test_native_io.py for the port; skipped only where g++ is
  absent): the header and the bulk particle read against numpy, the
  banded join of the JAX package's per-rank files against the Python
  join, and a failed build raising with the compiler's output.
- post.fields (tests/test_post.py for the port): every function against
  the JAX package's to 1e-12 on the same inputs, and the physics checks
  of tests/test_post.py.
"""

import shutil

import numpy as np
import pytest
import torch

import vpic_tpu
from vpic_tpu.core.types import Grid as JGrid
from vpic_tpu.io import banded as jbanded
from vpic_tpu.io import readers as jreaders
from vpic_tpu.post import fields as jpost

import vpic_tpu_torch
from vpic_tpu_torch.core.types import FIELD_COMPONENTS, Grid
from vpic_tpu_torch.interop import state_from_numpy, state_to_numpy
from vpic_tpu_torch.io import banded, dump, native, readers
from vpic_tpu_torch.particles import push
from vpic_tpu_torch.post import fields as post

from tests import torch_decks  # noqa: F401  (one torch thread)

NX, NY = 8, 6


def build(port, px=1):
    """tests/test_native_io.py:build, its particles drawn with numpy:
    512 electrons in an 8x6 periodic box with a set ex, 2 steps."""
    L = 1.0
    sim = (vpic_tpu_torch.Simulation(seed=4, device="cpu") if port
           else vpic_tpu.Simulation(seed=4))
    sim.define_units(1.0, 1.0)
    sim.define_timestep(0.9 * sim.courant_length(L, L, L, NX, NY, 1))
    sim.define_periodic_grid(0, 0, 0, L, L, L, NX, NY, 1, px, 1, 1)
    sim.define_material("vacuum")
    e = sim.define_species("electron", -1.0, 2048)
    rng = np.random.default_rng(4)
    n = 512
    sim.inject_particle(e, *rng.uniform(0, L, (3, n)),
                        *rng.normal(0, 0.2, (3, n)), q=-1.0 / n)
    sim.set_field("ex", lambda x, y, z: np.sin(2 * np.pi * x) + y)
    sim.finalize()
    if not port:
        sim.advance(2)
    return sim


def write(sim, d):
    """Field, hydro and particle dumps and the energies of one package's
    sim under directory ``d``; returns their paths."""
    s = sim.step_count
    sim.dump_fields(str(d / "f"))
    sim.dump_hydro("electron", str(d / "h"))
    sim.dump_particles("electron", str(d / "p"))
    sim.dump_energies(str(d / "energies"), append=False)
    return dict(fields=d / f"f.{s}.0", hydro=d / f"h.{s}.0",
                particles=d / f"p.{s}.0", energies=d / "energies")


@pytest.fixture(scope="module")
def dumps(tmp_path_factory):
    jsim = build(False)
    tsim = build(True)
    tsim.state = state_from_numpy(state_to_numpy(jsim.state))
    tsim.step_count = jsim.step_count
    root = tmp_path_factory.mktemp("dumps")
    (root / "j").mkdir()
    (root / "t").mkdir()
    return tsim, write(jsim, root / "j"), write(tsim, root / "t")


def _same_header(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k] == b[k], k


@pytest.mark.parametrize("which", ("j", "t"))
@pytest.mark.parametrize("kind", ("fields", "hydro"))
def test_mesh_readers_match_jax(dumps, which, kind):
    path = dumps[1 if which == "j" else 2][kind]
    read = {"fields": (readers.read_fields, jreaders.read_fields),
            "hydro": (readers.read_hydro, jreaders.read_hydro)}[kind]
    (th, tv), (jh, jv) = read[0](path), read[1](path)
    _same_header(th, jh)
    assert tv.keys() == jv.keys()
    for k in tv:
        np.testing.assert_array_equal(tv[k], jv[k], err_msg=k)


@pytest.mark.parametrize("which", ("j", "t"))
def test_particle_reader_matches_jax(dumps, which):
    path = dumps[1 if which == "j" else 2]["particles"]
    (th, tr, tx), (jh, jr, jx) = (readers.read_particles(path),
                                  jreaders.read_particles(path))
    _same_header(th, jh)
    np.testing.assert_array_equal(tr, jr)
    np.testing.assert_array_equal(tx, jx)
    assert tr.shape == (512,)
    assert np.all((tx >= 0) & (tx <= 1))


def test_fields_and_hydro_read_back_as_the_state(dumps):
    tsim, _, t = dumps
    _, fields = readers.read_fields(t["fields"])
    st = tsim.state
    for c in FIELD_COMPONENTS:
        np.testing.assert_array_equal(fields[c], getattr(st.field, c).numpy(),
                                      err_msg=c)
    assert not fields["materials"].any()
    hdr, hydro = readers.read_hydro(t["hydro"])
    assert hdr["step"] == tsim.step_count and hdr["sp_id"] == 0
    h = tsim._hydro("electron").numpy()
    for k, name in enumerate(readers.HYDRO_NAMES):
        np.testing.assert_array_equal(hydro[name].reshape(-1), h[:, k],
                                      err_msg=name)


def test_particles_read_back_as_center_p(dumps):
    tsim, _, t = dumps
    _, rec, _ = readers.read_particles(t["particles"])
    sp = tsim.state.species[0]
    c = push.center_p(sp, tsim.state.interpolator, tsim.grid)
    alive = sp.alive.numpy()
    for k in ("dx", "dy", "dz", "i", "ux", "uy", "uz", "q"):
        np.testing.assert_array_equal(rec[k], getattr(c, k).numpy()[alive],
                                      err_msg=k)


def test_energies_reader(dumps):
    _, j, t = dumps
    (tn, tv), (jn, jv) = (readers.read_energies(t["energies"]),
                          jreaders.read_energies(t["energies"]))
    assert tn == jn == ["step", "ex", "ey", "ez", "bx", "by", "bz",
                        "electron"]
    np.testing.assert_array_equal(tv, jv)
    _, jfile = readers.read_energies(j["energies"])
    np.testing.assert_allclose(tv, jfile, rtol=1e-6, atol=1e-12)


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """The JAX package's box split into two x shards of 4 cells: per-rank
    V0 field dumps and banded dumps of three variables."""
    jsim = build(False, px=2)
    d = tmp_path_factory.mktemp("ranks")
    jsim.dump_fields(str(d / "f"))
    s = jsim.step_count
    dp = jbanded.DumpParameters(select=("ex", "cbz", "rhof"))
    band = []
    for shard, rank, st in jsim._shard_states():
        band.append(d / f"b.{rank}")
        jbanded.field_dump(st, jsim.grid, band[-1], dp, s, shard, rank, 2)
    return jsim.grid, [d / f"f.{s}.{r}" for r in range(2)], band, d


@pytest.mark.parametrize("component", ("ex", "cbz", "jfx"))
def test_assemble_brick_matches_jax(two_ranks, component):
    g, paths, _, _ = two_ranks
    got = readers.assemble_brick(paths, None, (1, 1, 2), component)
    want = jreaders.assemble_brick(paths, None, (1, 1, 2), component)
    assert got.shape == (1, NY, NX)
    np.testing.assert_array_equal(got, want)


@pytest.fixture
def gxx():
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed: the native library cannot be "
                    "built")


def test_native_header_and_particles(dumps, gxx):
    tsim, _, t = dumps
    path = t["particles"]
    hdr = native.read_header(path)
    assert hdr["dump_type"] == dump.PARTICLE_DUMP
    assert hdr["step"] == tsim.step_count
    assert (hdr["nx"], hdr["ny"], hdr["nz"]) == (NX, NY, 1)
    assert hdr["elem_size"] == 32 and hdr["dims"] == (512,)
    rec = native.read_particles(path)
    assert rec.shape == (512, 8)
    with open(path, "rb") as f:
        dump.read_header_v0(f)
        dump.read_array_header(f)
        ref = np.fromfile(f, "<f4").reshape(-1, 8)
    np.testing.assert_array_equal(rec, ref)
    _, structured, _ = readers.read_particles(path)
    np.testing.assert_array_equal(rec.view(readers.PARTICLE_REC)[:, 0],
                                  structured)
    assert native.library_path().parent.name == "_build"


def test_native_banded_join(two_ranks, gxx):
    g, _, paths, d = two_ranks
    assert native.join_banded(paths, 2, 1, 1, d / "joined.bin") == 3
    joined = np.fromfile(d / "joined.bin", "<f4").reshape(3, 1, NY, NX)
    for k, name in enumerate(("ex", "cbz", "rhof")):
        ref = np.concatenate([banded.read_banded(p)[1][name] for p in paths],
                             axis=2)
        jref = np.concatenate([jbanded.read_banded(p)[1][name]
                               for p in paths], axis=2)
        np.testing.assert_array_equal(joined[k], ref, err_msg=name)
        np.testing.assert_array_equal(ref, jref, err_msg=name)
    with pytest.raises(ValueError, match="topology"):
        native.join_banded(paths, 3, 1, 1, d / "bad.bin")


def test_native_build_failure_raises_with_the_log(tmp_path, monkeypatch,
                                                  gxx):
    bad = tmp_path / "broken.cpp"
    bad.write_text("extern \"C\" int f() { return undeclared_name; }\n")
    monkeypatch.setattr(native, "_SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="undeclared_name"):
        native.load()
    assert not list((tmp_path / "build").glob("*.so"))


# -- post.fields (tests/test_post.py) ------------------------------------

def _grids():
    kw = dict(nx=16, ny=8, nz=4, gx1=2.0, gy1=1.0, gz1=0.5)
    return Grid(**kw), JGrid(**kw)


SHAPE = (4, 8, 16)


def _close(t, j, what=""):
    assert isinstance(t, torch.Tensor) and t.dtype == torch.float64
    scale = float(np.abs(j).max()) + 1e-300
    np.testing.assert_allclose(t.numpy(), j, rtol=1e-12, atol=1e-12 * scale,
                               err_msg=what)


def _ddb(a, d, axis):
    return (a - np.roll(a, 1, axis=axis)) / d


def _ddf(a, d, axis):
    return (np.roll(a, -1, axis=axis) - a) / d


def test_gauge_fields_matches_jax_and_reproduces_curl_and_div():
    g, jg = _grids()
    rng = np.random.default_rng(0)
    gx, gy, gz = (rng.normal(size=SHAPE) for _ in range(3))
    for a in (0, 1, 2):
        gx = (np.roll(gx, 1, a) + gx + np.roll(gx, -1, a)) / 3
        gy = (np.roll(gy, 1, a) + gy + np.roll(gy, -1, a)) / 3
        gz = (np.roll(gz, 1, a) + gz + np.roll(gz, -1, a)) / 3
    bx = _ddf(gz, g.dy, 1) - _ddf(gy, g.dz, 0)
    by = _ddf(gx, g.dz, 0) - _ddf(gz, g.dx, 2)
    bz = _ddf(gy, g.dx, 2) - _ddf(gx, g.dy, 1)
    ex, ey, ez = (rng.normal(size=SHAPE) for _ in range(3))
    got = post.gauge_fields(g, torch.as_tensor(ex), ey, ez, bx, by, bz)
    want = jpost.gauge_fields(jg, ex, ey, ez, bx, by, bz)
    for name, t, j in zip(("phi", "ax", "ay", "az", "rho"), got, want):
        _close(t, j, name)
    phi, ax, ay, az, rho = (t.numpy() for t in got)
    dive = _ddb(ex, g.dx, 2) + _ddb(ey, g.dy, 1) + _ddb(ez, g.dz, 0)
    np.testing.assert_allclose(rho, g.eps0 * dive, rtol=1e-10, atol=1e-12)
    scale = np.abs(bx).max()
    np.testing.assert_allclose(_ddf(az, g.dy, 1) - _ddf(ay, g.dz, 0), bx,
                               atol=1e-9 * scale)
    np.testing.assert_allclose(_ddf(ax, g.dz, 0) - _ddf(az, g.dx, 2), by,
                               atol=1e-9 * scale)
    np.testing.assert_allclose(_ddf(ay, g.dx, 2) - _ddf(ax, g.dy, 1), bz,
                               atol=1e-9 * scale)
    for p in (phi, ax, ay, az):
        assert abs(p.mean()) < 1e-10 * (abs(p).max() + 1e-30)


def test_smooth_field_matches_jax_and_passes_the_band():
    g, jg = _grids()
    z, y, x = np.meshgrid(np.arange(g.nz), np.arange(g.ny), np.arange(g.nx),
                          indexing="ij")
    long_wave = np.cos(2 * np.pi * x / g.nx)
    v = long_wave + np.cos(2 * np.pi * x * (g.nx // 2) / g.nx)
    Lx = g.dx * g.nx
    got = post.smooth_field(g, v, lambda_stop=Lx / 4, lambda_pass=Lx / 2)
    _close(got, jpost.smooth_field(jg, v, Lx / 4, Lx / 2))
    np.testing.assert_allclose(got.numpy(), long_wave, atol=1e-10)
    # a transition-band wavelength is scaled, not removed or kept
    rng = np.random.default_rng(1)
    noise = rng.normal(size=SHAPE)
    _close(post.smooth_field(g, torch.as_tensor(noise), Lx / 6, Lx / 3),
           jpost.smooth_field(jg, noise, Lx / 6, Lx / 3))


@pytest.mark.parametrize("method", (0, 1))
@pytest.mark.parametrize("centered", ((False, True, True),
                                      (True, False, False),
                                      (False, False, False)))
def test_center_field_matches_jax(method, centered):
    g, jg = _grids()
    v = np.random.default_rng(2).normal(size=SHAPE)
    _close(post.center_field(g, v, centered, method),
           jpost.center_field(jg, v, centered, method))


def test_center_field_averaging():
    g, _ = _grids()
    x = np.arange(g.nx)
    v = np.broadcast_to(np.cos(2 * np.pi * (x + 0.5) / g.nx), SHAPE).copy()
    cv = post.center_field(g, v, centered=(False, True, True)).numpy()
    expect = 0.5 * (np.cos(2 * np.pi * (x + 0.5) / g.nx)
                    + np.cos(2 * np.pi * (x - 0.5) / g.nx))
    np.testing.assert_allclose(cv[0, 0], expect, atol=1e-12)
    cv2 = post.center_field(g, v, centered=(False, True, True),
                            method=1).numpy()
    np.testing.assert_allclose(cv2[0, 0], np.cos(2 * np.pi * x / g.nx),
                               atol=1e-10)


def test_poynting_flux_matches_jax():
    g, jg = _grids()
    rng = np.random.default_rng(3)
    f = [rng.normal(size=SHAPE) for _ in range(6)]
    got = post.poynting_flux(g, *f, mu0=2.0)
    want = jpost.poynting_flux(jg, *f, mu0=2.0)
    for t, j in zip(got[:3], want[:3]):
        _close(t, j)
    assert got[3].keys() == want[3].keys()
    for k in want[3]:
        _close(got[3][k], want[3][k], k)


def test_poynting_flux_uniform_cross_field():
    g, _ = _grids()
    zeros = np.zeros(SHAPE)
    sx, sy, sz, lines = post.poynting_flux(
        g, zeros, np.full(SHAPE, 2.0), zeros, zeros, zeros,
        np.full(SHAPE, 3.0))
    np.testing.assert_allclose(sx.numpy(), 6.0, atol=1e-12)
    np.testing.assert_allclose(sy.numpy(), 0.0, atol=1e-12)
    np.testing.assert_allclose(sz.numpy(), 0.0, atol=1e-12)
    np.testing.assert_allclose(lines["left"].numpy(), 6.0)
    assert lines["top"].shape == (g.nx,)
    assert lines["left"].shape == (g.nz,)


def test_owned_interior_strips_ghosts():
    g, jg = _grids()
    a = np.zeros((g.nzg, g.nyg, g.nxg))
    a[1:g.nz + 1, 1:g.ny + 1, 1:g.nx + 1] = 7.0
    got = post.owned_interior(torch.as_tensor(a), g)
    assert isinstance(got, torch.Tensor) and bool((got == 7.0).all())
    np.testing.assert_array_equal(got.numpy(), jpost.owned_interior(a, jg))
