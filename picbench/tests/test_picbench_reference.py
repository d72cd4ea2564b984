"""The plain reference (``picbench/reference/pic.py``, vector form on a
periodic mesh) against the scalar float64 transcription of the reference
kernels (``picbench/reference/loop_ref.py``, a frozen copy of
``tests/ref/ref_impl.py``) on small random states: the interpolator, the
push with its walk and current, the current's unload, the field advance
and the charge deposit."""

import numpy as np
import pytest
import torch

from picbench.reference import loop_ref as L
from picbench.reference import pic
from picbench.reference import walls as W

SHAPES = [(4, 3, 5), (6, 5, 1)]


def setup(n, seed=0):
    nx, ny, nz = n
    lx, ly, lz = 1.0, 0.8, 1.3
    box = pic.Box(n=n, lo=(0.0, 0.0, 0.0), hi=(lx, ly, lz),
                  dt=0.5 * pic.courant_length((lx, ly, lz), n))
    g = L.G(nx, ny, nz, lx, ly, lz, dt=box.dt)
    rng = np.random.default_rng(seed)
    per = {c: rng.normal(0, 1, (nz, ny, nx))
           for c in pic.E + pic.B + pic.J}
    return box, g, per, rng


def ghosted(per, g):
    f = L.zero_fields(g)
    f.update({c: np.pad(v, 1, mode="wrap") for c, v in per.items()})
    return f


def fold(a, n):
    """A ghosted array's planes 1..n, each axis' plane n+1 added into its
    plane 1 (the periodic seam's shared planes)."""
    nx, ny, nz = n
    a = a[1:nz + 2, 1:ny + 2, 1:nx + 2].copy()
    for ax, k in ((0, nz), (1, ny), (2, nx)):
        last = np.take(a, [k], axis=ax)
        a = np.take(a, range(k), axis=ax)
        idx = [slice(None)] * 3
        idx[ax] = slice(0, 1)
        a[tuple(idx)] += last
    return a


def T(per):
    return {c: torch.as_tensor(v) for c, v in per.items()}


def interior(a, n):
    nx, ny, nz = n
    return a[1:nz + 1, 1:ny + 1, 1:nx + 1]


@pytest.mark.parametrize("n", SHAPES)
def test_interpolator(n):
    box, g, per, _ = setup(n)
    ip_loop = L.load_interpolator(ghosted(per, g), g)
    ip = pic.interpolator(T(per), box).numpy()
    nx, ny, nz = n
    z, y, x = np.meshgrid(range(nz), range(ny), range(nx), indexing="ij")
    vox = g.voxel(x + 1, y + 1, z + 1).reshape(-1)
    np.testing.assert_allclose(ip, ip_loop[vox], rtol=0, atol=1e-13)


@pytest.mark.parametrize("n", SHAPES)
def test_push_walk_and_current(n):
    box, g, per, rng = setup(n, 1)
    per = {c: 0.3 * v for c, v in per.items()}
    ip_loop = L.load_interpolator(ghosted(per, g), g)
    m = 400
    cell = np.stack([rng.integers(0, k, m) for k in n])
    off = rng.uniform(-1, 1, (3, m))
    u = rng.normal(0, 0.6, (3, m))
    q = rng.uniform(0.5, 1.5, m)
    p = dict(dx=off[0].copy(), dy=off[1].copy(), dz=off[2].copy(),
             i=g.voxel(cell[0] + 1, cell[1] + 1, cell[2] + 1),
             ux=u[0].copy(), uy=u[1].copy(), uz=u[2].copy(), q=q)
    a = np.zeros((g.nv, 12))
    L.advance_p(p, -1.5, ip_loop, a, g)
    acc = torch.zeros((box.cells, 12), dtype=torch.float64)
    sp = pic.push(dict(q_m=-1.5, cell=torch.as_tensor(cell),
                       off=torch.as_tensor(off), u=torch.as_tensor(u),
                       q=torch.as_tensor(q)),
                  pic.interpolator(T(per), box), box, acc)
    vox = g.voxel(sp["cell"][0] + 1, sp["cell"][1] + 1,
                  sp["cell"][2] + 1).numpy()
    assert (vox != g.voxel(cell[0] + 1, cell[1] + 1, cell[2] + 1)).any()
    np.testing.assert_array_equal(vox, p["i"])
    for k, c in enumerate(("dx", "dy", "dz")):
        np.testing.assert_allclose(sp["off"][k], p[c], atol=1e-12)
    for k, c in enumerate(("ux", "uy", "uz")):
        np.testing.assert_allclose(sp["u"][k], p[c], atol=1e-12)
    nx, ny, nz = n
    z, y, x = np.meshgrid(range(nz), range(ny), range(nx), indexing="ij")
    np.testing.assert_allclose(
        acc.numpy(), a[g.voxel(x + 1, y + 1, z + 1).reshape(-1)], atol=1e-12)


@pytest.mark.parametrize("n", SHAPES)
def test_unload(n):
    box, g, _, rng = setup(n, 2)
    acc = rng.normal(0, 1, (box.cells, 12))
    a = np.zeros((g.nv, 12))
    nx, ny, nz = n
    z, y, x = np.meshgrid(range(nz), range(ny), range(nx), indexing="ij")
    a[g.voxel(x + 1, y + 1, z + 1).reshape(-1)] = acc
    f = L.zero_fields(g)
    L.unload_accumulator(f, a, g)
    got = pic.unload(torch.as_tensor(acc), box)
    for c in pic.J:
        np.testing.assert_allclose(got[c].numpy(), fold(f[c], n),
                                   atol=1e-10)


@pytest.mark.parametrize("n", SHAPES)
def test_field_advance(n):
    box, g, per, _ = setup(n, 3)
    f = ghosted(per, g)
    L.advance_b(f, g, 0.5)
    F = pic.advance_b(T(per), box, 0.5)
    for c in pic.B:
        np.testing.assert_allclose(F[c].numpy(), interior(f[c], n),
                                   atol=1e-12)
    f = ghosted({c: v.numpy() for c, v in F.items()}, g)
    L.advance_e_vacuum(f, g)
    F = pic.advance_e(F, box)
    for c in pic.E:
        np.testing.assert_allclose(F[c].numpy(), interior(f[c], n),
                                   atol=1e-12)


@pytest.mark.parametrize("n", SHAPES)
def test_charge(n):
    box, g, _, rng = setup(n, 4)
    m = 300
    cell = np.stack([rng.integers(0, k, m) for k in n])
    off = rng.uniform(-1, 1, (3, m))
    q = rng.normal(0, 1, m)
    f = L.zero_fields(g)
    L.accumulate_rho_p(f, dict(dx=off[0], dy=off[1], dz=off[2], q=q,
                               i=g.voxel(cell[0] + 1, cell[1] + 1,
                                         cell[2] + 1)), g)
    got = pic.rho([dict(cell=torch.as_tensor(cell),
                        off=torch.as_tensor(off), q=torch.as_tensor(q))],
                  box, torch.float64)
    np.testing.assert_allclose(got.numpy(), fold(f["rhof"], n), atol=1e-10)


def test_sample_averages_the_seam():
    box = pic.Box(n=(4, 2, 1), lo=(0.0, 0.0, 0.0), hi=(1.0, 1.0, 1.0),
                  dt=0.1)
    # cbx lies on the x nodes: x = 0 and x = 1 share a plane
    v = pic.sample(lambda x, y, z: x + 0 * y, "cbx", box)
    assert v.shape == (1, 2, 4)
    np.testing.assert_allclose(v[0, 0], [0.5, 0.25, 0.5, 0.75])
    # ey lies on the x and z nodes, at the y cell centres
    v = pic.sample(lambda x, y, z: y + 0 * x, "ey", box)
    np.testing.assert_allclose(v[0, :, 0], [0.25, 0.75])


# -- the reference with conducting, reflecting walls (reference/walls.py) --

def walls_box(n=(4, 4, 4), walls=(False, False, True), dt_frac=0.5):
    lengths = (1.0, 0.8, 1.3)
    return W.Box(n=n, lo=(0.0, -0.4, -0.65), hi=(1.0, 0.4, 0.65),
                 dt=dt_frac * pic.courant_length(lengths, n), walls=walls)


def test_a_lane_that_reaches_a_wall_comes_back_mirrored():
    box = walls_box()
    nz = box.n[2]
    # one lane near the top wall moving up: 0.2 of offset to the face, 0.1
    # back from it
    cell = torch.tensor([[1], [2], [nz - 1]])
    off = torch.tensor([[0.1], [-0.3], [0.8]], dtype=torch.float64)
    rd, cdt = box.rd, box.cvac * box.dt
    want = torch.tensor([0.05, 0.0, 0.15], dtype=torch.float64)
    g = 1 / torch.sqrt(1 - (want / torch.tensor([cdt * r for r in rd],
                                                 dtype=torch.float64)).pow(2)
                       .sum())
    u = (want / torch.tensor([cdt * r for r in rd], dtype=torch.float64)
         * g)[:, None]
    q = torch.tensor([0.7], dtype=torch.float64)
    sp = dict(q_m=0.0, cell=cell, off=off, u=u, q=q)
    F = {c: torch.zeros(W.shape(c, box), dtype=torch.float64)
         for c in pic.E + pic.B}
    acc = torch.zeros((box.cells, 12), dtype=torch.float64)
    out = W.push(sp, W.interpolator(F, box), box, acc)
    assert out["cell"].tolist() == cell.tolist()
    torch.testing.assert_close(out["off"][:, 0], torch.tensor(
        [0.1 + 2 * 0.05, -0.3, 2 - (0.8 + 2 * 0.15)], dtype=torch.float64))
    torch.testing.assert_close(out["u"][:, 0], u[:, 0] * torch.tensor(
        [1.0, 1.0, -1.0], dtype=torch.float64))
    # the current stays in the lane's cell: 0.1 of a cell up, 0.05 down
    only = W.flat(box, cell)[0]
    assert int((acc.abs().sum(1) > 0).sum()) == 1 and acc[only].abs().sum()
    torch.testing.assert_close(acc[only, 8:12].sum(),
                               4 * q[0] * (0.1 - 0.05))
    # the periodic box takes the same lane through the face into z = 0
    acc_p = torch.zeros((box.cells, 12), dtype=torch.float64)
    out_p = pic.push(sp, pic.interpolator(
        {c: torch.zeros(box.n[::-1], dtype=torch.float64)
         for c in pic.E + pic.B}, box), box, acc_p)
    assert int(out_p["cell"][2, 0]) == 0
    assert acc_p[pic.flat(box, out_p["cell"])[0]].abs().sum() > 0
    J = W.unload(acc, box)
    for c in ("jfx", "jfy"):
        assert not J[c][0].any() and not J[c][-1].any()


def trecon_state(n=(8, 4, 8), ppc=8, seed=11):
    from picbench import spec
    from picbench.configs import trecon
    cfg = dict(spec.workload("trecon.steps")["config"], nx=n[0], ny=n[1],
               nz=n[2], ppc=ppc)
    box = trecon.box(cfg)
    F, S = W.initial_state(trecon.inputs(cfg, seed, box), box,
                           torch.float64, "cpu")
    return cfg, box, F, S


def _wall_planes(v):
    return v[0], v[-1]


@pytest.fixture(scope="module")
def twenty_steps():
    cfg, box, F, S = trecon_state()
    states = [(F, S)]
    for t in range(20):
        F, S = W.step(F, S, box, t, {"div_e": 10, "div_b": 10})
        states.append((F, S))
    return box, states


def test_tangential_e_and_j_stay_zero_on_both_walls(twenty_steps):
    box, states = twenty_steps
    hit = 0
    for (F, S), (_, S1) in zip(states, states[1:] + states[-1:]):
        for c in ("ex", "ey", "jfx", "jfy"):
            assert F[c].shape[0] == box.n[2] + 1
            for plane in _wall_planes(F[c]):
                assert not plane.any(), c
        # electrons in a wall cell whose uz turned
        for a, b in zip(S[:2], S1[:2]):
            at = (b["cell"][2] == 0) | (b["cell"][2] == box.n[2] - 1)
            hit += int((at & (a["u"][2] * b["u"][2] < 0)).sum())
    # the interior is not zero, and lanes met the walls
    assert states[-1][0]["ex"][1:-1].abs().max() > 0 and hit > 0


def test_walls_keep_gauss_at_rounding(twenty_steps):
    box, states = twenty_steps
    rhob = states[0][0]["rhob"]
    scale = float(W.rho(states[0][1][:1], box, torch.float64).abs().max())
    for F, S in states:
        err = W.div_e(F, box) - (W.rho(S, box, torch.float64) + rhob)
        assert float(err.abs().max()) <= 1e-11 * scale


def test_walls_keep_the_particles_inside(twenty_steps):
    box, states = twenty_steps
    F0, S0 = states[0]
    F, S = states[-1]
    for a, b in zip(S0, S):
        assert a["q"].shape == b["q"].shape
        assert int(b["cell"][2].min()) >= 0
        assert int(b["cell"][2].max()) < box.n[2]
        assert float(b["off"].abs().max()) <= 1.0


@pytest.mark.parametrize("n", SHAPES)
def test_walls_without_walls_is_the_periodic_step(n):
    box, _, per, rng = setup(n, 5)
    wbox = W.Box(n=box.n, lo=box.lo, hi=box.hi, dt=box.dt,
                 walls=(False, False, False))
    F = {c: 0.2 * v for c, v in T(per).items()}
    F["rhob"] = torch.as_tensor(rng.normal(0, 0.1, n[::-1]))
    m = 500
    sp = [dict(name="s", q_m=-1.3,
               cell=torch.as_tensor(np.stack([rng.integers(0, k, m)
                                              for k in n])),
               off=torch.as_tensor(rng.uniform(-1, 1, (3, m))),
               u=torch.as_tensor(rng.normal(0, 0.5, (3, m))),
               q=torch.as_tensor(rng.uniform(0.5, 1.5, m)))]
    Fp, Sp, Fw, Sw = F, sp, F, sp
    for t in range(3):
        Fp, Sp = pic.step(Fp, Sp, box, t, {"div_e": 2, "div_b": 2})
        Fw, Sw = W.step(Fw, Sw, wbox, t, {"div_e": 2, "div_b": 2})
    for c in Fp:
        torch.testing.assert_close(Fw[c], Fp[c], rtol=0, atol=1e-12)
    for k in ("cell", "off", "u"):
        torch.testing.assert_close(Sw[0][k], Sp[0][k], rtol=0, atol=1e-12)


def test_away_from_the_walls_a_step_is_the_periodic_step():
    """Lanes and fields kept off the walls: the walled step and the
    periodic one agree in the interior."""
    box = walls_box(n=(4, 4, 12), dt_frac=0.3)
    pbox = pic.Box(n=box.n, lo=box.lo, hi=box.hi, dt=box.dt)
    rng = np.random.default_rng(6)
    m = 400
    cell = np.stack([rng.integers(0, 4, m), rng.integers(0, 4, m),
                     rng.integers(5, 7, m)])
    sp = [dict(name="s", q_m=-1.0, cell=torch.as_tensor(cell),
               off=torch.as_tensor(rng.uniform(-1, 1, (3, m))),
               u=torch.as_tensor(rng.normal(0, 0.3, (3, m))),
               q=torch.as_tensor(rng.uniform(0.5, 1.5, m)))]
    Fw = {c: torch.zeros(W.shape(c, box), dtype=torch.float64)
          for c in pic.E + pic.B + pic.J + ("rhob",)}
    Fp = {c: torch.zeros(box.n[::-1], dtype=torch.float64)
          for c in Fw}
    Fw["cbz"] += 0.3
    Fp["cbz"] += 0.3
    Sw, Sp = sp, sp
    for t in range(2):
        Fw, Sw = W.step(Fw, Sw, box, t, {})
        Fp, Sp = pic.step(Fp, Sp, pbox, t, {})
    for k in ("cell", "off", "u"):
        torch.testing.assert_close(Sw[0][k], Sp[0][k], rtol=0, atol=1e-13)
    for c in pic.E + pic.B + pic.J:
        torch.testing.assert_close(Fw[c][2:10], Fp[c][2:10], rtol=0,
                                   atol=1e-13)


def _face_lane(off_z, uz, dtype, box):
    """One lane of the top wall's cell pushed through zero fields."""
    sp = dict(name="s", q_m=0.0,
              cell=torch.tensor([[1], [2], [box.n[2] - 1]]),
              off=torch.tensor([[0.1], [-0.3], [off_z]], dtype=dtype),
              u=torch.tensor([[0.0], [0.0], [uz]], dtype=dtype),
              q=torch.tensor([0.7], dtype=dtype))
    F = {c: torch.zeros(W.shape(c, box), dtype=dtype) for c in pic.E + pic.B}
    acc = torch.zeros((box.cells, 12), dtype=dtype)
    return W.push(sp, W.interpolator(F, box), box, acc)


def test_a_reflection_that_rounding_decides_reads_alike(monkeypatch):
    """A streak that ends on a wall's face within rounding reflects in one
    float type and not in the other: the lanes' normal momenta differ in
    sign, and the moments of the lanes as ``settled`` reads them agree; so
    do two readings of a lane a rounding apart where the turn ends.  A lane
    that missed its reflection away from the face still reads apart."""
    from picbench import compare
    box = walls_box()
    found = None
    for uz in np.linspace(0.2, 0.9, 60).astype(np.float32):
        d = float(_face_lane(0.0, float(uz), torch.float64, box)["off"][2, 0])
        p = float(np.float32(1.0 - d))
        a = _face_lane(p, float(uz), torch.float32, box)
        b = _face_lane(p, float(uz), torch.float64, box)
        if (a["u"][2, 0] > 0) != (b["u"][2, 0] > 0):
            found = compare.as64([a])[0], b
            break
    assert found is not None
    a, b = found
    assert float((a["off"][2] - b["off"][2]).abs().max()) < 1e-6
    assert compare.moment_gap([a], [b], box, W) < 1e-3

    # among 400 lanes of the box, which set the moments' scale
    rng = np.random.default_rng(3)
    crowd = dict(cell=torch.as_tensor(np.stack([rng.integers(0, k, 400)
                                                for k in box.n])),
                 off=torch.as_tensor(rng.uniform(-0.9, 0.9, (3, 400))),
                 u=torch.as_tensor(rng.normal(0, 0.3, (3, 400))),
                 q=torch.ones(400, dtype=torch.float64))

    def at(dist, sign):
        off = a["off"].clone()
        off[2] = 1 - dist
        return dict(a, **{k: torch.cat([crowd[k], v], -1) for k, v in
                          dict(cell=a["cell"], off=off, q=a["q"],
                               u=a["u"].abs() * sign).items()})

    for dist in (0.0, 0.5 * W.FACE, W.FACE):
        assert compare.moment_gap([at(dist, 1)], [at(dist + 1e-9, 1)], box,
                                  W) < 1e-5
    assert compare.moment_gap([at(1e-9, 1)], [at(0.0, -1)], box, W) < 1e-5
    assert compare.moment_gap([at(0.3, 1)], [at(0.3, -1)], box, W) > 0.1
    monkeypatch.setattr(W, "settled", lambda sp, box: sp)
    assert compare.moment_gap([a], [b], box, W) > 1
