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
