"""Particle emission models (``vpic_tpu/emit/models.py``; the reference's
src/emitter/).

An emitter owns a static list of components, (voxel, face) pairs (the
reference packs them as ``cell<<5 | face``, emitter.h:21-24), and injects
particles each step after the push, before the user injection hook
(advance.cxx:83-84).  Every step claims a static block of
K = components * n_emit_per_face slots at ``np``; the slots of faces that
do not emit this step become zombies (``i = -1``, ``q = 0``) that the
next sort reclaims.  Emitted lanes carry ``pc = PC_EXHAUSTED`` and their
aging displacement, so the step's boundary rounds walk them (and deposit
their current) in the same step.

- :class:`ChildLangmuir` (child-langmuir.c): space-charge-limited
  emission; per emitting face m particles of charge
  qp = eps0 dA dt sqrt((32/81) |q_m| E^3 / dX) / m.
- :class:`Ccube`, :class:`Ivory` (ccube.c, ivory.c): the same with other
  charge laws and an |E_n| threshold.

The component scans (:func:`region_surface_components`,
:func:`region_volume_components`, :func:`domain_face_components`) are the
port's own numpy copies of the JAX package's.  The draws come from the
state's random state (``core/random.py``), split as the JAX emitter
splits it; the emitted charge leaves rhob
through the fixed-point ``aux.accumulate_rhob``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core import random as rnd
from ..core.types import FACE_AXIS, FACE_DIR, Grid, IP
from ..particles.aux import accumulate_rhob
from ..particles.boundary import claim_block, scatter_into
from ..particles.push import PC_EXHAUSTED


def _cell_centers(g: Grid, origin=(0.0, 0.0, 0.0)):
    """(nz, ny, nx) meshgrids of the owned cells' centers (the
    _xc/_yc/_zc probes of deck_wrapper.cxx:346-463)."""
    xs = origin[0] + g.dx * (np.arange(1, g.nx + 1) - 0.5)
    ys = origin[1] + g.dy * (np.arange(1, g.ny + 1) - 0.5)
    zs = origin[2] + g.dz * (np.arange(1, g.nz + 1) - 0.5)
    Z, Y, X = np.meshgrid(zs, ys, xs, indexing="ij")
    return X, Y, Z


def _cell_vox(g: Grid):
    zi, yi, xi = np.meshgrid(np.arange(1, g.nz + 1), np.arange(1, g.ny + 1),
                             np.arange(1, g.nx + 1), indexing="ij")
    return (xi + g.nxg * (yi + g.nyg * zi)).astype(np.int32)


def region_surface_components(g: Grid, region_fn, origin=None):
    """The faces of exterior cells that touch the region (the
    define_surface_emitter scan, deck_wrapper.cxx:390-463): a surface
    emitter emits into the exterior of ``region_fn(x, y, z)``.  The region
    is probed at the neighbor cell's center, ghost positions included.
    Returns (vox, face) int32 arrays."""
    if origin is None:
        origin = (g.gx0, g.gy0, g.gz0)
    X, Y, Z = _cell_centers(g, origin)
    inside = np.asarray(region_fn(X, Y, Z), bool)
    vox = _cell_vox(g)
    voxes, faces = [], []
    for face in range(6):
        ax, d = FACE_AXIS[face], FACE_DIR[face]
        off = (d * g.dx if ax == 0 else 0.0,
               d * g.dy if ax == 1 else 0.0,
               d * g.dz if ax == 2 else 0.0)
        neigh = np.asarray(region_fn(X + off[0], Y + off[1], Z + off[2]),
                           bool)
        sel = (~inside) & neigh
        voxes.append(vox[sel])
        faces.append(np.full(int(sel.sum()), face, np.int32))
    return (np.concatenate(voxes).astype(np.int32),
            np.concatenate(faces).astype(np.int32))


def region_volume_components(g: Grid, region_fn, origin=None):
    """The cells inside the region as face-less components (face = -1),
    the define_volume_emitter scan (deck_wrapper.cxx:346-383): the face
    laws skip them, as the reference's non-face switch branch does."""
    if origin is None:
        origin = (g.gx0, g.gy0, g.gz0)
    X, Y, Z = _cell_centers(g, origin)
    inside = np.asarray(region_fn(X, Y, Z), bool)
    vox = _cell_vox(g)[inside]
    return vox.astype(np.int32), np.full(vox.shape[0], -1, np.int32)


def domain_face_components(g: Grid, face: int) -> np.ndarray:
    """The voxels of every owned cell whose ``face`` lies on the domain
    boundary (deck_wrapper.cxx:346-463)."""
    ax = FACE_AXIS[face]
    dims = (g.nx, g.ny, g.nz)
    ranges = [np.arange(1, d + 1) for d in dims]
    ranges[ax] = np.array([1 if FACE_DIR[face] < 0 else dims[ax]])
    X, Y, Z = np.meshgrid(*ranges, indexing="ij")
    return (X + g.nxg * (Y + g.nyg * Z)).reshape(-1).astype(np.int32)


@dataclasses.dataclass(frozen=True)
class ChildLangmuir:
    """Space-charge-limited surface emission (child-langmuir.c:49-51): per
    emitting face m particles, each of charge
    qp = eps0 dA dt sqrt(LAW_FACTOR |q_m E_n^3| / dX) / m.  Subclasses
    change LAW_FACTOR and may gate on ``thresh_e_norm`` (ccube.c:48-52,
    ivory.c:48-52)."""

    LAW_FACTOR = 32.0 / 81.0
    USE_THRESH = False

    sid: int                    # species index
    q_m: float
    components: tuple           # (vox tuple, face tuple)
    n_emit_per_face: int = 1
    ut_para: float = 0.0
    ut_perp: float = 0.0
    thresh_e_norm: float = 0.0  # |E_n| emission threshold (ccube/ivory)

    def bind(self, g: Grid):
        object.__setattr__(self, "grid", g)
        return self

    def _components(self, device):
        """The component voxels and faces as int64 tensors on ``device``
        (made once per device)."""
        cache = self.__dict__.setdefault("_on", {})
        if device not in cache:
            cache[device] = tuple(
                torch.as_tensor(np.asarray(c, np.int64).reshape(-1),
                                device=device) for c in self.components)
        return cache[device]

    def emits(self, e_norm, face):
        """Which components emit: the normal field drives this species off
        the surface, the component has a face, and (Ccube, Ivory) |E_n|
        reaches the threshold."""
        sign = torch.where(face < 3, 1.0, -1.0)
        ok = ((self.q_m * sign * e_norm) > 0) & (face >= 0)
        if self.USE_THRESH:
            ok = ok & (e_norm.abs() >= float(np.float32(self.thresh_e_norm)))
        return ok

    def charge(self, g: Grid, e_norm, axis):
        """The charge law per component, in the JAX package's float32
        operation order."""
        d = [float(np.float32(v)) for v in (g.dx, g.dy, g.dz)]
        of = lambda a: torch.where(a == 0, d[0], torch.where(a == 1, d[1],
                                                             d[2]))
        dA = of((axis + 1) % 3) * of((axis + 2) % 3)
        e3 = (e_norm * e_norm) * e_norm
        qp = (g.eps0 * dA * g.dt
              * torch.sqrt(float(np.float32(self.LAW_FACTOR))
                           * torch.abs(self.q_m * e3) / of(axis))
              / self.n_emit_per_face)
        return -qp if self.q_m < 0 else qp

    def __call__(self, state, acc, f):
        """Emit one step's lanes into the species' columns in place: the
        step owns them (``particles/boundary.py:owned``)."""
        g = self.grid
        vox, face = self._components(state.interpolator.device)
        m = self.n_emit_per_face
        K = vox.shape[0] * m
        rng, sub = rnd.split(state.rng)
        state = dataclasses.replace(state, rng=rng)
        sp = state.species[self.sid]

        ip = state.interpolator[vox]
        axis = face % 3
        e_norm = torch.where(axis == 0, ip[:, IP["ex"]],
                             torch.where(axis == 1, ip[:, IP["ey"]],
                                         ip[:, IP["ez"]]))
        emits = self.emits(e_norm, face)
        qp = self.charge(g, e_norm, axis)

        # per component -> per particle
        rep = lambda a: a[:, None].expand(-1, m).reshape(-1)
        vox_p, face_p, axis_p = rep(vox), rep(face), rep(axis)
        emits_p, qp_p = rep(emits), rep(qp)
        sign_p = torch.where(face_p < 3, 1.0, -1.0)

        ks = rnd.split(sub, 6)
        t1 = rnd.uniform(ks[0], K, -1.0, 1.0)
        t2 = rnd.uniform(ks[1], K, -1.0, 1.0)
        upar = sign_p * torch.abs(self.ut_para * rnd.normal(ks[2], K))
        up1 = self.ut_perp * rnd.normal(ks[3], K)
        up2 = self.ut_perp * rnd.normal(ks[4], K)
        age = rnd.uniform(ks[5], K)

        # (normal, t1, t2) onto (x, y, z) by the face's cyclic frame
        def pick(a, b, c):
            return torch.where(axis_p == 0, a,
                               torch.where(axis_p == 1, b, c))

        posn = -sign_p     # on the emitting face
        dx, dy, dz = pick(posn, t2, t1), pick(t1, posn, t2), pick(t2, t1,
                                                                  posn)
        ux, uy, uz = pick(upar, up2, up1), pick(up1, upar, up2), pick(
            up2, up1, upar)

        # the K-block of slots at np; emitted lanes past max_np are
        # dropped and counted in nm
        idx, fits, ok, sp = claim_block(sp, emits_p)

        # the emitted charge leaves the surface: rhob takes -qp
        f = accumulate_rhob(f, g, vox_p, -qp_p, dx, dy, dz, ok)

        gamma = torch.sqrt(ux * ux + uy * uy + uz * uz + 1.0)
        aging = age * g.cvac * g.dt / gamma
        for c, vals in (("dx", dx), ("dy", dy), ("dz", dz),
                        ("i", torch.where(ok, vox_p, -1)),
                        ("ux", ux), ("uy", uy), ("uz", uz),
                        ("q", torch.where(ok, qp_p, 0.0)),
                        ("mdx", ux * aging * g.rdx),
                        ("mdy", uy * aging * g.rdy),
                        ("mdz", uz * aging * g.rdz),
                        ("pc", torch.where(ok, PC_EXHAUSTED, 0))):
            scatter_into(getattr(sp, c), idx, fits, vals)
        species = list(state.species)
        species[self.sid] = sp
        return dataclasses.replace(state, species=tuple(species)), acc, f


@dataclasses.dataclass(frozen=True)
class Ccube(ChildLangmuir):
    """The ccube law (ccube.c:50-52): the Child-Langmuir law without the
    32/81 factor, gated on |E_n| >= thresh_e_norm (ccube.c:48)."""

    LAW_FACTOR = 1.0
    USE_THRESH = True


@dataclasses.dataclass(frozen=True)
class Ivory(ChildLangmuir):
    """The ivory law (ivory.c:50-52): the Child-Langmuir law with a
    sqrt(1/6) factor, gated on |E_n| >= thresh_e_norm (ivory.c:48)."""

    LAW_FACTOR = 1.0 / 6.0
    USE_THRESH = True
