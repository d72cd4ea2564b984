"""In-step particle injection (``vpic_tpu/deck/inject.py``; the
reference's ``inject_particle``, misc.cxx:16-106, called every step from
``begin_particle_injection``).

An :class:`Injector`, built once per species by
``Simulation.make_injector``, places global float64 coordinates in
(voxel, cell offset) form, claims a static block of K slots at ``np``,
optionally deposits ``-q`` into rhob (misc.cxx:92-96), and hands aged
lanes (misc.cxx:98-105) to the step's boundary rounds through the mover
columns (``mdx..`` and ``pc = PC_EXHAUSTED``), as the emitters do: the
aged partial push deposits current and meets the walls as ``move_p``
does.

    inj = sim.make_injector("electron")

    def refill(state, acc, f):
        return inj(state, acc, f, x=..., y=..., z=..., ux=..., uy=...,
                   uz=..., q=..., age=..., update_rhob=True)

    sim.finalize(user_particle_injection=refill)

Every argument is an array (numpy or a tensor) of one common length K, or
a scalar; ``valid`` masks lanes off (a masked lane costs a zombie slot
that the next sort reclaims).  On a sharded deck every shard calls the
hook with the same global coordinates and keeps the lanes it owns: the
step binds its shard's comm around the hook (``comm.facecomm.bound``)
and the injector takes its shard's box from it, as the JAX package's
takes it from ``lax.axis_index``; called anywhere else on a sharded grid
it raises.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..comm import facecomm
from ..core.types import PERIODIC_FIELDS, Grid
from ..grid.partition import shard_origin
from ..particles.aux import accumulate_rhob
from ..particles.boundary import claim_block, scatter_into
from ..particles.push import PC_EXHAUSTED


def _cellify(c, c0: float, c1: float, n: int):
    """Global float64 coordinate -> (cell offset in [-1, 1] as float32,
    1-based cell index): the placement of misc.cxx:53-77 with its far-wall
    rule (c == c1 lands in cell n at offset 1)."""
    t = n * ((c - c0) / (c1 - c0))
    ic = torch.floor(t).to(torch.int32)
    t = t - ic
    t = (t + t) - 1.0
    far = ic == n
    t = torch.where(far, 1.0, t)
    ic = torch.where(far, n - 1, ic) + 1
    return t.to(torch.float32), ic


@dataclasses.dataclass(frozen=True)
class Injector:
    """In-step particle injector for one species (misc.cxx:16-106)."""

    sid: int
    g: Grid

    def __call__(self, state, acc, f, x, y, z, ux, uy, uz, q, age=None,
                 tag=None, valid=None, update_rhob=True):
        """Inject K lanes into the species' columns in place: the step
        owns them when it calls the injection hook
        (``particles/boundary.py:owned``; the tags too)."""
        g = self.g
        sp = state.species[self.sid]
        dev = sp.dx.device
        x = torch.atleast_1d(torch.as_tensor(x, dtype=torch.float64,
                                             device=dev))
        K = x.shape[0]

        def arr(v, dt=torch.float64):
            # a number is filled on the device: no host copy, so that a
            # CUDA graph can capture the hook
            if isinstance(v, (bool, int, float)):
                return torch.full((K,), v, dtype=dt, device=dev)
            return torch.as_tensor(v, dtype=dt, device=dev).expand(K)

        y, z = arr(y), arr(z)
        uxf, uyf, uzf, qf = (arr(v, torch.float32) for v in (ux, uy, uz, q))
        ok = (torch.ones((K,), dtype=torch.bool, device=dev)
              if valid is None else arr(valid, torch.bool))

        # this shard's box (partition_periodic_box's layout)
        comm = facecomm.current()
        if comm is None and g.is_multishard:
            raise RuntimeError("on a sharded grid the injector runs inside "
                               "the step's user_particle_injection hook, "
                               "which gives it its shard")
        shard = (0, 0, 0) if comm is None else comm.shard
        shards = (g.gpx, g.gpy, g.gpz)
        lo = shard_origin(g, shard)
        hi = tuple(o + (b - a) / p for o, a, b, p in zip(
            lo, (g.gx0, g.gy0, g.gz0), (g.gx1, g.gy1, g.gz1), shards))

        # ownership: inside, or on the high wall where that face is a local
        # boundary (the far-wall rule, misc.cxx:38-40), on the last shard
        # of the axis
        def own(a, c):
            inside = (c >= lo[a]) & (c < hi[a])
            far = (shard[a] == shards[a] - 1
                   and g.fbc[3 + a] != PERIODIC_FIELDS)
            return inside | ((c == hi[a]) & far)

        ok = ok & own(0, x) & own(1, y) & own(2, z)
        dx, ix = _cellify(x, lo[0], hi[0], g.nx)
        dy, iy = _cellify(y, lo[1], hi[1], g.ny)
        dz, iz = _cellify(z, lo[2], hi[2], g.nz)
        vox = ix + g.nxg * (iy + g.nyg * iz)

        # the static slot block at np; masked-off lanes become zombies,
        # lanes past max_np are dropped and counted in nm
        idx, fits, okc, sp = claim_block(sp, ok)

        if update_rhob:
            # injected charge deposits -q into rhob (misc.cxx:92-96)
            f = accumulate_rhob(f, g, torch.clamp(vox, min=0), -qf, dx, dy,
                                dz, okc)

        # aging (misc.cxx:98-105): the mover columns hand the partial push
        # to the step's boundary rounds
        if age is None:
            md = (torch.zeros((K,), dtype=torch.float32, device=dev),) * 3
            pc = torch.zeros((K,), dtype=torch.int32, device=dev)
        else:
            agef = arr(age, torch.float32)
            gamma = torch.sqrt(uxf * uxf + uyf * uyf + uzf * uzf + 1.0)
            aging = agef * float(np.float32(g.cvac * g.dt)) / gamma
            md = tuple(u * aging * float(np.float32(r)) for u, r in
                       ((uxf, g.rdx), (uyf, g.rdy), (uzf, g.rdz)))
            pc = torch.where(okc & (agef != 0), PC_EXHAUSTED, 0)

        cols = dict(dx=dx, dy=dy, dz=dz, i=torch.where(okc, vox, -1),
                    ux=uxf, uy=uyf, uz=uzf, q=torch.where(okc, qf, 0.0),
                    mdx=md[0], mdy=md[1], mdz=md[2], pc=pc)
        if tag is not None:
            cols["tag"] = arr(tag, torch.int32)
        for c, vals in cols.items():
            scatter_into(getattr(sp, c), idx, fits, vals)
        species = list(state.species)
        species[self.sid] = sp
        return dataclasses.replace(state, species=tuple(species)), acc, f
