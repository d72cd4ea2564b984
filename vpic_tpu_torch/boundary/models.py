"""Custom particle boundary handlers (``vpic_tpu/boundary/models.py``;
the reference's src/boundary/).

A handler is applied by the boundary rounds (``particles/boundary.py``)
to the compacted pending buffer, for every lane whose ``pc`` code
addresses it: ``pc = -(9 + handler_id*6 + face)``.

- :class:`MaxwellianReflux` (maxwellian_reflux.c:48-170): re-emit with a
  bi-Maxwellian flux distribution, the residual displacement rescaled by
  the aging ratio.  Its arithmetic is :func:`reflux_momenta`, a function
  of its three draws, so a test can feed it the JAX package's draws.
- :class:`AbsorbTally` (absorb_tally.c): absorb and count per species.
- :class:`LinkBoundary` (link.c:17-120): absorb and record each hit in a
  fixed-capacity ring that the host drains to ``link.<rank>`` text files
  (:func:`drain_link_file`).

Handler states are tensors on the state's device (``SimState.
boundary_state``); the draws come from the state's random state
(``core/random.py``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np
import torch

from ..core import random as rnd
from ..core.types import Grid, NEIGHBOR_CUSTOM_BASE
from ..particles.aux import accumulate_rhob
from ..particles.push import PC_EXHAUSTED

SQRT2 = math.sqrt(2.0)
TINY = float(np.float32(1e-38))


def handler_code(handler_id: int, face: int) -> int:
    return NEIGHBOR_CUSTOM_BASE - (handler_id * 6 + face)


def decode_handler(pc):
    """(handler_id, face) from pc codes (garbage for pc > -9)."""
    v = NEIGHBOR_CUSTOM_BASE - pc
    return v // 6, v % 6


class BoundaryHandler:
    """Base: subclasses define init_state() and apply()."""

    def init_state(self, n_species: int, device="cpu"):
        return torch.zeros((0,), dtype=torch.int32, device=device)

    def apply(self, key, b, mask, face, f, g: Grid, sid: int, hstate,
              step=None):
        """Apply the handler to the buffer lanes ``mask`` (``b``: dict of
        buffer columns, ``face``: each lane's face).  Returns (buffer,
        field state, handler state, lanes killed)."""
        raise NotImplementedError


def reflux_momenta(b, mask, face, g: Grid, ut_para: float, ut_perp: float,
                   mu, n1, n2):
    """The reflux of the lanes ``mask`` given their draws: ``mu`` uniform
    in (0, 1] and ``n1``, ``n2`` standard normal.  The parallel momentum is
    flux-weighted and points into the domain, the perpendicular ones are
    Gaussian; the remaining displacement keeps the lane's age
    (maxwellian_reflux.c:66-152; ``vpic_tpu/boundary/models.py:66-105`` in
    the same float32 operation order).  Returns the updated buffer."""
    utpa = float(np.float32(ut_para))
    utpe = float(np.float32(ut_perp))
    u0 = utpa * torch.sqrt(-torch.log(mu))
    u0 = u0 * torch.where(face < 3, SQRT2, -SQRT2)
    u1 = utpe * n1
    u2 = utpe * n2
    # (para, perp1, perp2) -> (ux, uy, uz) by the face's axis
    # (maxwellian_reflux.c:70-77): x (u0, u1, u2), y (u2, u0, u1),
    # z (u1, u2, u0)
    axis = face % 3
    pick = lambda a, b, c: torch.where(axis == 0, a,
                                       torch.where(axis == 1, b, c))
    ux, uy, uz = pick(u0, u2, u1), pick(u1, u0, u2), pick(u2, u1, u0)

    dpx = g.dx * b["mdx"]
    dpy = g.dy * b["mdy"]
    dpz = g.dz * b["mdz"]
    old_u2 = b["ux"] * b["ux"] + b["uy"] * b["uy"] + b["uz"] * b["uz"]
    new_u2 = ux * ux + uy * uy + uz * uz
    ratio = torch.sqrt(((1.0 + old_u2) * (dpx * dpx + dpy * dpy + dpz * dpz))
                       / ((1.0 + new_u2) * (TINY + old_u2)))
    return {**b,
            "ux": torch.where(mask, ux, b["ux"]),
            "uy": torch.where(mask, uy, b["uy"]),
            "uz": torch.where(mask, uz, b["uz"]),
            "mdx": torch.where(mask, ux * ratio * g.rdx, b["mdx"]),
            "mdy": torch.where(mask, uy * ratio * g.rdy, b["mdy"]),
            "mdz": torch.where(mask, uz * ratio * g.rdz, b["mdz"]),
            "pc": torch.where(mask, PC_EXHAUSTED, b["pc"])}


@dataclasses.dataclass(frozen=True)
class MaxwellianReflux(BoundaryHandler):
    """ut_para/ut_perp per species id (normalized thermal momenta)."""

    ut_para: Tuple[float, ...]
    ut_perp: Tuple[float, ...]

    def draws(self, key: int, n: int, device):
        """(mu, n1, n2) of n lanes from ``key``."""
        mu = rnd.uniform(rnd.fold(key, 0), n, TINY, 1.0, device)
        return (mu, rnd.normal(rnd.fold(key, 1), n, device),
                rnd.normal(rnd.fold(key, 2), n, device))

    def apply(self, key, b, mask, face, f, g: Grid, sid: int, hstate,
              step=None):
        q = b["q"]
        b = reflux_momenta(b, mask, face, g, self.ut_para[sid],
                           self.ut_perp[sid],
                           *self.draws(key, q.shape[0], q.device))
        return b, f, hstate, torch.zeros_like(mask)   # no kills


@dataclasses.dataclass(frozen=True)
class AbsorbTally(BoundaryHandler):
    """Absorb and count per species (absorb_tally.c)."""

    n_species: int

    def init_state(self, n_species: int, device="cpu"):
        return torch.zeros((self.n_species,), dtype=torch.int32,
                           device=device)

    def apply(self, key, b, mask, face, f, g: Grid, sid: int, hstate,
              step=None):
        f = accumulate_rhob(f, g, b["vox"], b["q"], b["dx"], b["dy"],
                            b["dz"], mask)
        hstate = hstate.clone()
        hstate[sid] += torch.sum(mask).to(torch.int32)
        return {**b, "pc": torch.where(mask, 0, b["pc"])}, f, hstate, mask


@dataclasses.dataclass(frozen=True)
class LinkBoundary(BoundaryHandler):
    """Absorb and record (step, voxel, q) of each absorbed lane in a ring
    of static capacity; the host drains it to ``link.<rank>`` text files
    (link.c:17-120)."""

    capacity: int = 4096

    def init_state(self, n_species: int, device="cpu"):
        z = lambda dt: torch.zeros((self.capacity,), dtype=dt, device=device)
        return dict(count=torch.zeros((), dtype=torch.int32, device=device),
                    vox=z(torch.int32), q=z(torch.float32),
                    step=z(torch.int32))

    def apply(self, key, b, mask, face, f, g: Grid, sid: int, hstate,
              step=None):
        f = accumulate_rhob(f, g, b["vox"], b["q"], b["dx"], b["dy"],
                            b["dz"], mask)
        cap = self.capacity
        hits = torch.cumsum(mask.to(torch.int32), 0)
        count = hstate["count"] + hits[-1]
        pos = hstate["count"] + hits - 1
        # the ring keeps the last ``cap`` hits: an earlier hit of this
        # round that a later one overwrites is not written, so every slot
        # is written once (the JAX package's scatter, last writer wins)
        keep = mask & (pos >= count - cap)
        slot = torch.where(keep, pos % cap, cap).long()
        step_v = (torch.zeros_like(b["vox"]) if step is None
                  else step.to(torch.int32).expand(b["vox"].shape))

        def put(ring, vals):
            out = torch.empty((cap + 1,), dtype=ring.dtype,
                              device=ring.device)
            out[:cap] = ring
            out[slot] = vals
            return out[:cap]

        hstate = dict(count=count, vox=put(hstate["vox"], b["vox"]),
                      q=put(hstate["q"], b["q"]),
                      step=put(hstate["step"], step_v))
        return {**b, "pc": torch.where(mask, 0, b["pc"])}, f, hstate, mask


def drain_link_file(hstate, fname):
    """Append the recorded absorptions as text, oldest first, one line
    ``step voxel q`` per hit (a wrapped ring drains in arrival order, as
    link.c appends per hit).  Returns the hit count."""
    count = int(hstate["count"])
    vox, q, step = (np.asarray(hstate[k].cpu() if isinstance(
        hstate[k], torch.Tensor) else hstate[k]) for k in ("vox", "q",
                                                           "step"))
    cap = vox.shape[0]
    n = min(count, cap)
    start = count - n          # absolute index of the oldest retained hit
    with open(fname, "a") as fh:
        for k in range(n):
            s = (start + k) % cap
            fh.write(f"{int(step[s])} {int(vox[s])} {float(q[s]):e}\n")
    return count
