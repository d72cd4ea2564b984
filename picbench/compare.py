"""The numbers that decide ``correct``: each a widest gap between what the
program (or a control in its place) produced and what the plain reference
works out, scaled by the reference's own size, and the books.

- ``start_pos``, ``start_u``, ``start_fields``: the state after set-up
  against the reference's initialization from the deck's inputs: each
  particle's position (in cells) and momentum (over its species' rms), lane
  by lane in the order the deck injected them; E and cB.
- ``fields``: E, cB and the current J after each compared unit of steps.
- ``moments``: the particles after each unit as sets: their count and
  momentum deposited onto the nodes by their global positions (so a
  particle that the float types put on two sides of a face reads the same),
  per species, each read as ``mod.settled`` reads it (so one that they
  reflect or not on a wall's face reads the same too).
- ``gauss``: div E - (rho + rho_b) / eps0 on each state after the window
  (rho_b from the reference's initialization), over the electrons' charge
  density: the charge that the unchecked steps before it conserved.
- ``live``, ``dropped``: live particles against the deck's count, dropped
  movers; exact.

``mod`` is the configuration's reference module
(:func:`picbench.judge.reference`): its field names, its mesh's nodes,
charge, div E and the axes a position gap wraps across.
"""

from __future__ import annotations

import torch


def _rms(t) -> float:
    return float(torch.sqrt(torch.mean(t.double() ** 2)))


def field_gap(Fc: dict, Fr: dict, groups) -> float:
    """``groups``: tuples of component names, such as ``(mod.E, mod.B)``.
    Per group of components: the widest |candidate - reference| over
    the largest rms of the reference's components; the worst group.  A
    group that is zero in the reference is held to its absolute gap."""
    worst = 0.0
    for group in groups:
        scale = max(_rms(Fr[c]) for c in group) or 1.0
        gap = max(float((Fc[c].double() - Fr[c].double()).abs().max())
                  for c in group)
        worst = max(worst, gap / scale)
    return worst


def _global(sp, box):
    """(3, n) float64 positions in cells from the box's low corner."""
    return sp["cell"].double() + 0.5 * (sp["off"].double() + 1)


def lane_gaps(cand: list, ref: list, box, mod):
    """Position (cells, across the periodic seams of ``mod``'s mesh) and
    momentum (over the species' rms) gaps, lane by lane."""
    dev = ref[0]["q"].device
    n = torch.tensor(box.n, dtype=torch.float64, device=dev)[:, None]
    wrap = torch.tensor(mod.wraps(box), device=dev)[:, None]
    pos = mom = 0.0
    for c, r in zip(cand, ref):
        d = _global(c, box) - _global(r, box)
        d = torch.where(wrap, torch.remainder(d + 0.5 * n, n) - 0.5 * n, d)
        pos = max(pos, float(d.abs().max()))
        ur = r["u"].double()
        mom = max(mom, float((c["u"].double() - ur).abs().max())
                  / (_rms(ur) or 1.0))
    return pos, mom


def moments(sp, box, mod):
    """(nodes, 4) float64: count, ux, uy, uz on ``mod``'s nodes, of the
    species as ``mod.settled`` reads it."""
    sp = mod.settled(sp, box)
    out = torch.zeros((mod.nodes(box), 4), dtype=torch.float64,
                      device=sp["q"].device)
    for s in range(0, sp["q"].shape[0], mod.BLOCK):
        u = sp["u"][:, s:s + mod.BLOCK].double()
        w = torch.cat([torch.ones_like(u[:1]), u]).T
        mod.node_deposit(box, sp["cell"][:, s:s + mod.BLOCK],
                         sp["off"][:, s:s + mod.BLOCK].double(), w, out)
    return out


def moment_gap(cand: list, ref: list, box, mod) -> float:
    """``cand``: species, or their :func:`moments` worked out already."""
    worst = 0.0
    for c, r in zip(cand, ref):
        mc = (c.to(r["q"].device) if torch.is_tensor(c)
              else moments(c, box, mod))
        mr = moments(r, box, mod)
        for k in range(4):
            scale = _rms(mr[:, k]) or 1.0
            worst = max(worst, float((mc[:, k] - mr[:, k]).abs().max())
                        / scale)
    return worst


def as64(species: list) -> list:
    return [dict(sp, off=sp["off"].double(), u=sp["u"].double(),
                 q=sp["q"].double()) for sp in species]


def gauss_gap(F: dict, species, rhob, box, scale: float, mod) -> float:
    """``species``: a list, or their charge density worked out already."""
    rhof = (species.to(rhob.device) if torch.is_tensor(species)
            else mod.rho(as64(species), box, torch.float64))
    err = (mod.div_e({c: F[c].double() for c in mod.E}, box)
           - (rhof + rhob.double()) / box.eps0)
    return float(err.abs().max()) / scale


def charge_scale(species: list, box, mod) -> float:
    """The rms charge density of the first species (the electrons)."""
    return _rms(mod.rho(species[:1], box, torch.float64) / box.eps0)
