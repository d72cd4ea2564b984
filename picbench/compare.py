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
  per species.
- ``gauss``: div E - (rho + rho_b) / eps0 on each state after the window
  (rho_b from the reference's initialization), over the electrons' charge
  density: the charge that the unchecked steps before it conserved.
- ``live``, ``dropped``: live particles against the deck's count, dropped
  movers; exact.
"""

from __future__ import annotations

import torch

from picbench.reference import pic


def _rms(t) -> float:
    return float(torch.sqrt(torch.mean(t.double() ** 2)))


def field_gap(Fc: dict, Fr: dict, groups=(pic.E, pic.B, pic.J)) -> float:
    """Per group of components: the widest |candidate - reference| over
    the largest rms of the reference's components; the worst group.  A
    group that is zero in the reference is held to its absolute gap."""
    worst = 0.0
    for group in groups:
        scale = max(_rms(Fr[c]) for c in group) or 1.0
        gap = max(float((Fc[c].double() - Fr[c].double()).abs().max())
                  for c in group)
        worst = max(worst, gap / scale)
    return worst


def _global(sp, box: pic.Box):
    """(3, n) float64 positions in cells from the box's low corner."""
    return sp["cell"].double() + 0.5 * (sp["off"].double() + 1)


def lane_gaps(cand: list, ref: list, box: pic.Box):
    """Position (cells, across the periodic seam) and momentum (over the
    species' rms) gaps, lane by lane."""
    n = torch.tensor(box.n, dtype=torch.float64,
                     device=ref[0]["q"].device)[:, None]
    pos = mom = 0.0
    for c, r in zip(cand, ref):
        d = _global(c, box) - _global(r, box)
        d = torch.remainder(d + 0.5 * n, n) - 0.5 * n
        pos = max(pos, float(d.abs().max()))
        ur = r["u"].double()
        mom = max(mom, float((c["u"].double() - ur).abs().max())
                  / (_rms(ur) or 1.0))
    return pos, mom


def moments(sp, box: pic.Box):
    """(cells, 4) float64: count, ux, uy, uz on the nodes."""
    out = torch.zeros((box.cells, 4), dtype=torch.float64,
                      device=sp["q"].device)
    for s in range(0, sp["q"].shape[0], pic.BLOCK):
        u = sp["u"][:, s:s + pic.BLOCK].double()
        w = torch.cat([torch.ones_like(u[:1]), u]).T
        pic.node_deposit(box, sp["cell"][:, s:s + pic.BLOCK],
                         sp["off"][:, s:s + pic.BLOCK].double(), w, out)
    return out


def moment_gap(cand: list, ref: list, box: pic.Box) -> float:
    """``cand``: species, or their :func:`moments` worked out already."""
    worst = 0.0
    for c, r in zip(cand, ref):
        mc = c.to(r["q"].device) if torch.is_tensor(c) else moments(c, box)
        mr = moments(r, box)
        for k in range(4):
            scale = _rms(mr[:, k]) or 1.0
            worst = max(worst, float((mc[:, k] - mr[:, k]).abs().max())
                        / scale)
    return worst


def as64(species: list) -> list:
    return [dict(sp, off=sp["off"].double(), u=sp["u"].double(),
                 q=sp["q"].double()) for sp in species]


def gauss_gap(F: dict, species, rhob, box: pic.Box,
              scale: float) -> float:
    """``species``: a list, or their charge density worked out already."""
    rhof = (species.to(rhob.device) if torch.is_tensor(species)
            else pic.rho(as64(species), box, torch.float64))
    err = (pic.div_e({c: F[c].double() for c in pic.E}, box)
           - (rhof + rhob.double()) / box.eps0)
    return float(err.abs().max()) / scale


def charge_scale(species: list, box: pic.Box) -> float:
    """The rms charge density of the first species (the electrons)."""
    return _rms(pic.rho(species[:1], box, torch.float64) / box.eps0)
