"""The inputs of ``trecon`` for its plain reference
(``picbench/reference/walls.py``), made again from the seed as the deck
makes them (``vpic_tpu_torch/decks/turbulence.py``, a copy of its draws
and field functions): a force-free current sheet b0 tanh(z/L) x + B_y(z) y
with a guide field, a flux perturbation and the BYWAVE/BZWAVE fans, in a
box periodic in x and y and closed in z by conducting, reflecting walls.
The electrons and the ions are drifting Maxwellians that carry the sheet's
current, split into top and bottom species by the sign of their load z;
the tracer species are q = 0 copies of the first electrons and ions.  The
draws are numpy's stream, as the deck's; the arithmetic on them runs in
float64 on the judge's device."""

from __future__ import annotations

import math

import numpy as np
import torch

from picbench.reference import walls

# (l, n, phi) and (l, m, phi) mode triplets of the two fans
BY_MODES = ((2, 1, 0.0), (3, 2, 0.2), (4, 1, -0.5), (5, 3, 0.6),
            (6, 4, -0.8))
BZ_MODES = ((2, 1, 0.5), (3, 2, -0.2), (4, 3, -0.3), (5, 4, 0.3),
            (6, 5, 0.8))


def _physics(cfg):
    p = dict(cfg["physics"])
    c, mi_me = p["c"], p["mi_me"]
    me, mi = 1.0 / mi_me, 1.0
    b0 = me * c * (1.0 / p["wpe_wce"])
    di = c * math.sqrt(mi_me)
    L = (p["L_de"] / math.sqrt(mi_me)) * di
    Lx = 2.0 * L * 2 * math.pi / 4
    Ly = Lx * cfg["ny"] / cfg["nx"]
    Lz = Lx * cfg["nz"] / cfg["nx"]
    dbz = p["dbz_b0"] * b0
    return dict(p, me=me, mi=mi, b0=b0, L=L, Lx=Lx, Ly=Ly, Lz=Lz,
                Lpert=Lx, dbz=dbz, dbx=-dbz * Lx / (2.0 * Lz),
                vthi=p["vthe"] * math.sqrt(p["Ti_Te"] * me / mi),
                k0=(2 * math.pi / Lx, 2 * math.pi / Ly, 2 * math.pi / Lz))


def _bx(p, z):
    return p["b0"] * np.tanh(z / p["L"])


def _by(p, z):
    bx = _bx(p, z)
    b0, bg = p["b0"], p["bg"]
    return np.sqrt(b0 * b0 + bg * bg * b0 * b0 - bx * bx)


def _bywave(p, x, z):
    kx0, _, kz0 = p["k0"]
    tot = 0.0
    for l, n, phi in BY_MODES:
        tot = tot + p["amp"] * p["b0"] * np.cos(l * kx0 * x + phi) \
            * np.cos(n * kz0 * z)
    return tot


def _bzwave(p, x, y):
    kx0, ky0, _ = p["k0"]
    tot = 0.0
    for l, m, phi in BZ_MODES:
        tot = tot + p["amp"] * p["b0"] * np.cos(l * kx0 * x) \
            * np.sin(m * ky0 * y + phi)
    return tot


def box(cfg) -> walls.Box:
    p = _physics(cfg)
    n = (cfg["nx"], cfg["ny"], cfg["nz"])
    Lx, Ly, Lz = p["Lx"], p["Ly"], p["Lz"]
    dt = p["courant"] * walls.courant_length((Lx, Ly, Lz), n)
    return walls.Box(n=n, lo=(0.0, -0.5 * Ly, -0.5 * Lz),
                     hi=(Lx, 0.5 * Ly, 0.5 * Lz), dt=dt, cvac=p["c"],
                     walls=(False, False, True))


def inputs(cfg, seed: int, box: walls.Box, device="cpu") -> dict:
    p = _physics(cfg)
    Lx, Ly, Lz, L, b0, c = (p[k] for k in ("Lx", "Ly", "Lz", "L", "b0",
                                           "c"))
    n = cfg["nx"] * cfg["ny"] * cfg["nz"] * cfg["ppc"]
    rng = np.random.default_rng(seed + 1)
    draw = lambda f, *a: torch.as_tensor(f(*a), device=device)
    x = draw(rng.uniform, 0, Lx, n)
    y = draw(rng.uniform, -0.5 * Ly, 0.5 * Ly, n)
    z = draw(rng.uniform, -0.5 * Lz, 0.5 * Lz, n)
    bx = b0 * torch.tanh(z / L)
    by = torch.sqrt(b0 * b0 + p["bg"] ** 2 * b0 * b0 - bx * bx)
    vdy = -0.5 * (b0 / L) / torch.cosh(z / L) ** 2
    vdx = vdy * bx / by
    del bx, by
    vd = torch.clamp(torch.sqrt(vdx * vdx + vdy * vdy), min=1e-30)
    gvd = 1.0 / torch.sqrt(1.0 - vd * vd / (c * c))
    weight = p["me"] * (Lx * Ly * Lz) / n
    top = z >= 0.0

    def boosted(vth, sign):
        """The field-aligned relativistic drift boost of the deck's load."""
        upa = draw(rng.normal, 0, vth, n)
        upe = draw(rng.normal, 0, vth, n)
        uz1 = draw(rng.normal, 0, vth, n)
        gu1 = torch.sqrt(1.0 + upa * upa + upe * upe + uz1 * uz1)
        ux = sign * (gvd * upa * vdx / vd - upe * vdy / vd) \
            + sign * gvd * vdx * gu1
        uy = sign * (gvd * upa * vdy / vd + upe * vdx / vd) \
            + sign * gvd * vdy * gu1
        return ux, uy, uz1

    q_m = {s["name"]: s["q_m"] for s in cfg["species"]}
    ntr = min(cfg["tracers"], n)
    # in the deck's order of definition: eT, eB, iT, iB, eR, iR
    species = []

    def add(name, sel, u, q):
        xs = x[sel]
        species.append(dict(name=name, q_m=q_m[name], x=xs, y=y[sel],
                            z=z[sel], ux=u[0][sel], uy=u[1][sel],
                            uz=u[2][sel],
                            q=torch.full(xs.shape, q, dtype=torch.float64,
                                         device=device)))

    ue = boosted(p["vthe"], +1.0)
    add("eT", top, ue, -weight)
    add("eB", ~top, ue, -weight)
    ue = tuple(v[:ntr] for v in ue)
    ui = boosted(p["vthi"], -1.0)
    add("iT", top, ui, weight)
    add("iB", ~top, ui, weight)
    first = slice(0, ntr)
    add("eR", first, ue, 0.0)
    add("iR", first, ui, 0.0)
    del ui, ue, vdx, vdy, vd, gvd
    x0, Lpert = 0.5 * Lx, p["Lpert"]
    fields = dict(
        cbx=walls.sample(lambda x, y, z: _bx(p, z) + p["dbx"]
                         * np.cos(2 * np.pi * (x - x0) / Lpert)
                         * np.sin(np.pi * z / Lz), "cbx", box),
        cby=walls.sample(lambda x, y, z: _by(p, z) + _bywave(p, x, z),
                         "cby", box),
        cbz=walls.sample(lambda x, y, z: _bzwave(p, x, y) + p["dbz"]
                         * np.cos(np.pi * z / Lz)
                         * np.sin(2 * np.pi * (x - x0) / Lpert), "cbz",
                         box))
    return dict(species=species, fields=fields)
