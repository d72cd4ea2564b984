"""The inputs of ``fan_run`` for the plain reference, made again from the
seed as the deck makes them (``vpic_tpu_torch/decks/turbulence_fan.py``,
a copy of its draws and field functions): a uniform pair plasma in a
guide field b0 z, seeded with two counter-propagating families of oblique
Alfven waves, in a periodic cube; the particles carry the waves' E x B
velocity and half the wave current per species.  The draws are numpy's
stream, as the deck's; the arithmetic on them runs in float64 on the
judge's device."""

from __future__ import annotations

import math

import numpy as np
import torch

from picbench.reference import pic

# (l, m, phi) mode triplets of the two wave fans
MODES_1 = ((1, 1, 0.0), (1, 2, 1.5), (-2, 3, 3.9))      # dB in x, k in (z, y)
MODES_2 = ((-1, 1, 0.4), (-1, -2, 2.56), (2, -3, 4.19))  # dB in y, k in (z, x)


def _physics(cfg):
    p = dict(cfg["physics"])
    b0 = p["me"] * p["c"] / p["wpe_wce"]
    L = 2 * math.pi * p["c"]                  # 2 pi d_i, d_i = c / wpe
    return dict(p, b0=b0, Va=b0 / math.sqrt(2.0), L=L, k0=2 * math.pi / L)


def _fan(p, modes, a, z, sign_e):
    """One wave family at (a, z), ``a`` the other coordinate of its wave
    vectors: (dB, dE, dU, dJ along ``a``'s axis, dJz); ``sign_e`` the
    sign of its E and of its current along ``a``."""
    amp, b0, Va, k0 = p["amp"], p["b0"], p["Va"], p["k0"]
    xp = torch if torch.is_tensor(a) else np
    b = e = u = ja = jz = 0.0
    for l, m, phi in modes:
        arg = l * k0 * z + m * k0 * a + phi
        c, s = xp.cos(arg), xp.sin(arg)
        sgn = l / abs(l)
        b = b + amp * b0 * c
        e = e + sign_e * amp * sgn * Va * b0 * c
        u = u - amp * sgn * Va * c
        ja = ja + sign_e * amp * b0 * (l * k0) * s
        jz = jz - sign_e * amp * b0 * (m * k0) * s
    return b, e, u, ja, jz


def fan1(p, y, z):
    """(dBx, dEy, dUx, dJy, dJz) of family 1."""
    return _fan(p, MODES_1, y, z, -1.0)


def fan2(p, x, z):
    """(dBy, dEx, dUy, dJx, dJz) of family 2."""
    return _fan(p, MODES_2, x, z, 1.0)


def box(cfg) -> pic.Box:
    p = _physics(cfg)
    n = (cfg["nx"], cfg["ny"], cfg["nz"])
    L = p["L"]
    dt = min(p["courant"] * pic.courant_length((L, L, L), n), p["dt_max"])
    return pic.Box(n=n, lo=(0.0, 0.0, 0.0), hi=(L, L, L), dt=dt,
                   cvac=p["c"])


def inputs(cfg, seed: int, box: pic.Box, device="cpu") -> dict:
    p = _physics(cfg)
    L, vth = p["L"], p["vthe"]
    n = cfg["nx"] * cfg["ny"] * cfg["nz"] * cfg["ppc"]
    rng = np.random.default_rng(seed + 1)
    draw = lambda f, *a: torch.as_tensor(f(*a), device=device)
    x = draw(rng.uniform, 0, L, n)
    y = draw(rng.uniform, 0, L, n)
    z = draw(rng.uniform, 0, L, n)
    _, _, ux1, jy1, jz1 = fan1(p, y, z)
    _, _, uy2, jx2, jz2 = fan2(p, x, z)
    weight = p["me"] * L ** 3 / n
    species = []
    for sp in cfg["species"]:
        sgn = sp["sign"]
        vx = draw(rng.normal, 0, vth, n) + ux1 + sgn * jx2 * 0.5
        vy = draw(rng.normal, 0, vth, n) + sgn * jy1 * 0.5 + uy2
        vz = draw(rng.normal, 0, vth, n) + sgn * (jz1 + jz2) * 0.5
        v2 = vx * vx + vy * vy + vz * vz
        bad = v2 >= 1.0
        while bool(bad.any()):
            r = draw(rng.normal, 0, vth, (3, int(bad.sum())))
            vx[bad] = r[0] + ux1[bad] + sgn * jx2[bad] * 0.5
            vy[bad] = r[1] + sgn * jy1[bad] * 0.5 + uy2[bad]
            vz[bad] = r[2] + sgn * (jz1[bad] + jz2[bad]) * 0.5
            v2 = vx * vx + vy * vy + vz * vz
            bad = v2 >= 1.0
        gamma = 1.0 / torch.sqrt(1.0 - v2)
        del v2
        species.append(dict(name=sp["name"], q_m=sp["q_m"], x=x, y=y, z=z,
                            ux=gamma * vx, uy=gamma * vy, uz=gamma * vz,
                            q=torch.full((n,), sgn * weight,
                                         dtype=torch.float64, device=device)))
        del vx, vy, vz, gamma
    del ux1, jy1, jz1, uy2, jx2, jz2
    fields = dict(
        ex=pic.sample(lambda x, y, z: fan2(p, x, z)[1], "ex", box),
        ey=pic.sample(lambda x, y, z: fan1(p, y, z)[1], "ey", box),
        cbx=pic.sample(lambda x, y, z: fan1(p, y, z)[0], "cbx", box),
        cby=pic.sample(lambda x, y, z: fan2(p, x, z)[0], "cby", box),
        cbz=pic.sample(lambda x, y, z: p["b0"] + 0.0 * x, "cbz", box))
    return dict(species=species, fields=fields)
