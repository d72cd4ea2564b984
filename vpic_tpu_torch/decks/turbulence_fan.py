"""Decaying-turbulence "fan run" deck — the vpic_tpu analogue of
decks/fan-run/turbulence.cxx ("Uniform plasma with imposed initial
waves"): a uniform pair plasma in a guide field b0 z_hat, seeded with two
counter-propagating families of oblique Alfven waves (the deck's
DBX_1/DBY_2 macro families, fan-run/turbulence.cxx:385-419), particles
loaded with the waves' E x B velocity plus half the wave current per
species (fan-run/turbulence.cxx:450-470), and the in-deck KE band/spectrum
diagnostics (energy.cxx) at intervals.

The port's copy of ``decks/turbulence_fan.py``: the same knobs, the same
numpy random stream (so both packages load identical particles) and the
same ``diagnostics(sim)``; ``deck(device)`` builds it on the card unless
``device="cpu"`` is asked for.

Knobs via environment (the config.h pattern):
  FAN_NX/NY/NZ, FAN_PPC, FAN_STEPS, FAN_AMP, FAN_PX/PY/PZ, FAN_OUT
Run:  python -m vpic_tpu_torch.cli.run vpic_tpu_torch/decks/turbulence_fan.py \
          --num-step 100
"""

import math
import os

import numpy as np

from vpic_tpu_torch import Simulation
from vpic_tpu_torch.engine.step import StepOptions


def _env(name, default, cast=int):
    return cast(os.environ.get(name, default))


# the reference's two wave fans: (l, m, phi) mode triplets
# (fan-run/turbulence.cxx:395-414)
MODES_1 = ((1, 1, 0.0), (1, 2, 1.5), (-2, 3, 3.9))      # dB in x, k in (z,y)
MODES_2 = ((-1, 1, 0.4), (-1, -2, 2.56), (2, -3, 4.19))  # dB in y, k in (z,x)


def _fan1(amp, b0, Va, kz0, ky0, y, z):
    """Family 1 (fan-run/turbulence.cxx:387-394): returns
    (dBx, dEy, dUx, dJy, dJz)."""
    bx = ey = uxp = jy = jz = 0.0
    for l, m, phi in MODES_1:
        c = np.cos(l * kz0 * z + m * ky0 * y + phi)
        s = np.sin(l * kz0 * z + m * ky0 * y + phi)
        sgn = l / abs(l)
        bx = bx + amp * b0 * c
        ey = ey - amp * sgn * Va * b0 * c
        uxp = uxp - amp * sgn * Va * c
        jy = jy - amp * b0 * (l * kz0) * s
        jz = jz + amp * b0 * (m * ky0) * s
    return bx, ey, uxp, jy, jz


def _fan2(amp, b0, Va, kz0, kx0, x, z):
    """Family 2 (fan-run/turbulence.cxx:402-409): returns
    (dBy, dEx, dUy, dJx, dJz)."""
    by = ex = uyp = jx = jz = 0.0
    for l, m, phi in MODES_2:
        c = np.cos(l * kz0 * z + m * kx0 * x + phi)
        s = np.sin(l * kz0 * z + m * kx0 * x + phi)
        sgn = l / abs(l)
        by = by + amp * b0 * c
        ex = ex + amp * sgn * Va * b0 * c
        uyp = uyp - amp * sgn * Va * c
        jx = jx + amp * b0 * (l * kz0) * s
        jz = jz - amp * b0 * (m * kx0) * s
    return by, ex, uyp, jx, jz


def deck(device="cuda"):
    nx = _env("FAN_NX", 32)
    ny = _env("FAN_NY", 32)
    nz = _env("FAN_NZ", 32)
    ppc = _env("FAN_PPC", 16)
    px = _env("FAN_PX", 1)
    py = _env("FAN_PY", 1)
    pz = _env("FAN_PZ", 1)
    amp = _env("FAN_AMP", 0.3, float)   # fan-run/turbulence.cxx:86
    seed = _env("FAN_SEED", 19)

    # pair plasma (the wave load "works only for a pair plasma",
    # fan-run/turbulence.cxx:386): mi = me, Ti = Te
    c = 1.0
    me = 1.0
    wpe_wce = 2.0
    b0 = me * c / wpe_wce                 # eps0 = 1, wpe = 1
    Va = b0 / math.sqrt(1.0 + 1.0)        # turbulence.cxx:140
    vthe = 0.1

    di = c
    Lx = 2 * math.pi * di
    Ly = 2 * math.pi * di
    Lz = 2 * math.pi * di
    kx0 = 2 * math.pi / Lx
    ky0 = 2 * math.pi / Ly
    kz0 = 2 * math.pi / Lz

    sim = Simulation(seed=seed, device=device)
    sim.define_units(cvac=c, eps0=1.0)
    dt = min(0.95 * sim.courant_length(Lx, Ly, Lz, nx, ny, nz), 0.7)
    sim.define_timestep(dt)
    sim.define_periodic_grid(0, 0, 0, Lx, Ly, Lz, nx, ny, nz, px, py, pz)
    sim.define_material("vacuum")

    n_part = nx * ny * nz * ppc
    electron = sim.define_species("electron", -1.0 / me,
                                  int(1.5 * n_part))
    positron = sim.define_species("positron", 1.0 / me,
                                  int(1.5 * n_part))

    # -- fields: guide field + both wave fans (set_region_field everywhere,
    # fan-run/turbulence.cxx:419) --
    def f_ex(x, y, z):
        return _fan2(amp, b0, Va, kz0, kx0, x, z)[1]

    def f_ey(x, y, z):
        return _fan1(amp, b0, Va, kz0, ky0, y, z)[1]

    def f_cbx(x, y, z):
        return _fan1(amp, b0, Va, kz0, ky0, y, z)[0]

    def f_cby(x, y, z):
        return _fan2(amp, b0, Va, kz0, kx0, x, z)[0]

    sim.set_field("ex", f_ex)
    sim.set_field("ey", f_ey)
    sim.set_field("cbx", f_cbx)
    sim.set_field("cby", f_cby)
    sim.set_field("cbz", lambda x, y, z: b0 + 0.0 * x)

    # -- particles: Maxwellian + wave velocity + species-signed half wave
    # current (fan-run/turbulence.cxx:450-470 / 481-487) --
    rng = np.random.default_rng(seed + 1)
    x = rng.uniform(0, Lx, n_part)
    y = rng.uniform(0, Ly, n_part)
    z = rng.uniform(0, Lz, n_part)
    _, _, ux1, jy1, jz1 = _fan1(amp, b0, Va, kz0, ky0, y, z)
    _, _, uy2, jx2, jz2 = _fan2(amp, b0, Va, kz0, kx0, x, z)
    weight = me * (Lx * Ly * Lz) / n_part

    for sp, sgn, q in ((electron, -1.0, -weight), (positron, +1.0, weight)):
        vx = rng.normal(0, vthe, n_part) + ux1 + sgn * jx2 * 0.5
        vy = rng.normal(0, vthe, n_part) + sgn * jy1 * 0.5 + uy2
        vz = rng.normal(0, vthe, n_part) + sgn * (jz1 + jz2) * 0.5
        v2 = vx * vx + vy * vy + vz * vz
        # resample superluminal tails (turbulence.cxx:459-466)
        bad = v2 >= 1.0
        while bad.any():
            r = rng.normal(0, vthe, (3, int(bad.sum())))
            vx[bad] = r[0] + ux1[bad] + sgn * jx2[bad] * 0.5
            vy[bad] = r[1] + sgn * jy1[bad] * 0.5 + uy2[bad]
            vz[bad] = r[2] + sgn * (jz1[bad] + jz2[bad]) * 0.5
            v2 = vx * vx + vy * vy + vz * vz
            bad = v2 >= 1.0
        gamma = 1.0 / np.sqrt(1.0 - v2)
        sim.inject_particle(sp, x, y, z, gamma * vx, gamma * vy,
                            gamma * vz, q=q)

    sim.opts = StepOptions(
        clean_div_e_interval=25,
        clean_div_b_interval=25,
        sync_shared_interval=25,
    )
    sim.num_step = _env("FAN_STEPS", 100)
    sim._fan_params = dict(vth=vthe)
    return sim


OUT = os.environ.get("FAN_OUT", "fan_out")
ENERGY_INTERVAL = _env("FAN_ENERGY_INTERVAL", 20)
SPECTRUM_INTERVAL = _env("FAN_SPECTRUM_INTERVAL", 50)
NEX = _env("FAN_NEX", 20)
EMAX = _env("FAN_EMAX", 200.0, float)


def diagnostics(sim):
    """begin_diagnostics analogue: energies + the energy.cxx band/spectrum
    dumps (fan-run/energy.cxx)."""
    s = sim.step_count
    if ENERGY_INTERVAL and s % ENERGY_INTERVAL == 0:
        sim.dump_energies(f"{OUT}/energies.txt")
    if SPECTRUM_INTERVAL and s % SPECTRUM_INTERVAL == 0:
        vth = sim._fan_params["vth"]
        for name in ("electron", "positron"):
            sim.dump_energy_diag(name, f"{OUT}/hydro", nex=NEX, emax=EMAX,
                                 vth=vth)
