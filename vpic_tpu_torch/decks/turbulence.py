"""Turbulent-reconnection deck — the vpic_tpu analogue of
decks/trecon-part/turbulence.cxx ("single Force-Free Current Sheet with
conductive BC + initial turbulence").

What distinguishes it from decks/sigma.py (same sheet + walls geometry):

- the bulk plasma is SPLIT into top/bottom species pairs eT/eB, iT/iB by
  the sign of the load z (turbulence.cxx:282-285, :560-580) so mixing
  across the reconnection layer is directly diagnosable,
- the sheet is seeded with the deck's two turbulence wave families
  BYWAVE/BZWAVE — five (l,m,phi) modes each on cby/cbz
  (turbulence.cxx:471-475) — in addition to the long-wavelength flux
  perturbation DBX0/DBZ0 (turbulence.cxx:456-457),
- tagged tracer species eR/iR ride along (tracer.cxx machinery), and the
  in-deck diagnostics write per-species energy-band spectra
  (energy.cxx, SPEC_FILE_FORMAT hydro/T.%d/spectrum-%s...) next to the
  banded hydro dumps.

The port's copy of ``decks/turbulence.py``: the same knobs, the same numpy
random stream (so both packages load identical particles) and the same
``diagnostics(sim)``; ``deck(device)`` builds it on the card unless
``device="cpu"`` is asked for.

Knobs via environment (the config.h pattern):
  TURB_NX/NY/NZ, TURB_PPC, TURB_STEPS, TURB_AMP, TURB_PX/PY/PZ, TURB_OUT
Run:  python -m vpic_tpu_torch.cli.run vpic_tpu_torch/decks/turbulence.py \
          --num-step 100
"""

import math
import os

import numpy as np

from vpic_tpu_torch import Simulation
from vpic_tpu_torch.core.types import PEC_FIELDS
from vpic_tpu_torch.engine.step import StepOptions


def _env(name, default, cast=int):
    return cast(os.environ.get(name, default))


# BYWAVE/BZWAVE mode triplets (turbulence.cxx:474-475):
#   DBY(l,n,phi) = amp*b0*cos(l*kx*x+phi)*cos(n*kz*z)
#   DBZ(l,m,phi) = amp*b0*cos(l*kx*x)*sin(m*ky*y+phi)
BY_MODES = ((2, 1, 0.0), (3, 2, 0.2), (4, 1, -0.5), (5, 3, 0.6),
            (6, 4, -0.8))
BZ_MODES = ((2, 1, 0.5), (3, 2, -0.2), (4, 3, -0.3), (5, 4, 0.3),
            (6, 5, 0.8))


def deck(device="cuda"):
    nx = _env("TURB_NX", 64)
    ny = _env("TURB_NY", 32)
    nz = _env("TURB_NZ", 32)
    ppc = _env("TURB_PPC", 16)
    px = _env("TURB_PX", 1)
    py = _env("TURB_PY", 1)
    pz = _env("TURB_PZ", 1)
    amp = _env("TURB_AMP", 0.05, float)     # wave amplitude / b0

    # physics parameters (turbulence.cxx:199-240 — the trecon/sigma
    # relativistic regime: wpe/wce < 1, hot electrons, cell size ~ the
    # Debye length so the load doesn't grid-heat)
    mi_me = 25.0
    vthe = _env("TURB_VTHE", 0.6, float)
    Ti_Te = 1.0
    wpe_wce = 0.1
    bg = 0.2                                # guide field / b0
    c = 1.0

    me = 1.0 / mi_me
    mi = 1.0
    wce = 1.0 / wpe_wce
    b0 = me * c * wce
    di = c * math.sqrt(mi_me)
    L = (6.0 / math.sqrt(mi_me)) * di       # sheet half-thickness
    vthi = vthe * math.sqrt(Ti_Te * me / mi)

    Lx = 2.0 * L * 2 * math.pi / 4
    Ly = Lx * ny / nx                        # equal cell sizes all axes
    Lz = Lx * nz / nx
    Lpert = Lx

    sim = Simulation(seed=_env("TURB_SEED", 7), device=device)
    sim.define_units(cvac=c, eps0=1.0)
    dt = 0.95 * sim.courant_length(Lx, Ly, Lz, nx, ny, nz)
    sim.define_timestep(dt)
    # conductive z walls + periodic x/y (turbulence.cxx:252-276)
    sim.define_periodic_grid(0, -0.5 * Ly, -0.5 * Lz, Lx, 0.5 * Ly,
                             0.5 * Lz, nx, ny, nz, px, py, pz)
    sim.define_material("vacuum")
    sim.set_domain_field_bc(2, PEC_FIELDS)
    sim.set_domain_field_bc(5, PEC_FIELDS)
    sim.set_domain_particle_bc(2, "reflect")
    sim.set_domain_particle_bc(5, "reflect")

    n_part = nx * ny * nz * ppc
    cap = int(1.2 * n_part)                 # split species: ~half each + slack
    eT = sim.define_species("eT", -1.0 / me, cap)
    eB = sim.define_species("eB", -1.0 / me, cap)
    iT = sim.define_species("iT", 1.0 / mi, cap)
    iB = sim.define_species("iB", 1.0 / mi, cap)
    e_tr = sim.define_species("eR", -1.0 / me, 8192)
    i_tr = sim.define_species("iR", 1.0 / mi, 8192)

    # -- fields: force-free sheet + flux perturbation + wave fans
    # (turbulence.cxx:450-457, :471-475) --
    dbz = 0.03 * b0
    dbx = -dbz * Lpert / (2.0 * Lz)
    kx0, ky0, kz0 = (2 * math.pi / Lx, 2 * math.pi / Ly, 2 * math.pi / Lz)

    def BX(z):
        return b0 * np.tanh(z / L)

    def BY(z):
        bx = BX(z)
        return np.sqrt(b0 * b0 + bg * bg * b0 * b0 - bx * bx)

    def bywave(x, z):
        tot = 0.0
        for l, n, phi in BY_MODES:
            tot = tot + amp * b0 * np.cos(l * kx0 * x + phi) \
                * np.cos(n * kz0 * z)
        return tot

    def bzwave(x, y):
        tot = 0.0
        for l, m, phi in BZ_MODES:
            tot = tot + amp * b0 * np.cos(l * kx0 * x) \
                * np.sin(m * ky0 * y + phi)
        return tot

    sim.set_field("cbx", lambda x, y, z: BX(z)
                  + dbx * np.cos(2 * np.pi * (x - 0.5 * Lx) / Lpert)
                  * np.sin(np.pi * z / Lz))
    sim.set_field("cby", lambda x, y, z: BY(z) + bywave(x, z))
    sim.set_field("cbz", lambda x, y, z: bzwave(x, y)
                  + dbz * np.cos(np.pi * z / Lz)
                  * np.sin(2 * np.pi * (x - 0.5 * Lx) / Lpert))

    # -- particles: drifting Maxwellians split top/bottom by load z
    # (turbulence.cxx:560-580; the drift carries the sheet current) --
    rng = np.random.default_rng(_env("TURB_SEED", 7) + 1)
    x = rng.uniform(0, Lx, n_part)
    y = rng.uniform(-0.5 * Ly, 0.5 * Ly, n_part)
    z = rng.uniform(-0.5 * Lz, 0.5 * Lz, n_part)

    bx, by = BX(z), BY(z)
    vdy = -0.5 * (b0 / L) / np.cosh(z / L) ** 2
    vdx = vdy * bx / by
    vd = np.maximum(np.sqrt(vdx * vdx + vdy * vdy), 1e-30)
    gvd = 1.0 / np.sqrt(1.0 - vd * vd / (c * c))
    weight = me * (Lx * Ly * Lz) / n_part
    top = z >= 0.0

    def boosted(vth, sign):
        """Field-aligned relativistic drift boost (turbulence.cxx load,
        same form as sigma.cxx:479-513)."""
        upa = rng.normal(0, vth, n_part)
        upe = rng.normal(0, vth, n_part)
        uz1 = rng.normal(0, vth, n_part)
        gu1 = np.sqrt(1.0 + upa * upa + upe * upe + uz1 * uz1)
        ux = sign * (gvd * upa * vdx / vd - upe * vdy / vd) \
            + sign * gvd * vdx * gu1
        uy = sign * (gvd * upa * vdy / vd + upe * vdx / vd) \
            + sign * gvd * vdy * gu1
        return ux, uy, uz1

    uxe, uye, uze = boosted(vthe, +1.0)
    sim.inject_particle(eT, x[top], y[top], z[top],
                        uxe[top], uye[top], uze[top], q=-weight)
    sim.inject_particle(eB, x[~top], y[~top], z[~top],
                        uxe[~top], uye[~top], uze[~top], q=-weight)
    uxi, uyi, uzi = boosted(vthi, -1.0)
    sim.inject_particle(iT, x[top], y[top], z[top],
                        uxi[top], uyi[top], uzi[top], q=weight)
    sim.inject_particle(iB, x[~top], y[~top], z[~top],
                        uxi[~top], uyi[~top], uzi[~top], q=weight)

    # tagged q=0 tracers (tracer.cxx tag_tracer: rank<<19 | count)
    ntr = min(2048, n_part)
    tags = (0 << 19) | np.arange(1, ntr + 1)
    sim.inject_particle(e_tr, x[:ntr], y[:ntr], z[:ntr],
                        uxe[:ntr], uye[:ntr], uze[:ntr], q=0.0, tag=tags)
    sim.inject_particle(i_tr, x[:ntr], y[:ntr], z[:ntr],
                        uxi[:ntr], uyi[:ntr], uzi[:ntr], q=0.0, tag=tags)

    sim.opts = StepOptions(
        clean_div_e_interval=50,
        clean_div_b_interval=50,
        sync_shared_interval=50,
    )
    sim.num_step = _env("TURB_STEPS", 100)
    sim._turb_vth = (vthe, vthi)
    return sim


OUT = os.environ.get("TURB_OUT", "turb_out")
ENERGY_INTERVAL = _env("TURB_ENERGY_INTERVAL", 50)
FIELD_INTERVAL = _env("TURB_FIELD_INTERVAL", 0)
PARTICLE_INTERVAL = _env("TURB_PARTICLE_INTERVAL", 0)
RESTART_INTERVAL = _env("TURB_RESTART_INTERVAL", 0)
TRACER_INTERVAL = _env("TURB_TRACER_INTERVAL", 0)
SPECTRUM_INTERVAL = _env("TURB_SPECTRUM_INTERVAL", 0)
NEX = _env("TURB_NEX", 200)
EMAX = _env("TURB_EMAX", 50.0, float)


def diagnostics(sim):
    """begin_diagnostics analogue (turbulence.cxx:939-1247): the standard
    production inventory — rundata (grid/materials/species + global
    header at step 0), interval energies, banded field/hydro dumps,
    particle dumps, and the two-slot rotating restart — via
    ``Simulation.standard_diagnostics``, plus the deck-specific tracer
    dumps and per-species energy-band spectra (SPEC_FILE_FORMAT)
    written next to the hydro files (energy.cxx)."""
    std = getattr(sim, "_turb_std_diag", None)
    if std is None:
        std = sim.standard_diagnostics(
            OUT, energies_interval=ENERGY_INTERVAL,
            fields_interval=FIELD_INTERVAL,
            particle_interval=PARTICLE_INTERVAL,
            particle_species=("eT", "eB", "iT", "iB"),
            restart_interval=RESTART_INTERVAL)
        sim._turb_std_diag = std
    std()
    s = sim.step_count
    if TRACER_INTERVAL and s % TRACER_INTERVAL == 0:
        sim.dump_particles("eR", f"{OUT}/tracer/etracer")
        sim.dump_particles("iR", f"{OUT}/tracer/itracer")
    if SPECTRUM_INTERVAL and s % SPECTRUM_INTERVAL == 0:
        vthe, vthi = getattr(sim, "_turb_vth", (0.2, 0.04))
        for name, vth in (("eT", vthe), ("eB", vthe),
                          ("iT", vthi), ("iB", vthi)):
            sim.dump_energy_diag(name, f"{OUT}/spectra", nex=NEX,
                                 emax=EMAX, vth=vth)
