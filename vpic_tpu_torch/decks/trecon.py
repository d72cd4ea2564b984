"""Force-free current-sheet reconnection / turbulence deck — the
vpic_tpu port of the trecon-part workload class
(reference: decks/trecon-part/turbulence.cxx).

Physics: a 2D (x,z) force-free sheet B = b0*tanh(z/L) x_hat +
sqrt(b0^2(1+bg^2) - Bx^2) y_hat, seeded with the deck's long-wavelength
flux perturbation (DBX0/DBZ0) plus the turbulence mode spectrum
(BYWAVE/BZWAVE, turbulence.cxx:450-476), drifting bi-Maxwellian electrons
and ions carrying the sheet current, and tracer particles (tracer.cxx).

The port's copy of ``decks/trecon.py``: the same knobs, the same numpy
random stream (so both packages load identical particles) and the same
``diagnostics(sim)``; ``deck(device)`` builds it on the card unless
``device="cpu"`` is asked for.

Knobs via environment (the config.h pattern):
  TRECON_NX/NZ, TRECON_PPC, TRECON_STEPS, TRECON_PX/PY/PZ, TRECON_OUT
Run:  python -m vpic_tpu_torch.cli.run vpic_tpu_torch/decks/trecon.py \
          --num-step 100
"""

import math
import os

import numpy as np

from vpic_tpu_torch import Simulation
from vpic_tpu_torch.engine.step import StepOptions


def _env(name, default, cast=int):
    return cast(os.environ.get(name, default))


def deck(device="cuda"):
    nx = _env("TRECON_NX", 256)
    nz = _env("TRECON_NZ", 128)
    ppc = _env("TRECON_PPC", 64)
    px = _env("TRECON_PX", 1)
    pz = _env("TRECON_PZ", 1)

    # physics parameters (turbulence.cxx:82-187 style, normalized units)
    mi_me = 25.0
    L_di = 0.5          # sheet half-thickness / d_i
    Ti_Te = 5.0
    bg = 0.0            # guide field ratio
    amp = 0.02          # turbulence mode amplitude
    wpe_wce = 2.0
    c = 1.0

    mi = 1.0
    me = mi / mi_me
    wce = 1.0 / wpe_wce
    b0 = me * c * wce          # eps0 = 1, wpe = 1
    di = c * math.sqrt(mi_me)
    L = L_di * di
    vthe = math.sqrt(0.25 * b0 * b0 / (me * (1 + Ti_Te)))  # beta_e ~ 0.5
    vthi = vthe * math.sqrt(Ti_Te * me / mi)

    Lx = 2.0 * math.pi * L_di * di * 2
    Lz = math.pi * L_di * di * 2
    Lpert = Lx

    sim = Simulation(seed=_env("TRECON_SEED", 7), device=device)
    sim.define_units(cvac=c, eps0=1.0)
    # dt: Courant AND plasma-frequency stability (wpe = 1 in these units)
    dt = min(0.95 * sim.courant_length(Lx, 1.0, Lz, nx, 1, nz), 0.7)
    sim.define_timestep(dt)
    sim.define_periodic_grid(0, 0, -0.5 * Lz, Lx, 1.0, 0.5 * Lz,
                             nx, 1, nz, px, 1, pz)
    sim.define_material("vacuum")

    n_part = nx * nz * ppc
    electron = sim.define_species("electron", -1.0 / me, int(1.5 * n_part))
    ion = sim.define_species("ion", 1.0 / mi, int(1.5 * n_part))
    tracer = sim.define_species("e_tracer", -1.0 / me, 4096)

    # -- fields: force-free sheet + perturbations (turbulence.cxx:450-483) --
    kx = 2 * math.pi / Lx
    kz = math.pi / Lz
    dbz = 0.05 * b0
    dbx = -dbz * Lpert / (2 * Lz)

    def BX(x, y, z):
        return b0 * np.tanh(z / L)

    def BY(x, y, z):
        bx = BX(x, y, z)
        return np.sqrt(b0 * b0 * (1 + bg * bg) - bx * bx)

    def bywave(x, z):
        out = 0.0
        for l, n, phi in ((2, 1, 0.0), (3, 2, 0.2), (4, 1, -0.5),
                          (5, 3, 0.6), (6, 4, -0.8)):
            out = out + amp * b0 * np.cos(l * kx * x + phi) \
                * np.cos(n * kz * z)
        return out

    def bzwave(x, z):
        out = 0.0
        for l, m, phi in ((2, 1, 0.5), (3, 2, -0.2), (4, 3, -0.3),
                          (5, 4, 0.3), (6, 5, 0.8)):
            out = out + amp * b0 * np.cos(l * kx * x) \
                * np.sin(m * kz * z + phi)  # ky modes fold onto kz in 2D
        return out

    sim.set_field("cbx", lambda x, y, z: BX(x, y, z)
                  + dbx * np.cos(2 * np.pi * (x - 0.5 * Lx) / Lpert)
                  * np.sin(np.pi * z / Lz))
    sim.set_field("cby", lambda x, y, z: BY(x, y, z) + bywave(x, z))
    sim.set_field("cbz", lambda x, y, z:
                  dbz * np.cos(np.pi * z / Lz)
                  * np.sin(2 * np.pi * (x - 0.5 * Lx) / Lpert)
                  + bzwave(x, z))

    # -- particles: drifting bi-Maxwellians carrying the sheet current --
    rng = np.random.default_rng(_env("TRECON_SEED", 7) + 1)
    x = rng.uniform(0, Lx, n_part)
    z = rng.uniform(-0.5 * Lz, 0.5 * Lz, n_part)
    y = rng.uniform(0, 1.0, n_part)

    bx = b0 * np.tanh(z / L)
    by = np.sqrt(b0 * b0 * (1 + bg * bg) - bx * bx)
    vdy = -0.5 * (b0 / L) / np.cosh(z / L) ** 2
    vdx = vdy * bx / by
    # split the force-free current between species inversely to mass
    we = 1.0 / (1.0 + Ti_Te)

    # macroparticle charge: electron charge density me => wpe^2 =
    # rho_e * |q_m_e| = me * (1/me) = 1
    weight = me * (Lx * 1.0 * Lz) / n_part

    sim.inject_particle(
        electron, x, y, z,
        rng.normal(0, vthe, n_part) + vdx * we * c,
        rng.normal(0, vthe, n_part) + vdy * we * c,
        rng.normal(0, vthe, n_part),
        q=-weight)
    sim.inject_particle(
        ion, x, y, z,
        rng.normal(0, vthi, n_part) - vdx * (1 - we) * c,
        rng.normal(0, vthi, n_part) - vdy * (1 - we) * c,
        rng.normal(0, vthi, n_part),
        q=weight)

    # -- tracers: zero-charge tagged copies of the first electrons
    # (tag_tracer/hijack_tracers, decks/trecon-part/tracer.cxx:1-333) --
    ntr = min(1024, n_part)
    sim.inject_particle(
        tracer, x[:ntr], y[:ntr], z[:ntr],
        rng.normal(0, vthe, ntr), rng.normal(0, vthe, ntr),
        rng.normal(0, vthe, ntr),
        q=0.0, tag=np.arange(1, ntr + 1))

    sim.opts = StepOptions(
        clean_div_e_interval=25,
        clean_div_b_interval=25,
        sync_shared_interval=25,
    )
    sim.num_step = _env("TRECON_STEPS", 200)
    sim._trecon_vth = (vthe, vthi)
    return sim


OUT = os.environ.get("TRECON_OUT", "trecon_out")
ENERGY_INTERVAL = _env("TRECON_ENERGY_INTERVAL", 20)
FIELD_INTERVAL = _env("TRECON_FIELD_INTERVAL", 0)
TRACER_INTERVAL = _env("TRECON_TRACER_INTERVAL", 0)
SPECTRUM_INTERVAL = _env("TRECON_SPECTRUM_INTERVAL", 0)
NEX = _env("TRECON_NEX", 50)           # energy bands (global->nex)
EMAX = _env("TRECON_EMAX", 400.0, float)  # in units of vth^2/2


def diagnostics(sim):
    """begin_diagnostics analogue (turbulence.cxx:1015-1247)."""
    s = sim.step_count
    if ENERGY_INTERVAL and s % ENERGY_INTERVAL == 0:
        sim.dump_energies(f"{OUT}/energies.txt")
    if FIELD_INTERVAL and s % FIELD_INTERVAL == 0:
        sim.dump_fields(f"{OUT}/fields/fields")
        sim.dump_hydro("electron", f"{OUT}/hydro/ehydro")
        sim.dump_hydro("ion", f"{OUT}/hydro/ihydro")
    if TRACER_INTERVAL and s % TRACER_INTERVAL == 0:
        sim.dump_particles("e_tracer", f"{OUT}/tracer/tracer")
    if SPECTRUM_INTERVAL and s % SPECTRUM_INTERVAL == 0:
        # energy.cxx band distribution + log-KE spectrum per species
        vthe, vthi = getattr(sim, "_trecon_vth", (0.1, 0.05))
        sim.dump_energy_diag("electron", f"{OUT}/hydro", nex=NEX,
                             emax=EMAX, vth=vthe)
        sim.dump_energy_diag("ion", f"{OUT}/hydro", nex=NEX, emax=EMAX,
                             vth=vthi)
