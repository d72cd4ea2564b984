"""Sigma deck — force-free current-sheet reconnection with CONDUCTIVE
walls, the vpic_tpu analogue of decks/trecon-part/sigma.cxx.

What distinguishes it from the periodic trecon/turbulence decks
(sigma.cxx:1-260):

- perfect-electric-conductor field BCs and reflecting particle BCs on
  the two z walls (sigma.cxx:250-256); x (and y) stay periodic,
- the force-free sheet B = b0*tanh(z/L) x_hat +
  sqrt(b0^2(1+bg^2) - Bx^2) y_hat rotated by ``theta`` in the x-y plane
  (sigma.cxx:418-440), seeded with the single long-wavelength flux
  perturbation DBX/DBZ (no turbulence spectrum),
- the RELATIVISTIC drifting-Maxwellian load: field-aligned thermal
  momenta (upa, upe, uz) boosted by the sheet drift with the Lorentz
  factor GVD = 1/sqrt(1 - VD^2) so each species carries exactly its half
  of the force-free current (sigma.cxx:474-523),
- in-deck energy-band spectrum diagnostics per species (the edata
  machinery, sigma.cxx:11-15 + energy.cxx) and tagged tracers
  (rank << 19 | count tags, sigma.cxx:530-537).

The port's copy of ``decks/sigma.py``: the same knobs, the same numpy
random stream (so both packages load identical particles) and the same
``diagnostics(sim)``; ``deck(device)`` builds it on the card unless
``device="cpu"`` is asked for.

Knobs via environment (the config.h pattern):
  SIGMA_NX/NZ, SIGMA_PPC, SIGMA_STEPS, SIGMA_PX/PZ, SIGMA_THETA,
  SIGMA_OUT, SIGMA_VTHE (default 0.6c — sigma decks are relativistic)
Run:  python -m vpic_tpu_torch.cli.run vpic_tpu_torch/decks/sigma.py \
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


def deck(device="cuda"):
    nx = _env("SIGMA_NX", 256)
    nz = _env("SIGMA_NZ", 128)
    ppc = _env("SIGMA_PPC", 64)
    px = _env("SIGMA_PX", 1)
    pz = _env("SIGMA_PZ", 1)
    theta = _env("SIGMA_THETA", 0.0, float)     # B rotation (degrees)

    # physics parameters (sigma.cxx:95-160, normalized so wpe = 1):
    # high vthe/wpe_wce < 1 puts this in the high-sigma (magnetically
    # dominated) regime the deck is named for.
    mi_me = 25.0
    vthe = _env("SIGMA_VTHE", 0.6, float)       # electron thermal speed /c
    Ti_Te = 1.0
    wpe_wce = 0.1                               # wpe/wce < 1: sigma >> 1
    bg = 1e-6                                   # (near-)zero guide field
    c = 1.0

    me = 1.0 / mi_me
    mi = 1.0
    wce = 1.0 / wpe_wce                         # wpe = 1
    b0 = me * c * wce
    di = c * math.sqrt(mi_me)
    L = (6.0 / math.sqrt(mi_me)) * di           # sheet thickness (L_di*di)
    vthi = vthe * math.sqrt(Ti_Te * me / mi)

    Lx = 2.0 * L * 2 * math.pi / 4
    Lz = Lx / 2
    Lpert = Lx

    cs, sn = math.cos(math.radians(theta)), math.sin(math.radians(theta))

    sim = Simulation(seed=_env("SIGMA_SEED", 11), device=device)
    sim.define_units(cvac=c, eps0=1.0)
    dt = min(0.95 * sim.courant_length(Lx, 1.0, Lz, nx, 1, nz), 0.7)
    sim.define_timestep(dt)
    sim.define_periodic_grid(0, 0, -0.5 * Lz, Lx, 1.0, 0.5 * Lz,
                             nx, 1, nz, px, 1, pz)
    sim.define_material("vacuum")

    # conductive z walls (sigma.cxx:250-256): pec fields + reflecting
    # particles on faces 2 (-z) and 5 (+z)
    sim.set_domain_field_bc(2, PEC_FIELDS)
    sim.set_domain_field_bc(5, PEC_FIELDS)
    sim.set_domain_particle_bc(2, "reflect")
    sim.set_domain_particle_bc(5, "reflect")

    n_part = nx * nz * ppc
    electron = sim.define_species("electron", -1.0 / me, int(1.5 * n_part))
    ion = sim.define_species("ion", 1.0 / mi, int(1.5 * n_part))
    e_tracer = sim.define_species("e_tracer", -1.0 / me, 8192)
    i_tracer = sim.define_species("i_tracer", 1.0 / mi, 8192)

    # -- fields: rotated force-free sheet + flux perturbation
    # (sigma.cxx:418-440) --
    dbz = 0.03 * b0
    dbx = -dbz * Lpert / (2.0 * Lz)

    def BX(z):
        return b0 * np.tanh(z / L)

    def BY(z):
        bx = BX(z)
        return np.sqrt(b0 * b0 + bg * bg * b0 * b0 - bx * bx)

    def DBX(x, z):
        return dbx * np.cos(2 * np.pi * (x - 0.5 * Lx) / Lpert) \
            * np.sin(np.pi * z / Lz)

    def DBZ(x, z):
        return dbz * np.cos(np.pi * z / Lz) \
            * np.sin(2 * np.pi * (x - 0.5 * Lx) / Lpert)

    sim.set_field("cbx", lambda x, y, z: (BX(z) + DBX(x, z)) * cs
                  + BY(z) * sn)
    sim.set_field("cby", lambda x, y, z: -(BX(z) + DBX(x, z)) * sn
                  + BY(z) * cs)
    sim.set_field("cbz", lambda x, y, z: DBZ(x, z))

    # -- particles: relativistic drifting Maxwellians
    # (sigma.cxx:426-428 drift profile, :474-523 boosted load) --
    rng = np.random.default_rng(_env("SIGMA_SEED", 11) + 1)
    x = rng.uniform(0, Lx, n_part)
    y = rng.uniform(0, 1.0, n_part)
    z = rng.uniform(-0.5 * Lz, 0.5 * Lz, n_part)

    bx, by = BX(z), BY(z)
    vdy = -0.5 * (b0 / L) / np.cosh(z / L) ** 2
    vdx = vdy * bx / by
    vd = np.sqrt(vdx * vdx + vdy * vdy)
    vd = np.maximum(vd, 1e-30)                     # avoid 0/0 at |z|>>L
    gvd = 1.0 / np.sqrt(1.0 - vd * vd / (c * c))

    weight = me * (Lx * 1.0 * Lz) / n_part

    def boosted(vth, sign):
        """The deck's field-aligned boost (sigma.cxx:479-487/505-513):
        thermal momenta (upa along the drift, upe across it, uz out of
        plane) rotated into x-y by the drift direction and boosted by
        sign*GVD*VD."""
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
    sim.inject_particle(electron, x, y, z,
                        uxe * cs + uye * sn, -uxe * sn + uye * cs, uze,
                        q=-weight)
    uxi, uyi, uzi = boosted(vthi, -1.0)
    sim.inject_particle(ion, x, y, z,
                        uxi * cs + uyi * sn, -uxi * sn + uyi * cs, uzi,
                        q=weight)

    # -- tracers: q=0 tagged copies, rank<<19 | count tags
    # (tag_tracer, sigma.cxx:530-537) --
    ntr = min(2048, n_part)
    tags = (0 << 19) | np.arange(1, ntr + 1)
    sim.inject_particle(e_tracer, x[:ntr], y[:ntr], z[:ntr],
                        uxe[:ntr], uye[:ntr], uze[:ntr], q=0.0, tag=tags)
    sim.inject_particle(i_tracer, x[:ntr], y[:ntr], z[:ntr],
                        uxi[:ntr], uyi[:ntr], uzi[:ntr], q=0.0, tag=tags)

    # sigma.cxx:199-203: status/2 cadence for cleans and face sync
    sim.opts = StepOptions(
        clean_div_e_interval=100,
        clean_div_b_interval=100,
        sync_shared_interval=100,
    )
    sim.num_step = _env("SIGMA_STEPS", 200)
    sim._sigma_vth = (vthe, vthi)
    return sim


OUT = os.environ.get("SIGMA_OUT", "sigma_out")
ENERGY_INTERVAL = _env("SIGMA_ENERGY_INTERVAL", 100)
FIELD_INTERVAL = _env("SIGMA_FIELD_INTERVAL", 0)
PARTICLE_INTERVAL = _env("SIGMA_PARTICLE_INTERVAL", 0)
RESTART_INTERVAL = _env("SIGMA_RESTART_INTERVAL", 0)
TRACER_INTERVAL = _env("SIGMA_TRACER_INTERVAL", 0)
SPECTRUM_INTERVAL = _env("SIGMA_SPECTRUM_INTERVAL", 0)
NEX = _env("SIGMA_NEX", 200)             # energy bins (global->nex)
EMAX = _env("SIGMA_EMAX", 120.0, float)  # max energy in me*c^2 units


def diagnostics(sim):
    """begin_diagnostics analogue (sigma.cxx:800-1100): the standard
    production inventory (rundata + global header at step 0, energies,
    banded field/hydro dumps, particle dumps, rotating restart) via
    ``Simulation.standard_diagnostics``, plus the deck-specific tracer
    dumps and energy-band spectra."""
    std = getattr(sim, "_sigma_std_diag", None)
    if std is None:
        std = sim.standard_diagnostics(
            OUT, energies_interval=ENERGY_INTERVAL,
            fields_interval=FIELD_INTERVAL,
            particle_interval=PARTICLE_INTERVAL,
            particle_species=("electron", "ion"),
            restart_interval=RESTART_INTERVAL)
        sim._sigma_std_diag = std
    std()
    s = sim.step_count
    if TRACER_INTERVAL and s % TRACER_INTERVAL == 0:
        sim.dump_particles("e_tracer", f"{OUT}/tracer/etracer")
        sim.dump_particles("i_tracer", f"{OUT}/tracer/itracer")
    if SPECTRUM_INTERVAL and s % SPECTRUM_INTERVAL == 0:
        vthe, vthi = getattr(sim, "_sigma_vth", (0.6, 0.12))
        sim.dump_energy_diag("electron", f"{OUT}/spectra", nex=NEX,
                             emax=EMAX, vth=vthe)
        sim.dump_energy_diag("ion", f"{OUT}/spectra", nex=NEX, emax=EMAX,
                             vth=vthi)
