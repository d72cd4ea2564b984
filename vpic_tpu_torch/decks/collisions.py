"""Collisional warm-plasma deck: the ``user_particle_collisions`` deck
section (the reference's hook, src/vpic/advance.cxx:67, installed by
``begin_particle_collisions``, src/deck_wrapper.cxx:16-36; the reference
ships no collision model, so the section is user code and this deck is
the example of writing one).

The port's copy of ``decks/collisions.py``: the same knobs and the same
numpy load (both packages load identical particles); ``deck(device)``
builds it on the card unless ``device="cpu"`` is asked for.  The hook is
written in torch and draws from the state's random state
(``core/random.py``), so its angles differ from the JAX package's.

Model: per-step pitch-angle (Lorentz) scattering with collision frequency
``nu``: each particle's momentum is rotated by a Gaussian angle of
variance 2*nu*dt about a random axis perpendicular to it
(:func:`rotate_momenta`, a function of the draws theta and phi).
Rotations keep |u|, so the species' kinetic energy is conserved to float
roundoff while the momenta isotropize.

Knobs via environment: COLL_NX, COLL_PPC, COLL_NU, COLL_SEED, COLL_STEPS.
Run:  python -m vpic_tpu_torch.cli.run vpic_tpu_torch/decks/collisions.py \\
          --num-step 100
"""

import dataclasses
import math
import os

import numpy as np
import torch

from vpic_tpu_torch import Simulation
from vpic_tpu_torch.core import random as rnd


def _env(name, default, cast=int):
    return cast(os.environ.get(name, default))


def rotate_momenta(ux, uy, uz, theta, phi):
    """(ux, uy, uz) rotated by the polar angle ``theta`` about an axis
    perpendicular to u at azimuth ``phi``, in the JAX deck's float32
    operation order (decks/collisions.py:36-79); |u| = 0 lanes get
    non-finite values, which the hook does not keep."""
    u2 = ux * ux + uy * uy + uz * uz
    u = torch.sqrt(u2)
    safe = torch.where(u > 1e-30, u, 1.0)
    wx, wy, wz = ux / safe, uy / safe, uz / safe
    # a helper axis not parallel to u
    use_x = torch.abs(wx) < 0.9
    hx = torch.where(use_x, 1.0, 0.0)
    hy = torch.where(use_x, 0.0, 1.0)
    # e1 = w x h normalized, e2 = w x e1
    e1x = wy * 0.0 - wz * hy
    e1y = wz * hx - wx * 0.0
    e1z = wx * hy - wy * hx
    n1 = torch.sqrt(e1x * e1x + e1y * e1y + e1z * e1z)
    n1 = torch.where(n1 > 1e-30, n1, 1.0)
    e1x, e1y, e1z = e1x / n1, e1y / n1, e1z / n1
    e2x = wy * e1z - wz * e1y
    e2y = wz * e1x - wx * e1z
    e2z = wx * e1y - wy * e1x
    ct, st = torch.cos(theta), torch.sin(theta)
    cp, sp = torch.cos(phi), torch.sin(phi)
    dx = st * (cp * e1x + sp * e2x)
    dy = st * (cp * e1y + sp * e2y)
    dz = st * (cp * e1z + sp * e2z)
    return u * (ct * wx + dx), u * (ct * wy + dy), u * (ct * wz + dz)


def make_pitch_angle_collisions(nu_dt: float, species_ids=None):
    """The collision hook ``state -> state``: every live lane with u != 0
    of the chosen species (all by default) rotated by theta ~ N(0,
    2 nu dt) and phi uniform in [0, 2 pi)."""
    scale = float(np.float32(math.sqrt(float(np.float32(2.0 * nu_dt)))))

    def rotate(sp, key):
        n, dev = sp.max_np, sp.ux.device
        theta = scale * rnd.normal(rnd.fold(key, 0), n, dev)
        phi = rnd.uniform(rnd.fold(key, 1), n, 0.0, 2.0 * math.pi, dev)
        nux, nuy, nuz = rotate_momenta(sp.ux, sp.uy, sp.uz, theta, phi)
        keep = sp.alive & ((sp.ux * sp.ux + sp.uy * sp.uy
                            + sp.uz * sp.uz) > 0)
        return sp.replace(ux=torch.where(keep, nux, sp.ux),
                          uy=torch.where(keep, nuy, sp.uy),
                          uz=torch.where(keep, nuz, sp.uz))

    def hook(state):
        rng, key = rnd.split(state.rng)
        species = tuple(
            rotate(sp, rnd.fold(key, k))
            if species_ids is None or sp.sid in species_ids else sp
            for k, sp in enumerate(state.species))
        return dataclasses.replace(state, species=species, rng=rng)

    return hook


def deck(device="cuda"):
    nx = _env("COLL_NX", 32)
    ppc = _env("COLL_PPC", 64)
    nu = _env("COLL_NU", 0.05, float)

    L = 1.0
    sim = Simulation(seed=_env("COLL_SEED", 11), device=device)
    sim.define_units(1.0, 1.0)
    dt = 0.9 * sim.courant_length(L, L, L, nx, nx, 1)
    sim.define_timestep(dt)
    sim.define_periodic_grid(0, 0, 0, L, L, L, nx, nx, 1)
    sim.define_material("vacuum")
    n = nx * nx * ppc
    e = sim.define_species("electron", -1.0, int(n * 1.25))

    # an anisotropic load: collisions must isotropize it
    sim.inject_particle(
        e, sim.uniform(n, 0, L), sim.uniform(n, 0, L), sim.uniform(n, 0, L),
        sim.maxwellian(n, 0.2), sim.maxwellian(n, 0.05),
        sim.maxwellian(n, 0.05), q=-1.0 / n)

    sim.finalize(
        user_particle_collisions=make_pitch_angle_collisions(nu * dt))
    return sim


def anisotropy(sim):
    """<ux^2> / <(uy^2 + uz^2)/2> over the live electrons."""
    sp = sim.state.species[0]
    alive = sp.alive
    ux2 = torch.mean(sp.ux[alive].double() ** 2)
    up2 = torch.mean(sp.uy[alive].double() ** 2
                     + sp.uz[alive].double() ** 2) / 2
    return float(ux2 / up2)


if __name__ == "__main__":
    sim = deck(device=os.environ.get("COLL_DEVICE", "cuda"))
    steps = _env("COLL_STEPS", 50)
    print(f"anisotropy before: {anisotropy(sim):.2f}")
    sim.advance(steps)
    print(f"anisotropy after {steps} steps: {anisotropy(sim):.2f}")
    print("energies:", sim.energies())
