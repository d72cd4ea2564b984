"""The benchmark deck of the JAX package (``__graft_entry__._build``, built
by ``bench.py``) for the port: a closed periodic box with electrons and
ions and a force-free current-sheet field, on one device.

Same arguments and the same numpy random stream (``seed + 1``) as
``_build``, so both packages load bit-identical particles.  The bench
configuration is ``build(nx=128, ny=128, nz=1, npart=2_000_000)``: 128^2
cells, 2M particles per species, re-sort every 2 steps, ions every 8, on
the card (``device="cpu"`` for the CPU).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..deck.api import Simulation


def build(nx, ny, nz, npart, px=1, py=1, pz=1, seed=0, device="cuda",
          resort_interval=2, ion_sort_mult=4, n_walk=None) -> Simulation:
    sim = Simulation(seed=seed, device=device)
    sim.opts = dataclasses.replace(sim.opts, resort_interval=resort_interval)
    if n_walk is not None:
        sim.opts = dataclasses.replace(sim.opts, n_walk=n_walk)
    sim.define_units(1.0, 1.0)
    L = 1.0
    sim.define_timestep(0.9 * sim.courant_length(L, L, L, nx, ny, nz))
    sim.define_periodic_grid(0, 0, 0, L, L, L, nx, ny, nz, px, py, pz)
    sim.define_material("vacuum")
    # a closed single-device box conserves np, so capacity rides close to
    # the live count
    cap = 1.0625
    e = sim.define_species("electron", -1.0, int(npart * cap))
    # ions are 25x heavier / 5x slower: sorted every ion_sort_mult-th
    # resort cycle (the reference's per-species sort_interval)
    i = sim.define_species("ion", 1.0 / 25.0, int(npart * cap),
                           sort_interval=ion_sort_mult * resort_interval)

    rng = np.random.default_rng(seed + 1)
    x, y, z = (rng.uniform(0, L, npart) for _ in range(3))
    for sp, sgn, ut in ((e, -1.0, 0.2), (i, 1.0, 0.04)):
        sim.inject_particle(sp, x, y, z,
                            rng.normal(0, ut, npart),
                            rng.normal(0, ut, npart),
                            rng.normal(0, ut, npart),
                            q=sgn / npart)
    # force-free current sheet flavored initial field
    sim.set_field("cbx", lambda x, y, z: 0.1 * np.tanh((y - 0.5) / 0.1))
    sim.set_field("cbz", lambda x, y, z: 0.1 / np.cosh((y - 0.5) / 0.1))
    sim.finalize()
    return sim
