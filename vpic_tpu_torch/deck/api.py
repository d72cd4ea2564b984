"""Deck API of the port (``vpic_tpu/deck/api.py``; the reference's deck
vocabulary, vpic.hxx:126-555): periodic or local field faces; periodic,
reflecting, absorbing or custom particle faces (``define_boundary``:
``MaxwellianReflux``, ``AbsorbTally``, ``LinkBoundary``); one shard or
several (``px, py, pz``); surface and volume emitters; particles injected at
set-up and, through ``make_injector`` from the ``user_particle_injection``
hook, during the run; the four ``user_*`` hooks of ``finalize``; any
number of materials (``define_material``: eps, mu, sigma and zeta as
scalars or per-axis triples) placed by ``set_region_material``, the last
region to claim a point winning.

    sim = Simulation(seed=0, device="cuda")
    sim.define_units(1.0, 1.0)
    sim.define_timestep(dt)
    sim.define_periodic_grid(0, 0, 0, L, L, L, nx, ny, nz)
    sim.set_domain_field_bc(2, PEC_FIELDS)
    sim.set_domain_particle_bc(2, "reflect")
    sim.define_material("vacuum")
    e = sim.define_species("electron", -1.0, max_np)
    copper = sim.define_material("copper", sigma=5.0)
    sim.set_region_material(lambda x, y, z: x > 0.75, copper)
    sim.inject_particle(e, x, y, z, ux, uy, uz, q)
    sim.set_field("cbx", lambda x, y, z: ...)
    sim.finalize()
    sim.advance(16)
    sim.energies(), sim.mover_counts()

An open deck (absorbing walls and drifting electrons):

    sim.define_absorbing_grid(0, 0, 0, L, L, L, nx, ny, 1)
    tally = sim.define_boundary(AbsorbTally(n_species=1))
    sim.set_domain_particle_bc(0, tally)
    sim.define_surface_emitter(ChildLangmuir(sid=0, q_m=-1.0,
                                             components=((), ())), face=0)
    sim.finalize(user_particle_injection=refill)
    sim.boundary_tallies(tally)

A sharded deck gives ``px, py, pz`` to ``define_*_grid`` (and may rewire
a sharded axis with ``join_domain``): ``finalize(devices=...)`` builds one
state per shard, shard r on ``devices[r % len(devices)]`` (default: every
shard on the simulation's device), and ``state`` is then the list of
per-shard states in rank order (``states`` is that list on any deck).
Every shard steps in its own thread (``engine/distributed.py``); the
diagnostics sum over the shards and the dumps write one file per rank.

``advance`` runs a plain loop of steps with the per-species sort cadence
of :func:`vpic_tpu_torch.engine.step.step_sort_flags`; the host's step
count sets the interval cleans.  ``modify_runparams(fused_push=False)`` or
``(merge_sort=True)`` switches the push path of a built deck.  Under
``merge_sort=True`` (with the fused push) the species ride the packed
cycle: packed on the first step, kept packed between ``advance`` calls
with the merge re-sort's carry, unpacked into a copy when ``state`` is
read (an edit to that copy is not taken back: assign ``state`` to change
the state, which packs it again without the carry).

The diagnostics (energies, V0 and banded dumps, hydro, particles, the
energy-band spectra, checksums, tracer trajectories), ``standard_diagnostics``
and the checkpoints copy the state to the host only where a file needs it.
"""

from __future__ import annotations

import collections
import dataclasses
import math
import os
import warnings
from typing import List, Optional

import numpy as np
import torch

from ..boundary.models import BoundaryHandler, handler_code
from ..comm.facecomm import OPP
from ..core import diagnostics
from ..core import random as rnd
from ..core.types import (
    ABSORB_FIELDS,
    ANTI_SYMMETRIC_FIELDS,
    FACE_AXIS,
    FieldState,
    Grid,
    MATERIAL_COLUMNS,
    MATERIAL_ID_FIELDS,
    MaterialGrid,
    MaterialTable,
    NEIGHBOR_ABSORB,
    NEIGHBOR_REFLECT,
    PERIODIC_FIELDS,
    PackedSpecies,
    SimState,
    SpeciesState,
)
from ..diag import energy_dist as ed
from ..emit import models as emodels
from ..engine import distributed as dist
from ..engine import graphs, spans
from ..engine.step import (StepOptions, cycle_mult, graph_sort_flags,
                           make_advance, needs_boundary, resolve_paths,
                           step_sort_flags)
from ..field import stencil
from ..field.slabs import own_slice
from ..grid.partition import make_grid_arrays, shard_origin
from ..io import banded
from ..io import checkpoint as ckpt
from ..io import dump as iodump
from ..io import energies as ioenergies
from ..io import tracers as iotracers
from ..io.global_header import write_global_header
from ..particles import aux as paux
from ..particles import push as ppush
from . import inject as dinject


@dataclasses.dataclass
class _Material:
    """A material as defined (material_t, material.c): its id and the
    per-axis permittivity, permeability, conductivity and magnetic
    conductivity, in the deck's units."""

    name: str
    id: int
    epsx: float; epsy: float; epsz: float
    mux: float; muy: float; muz: float
    sigmax: float; sigmay: float; sigmaz: float
    zetax: float; zetay: float; zetaz: float


def _as3(v):
    """A scalar as (v, v, v), or a 3-sequence as a tuple of floats."""
    if np.isscalar(v):
        return (float(v),) * 3
    v = tuple(float(x) for x in v)
    if len(v) != 3:
        raise ValueError(f"a material parameter takes 1 or 3 values, not "
                         f"{len(v)}")
    return v


def build_material_table(materials: List[_Material], g: Grid,
                         device="cpu") -> MaterialTable:
    """The FDTD coefficients of each material (new_material_coefficients,
    standard/sfa.c:138-174), computed in float64 and rounded once to
    float32: per axis with a = sigma dt / (eps eps0), decay = exp(-a) and
    drive = 2 exp(-a/2) sinh(a/2) / (a eps) (1/eps where a = 0, 0 where
    decay underflows to 0); rmu = 1/mu; nonconductive is 0 where any
    sigma is nonzero."""
    n = len(materials)
    cols = {k: np.zeros((n,), np.float32) for k in MATERIAL_COLUMNS}
    for m in materials:
        i = m.id
        conductive = False
        for c in "xyz":
            eps, sigma = getattr(m, "eps" + c), getattr(m, "sigma" + c)
            a = (sigma * g.dt) / (eps * g.eps0)
            decay = math.exp(-a)
            if a == 0:
                drive = 1.0 / eps
            elif decay == 0:
                drive = 0.0
            else:
                drive = (2.0 * math.exp(-0.5 * a) * math.sinh(0.5 * a)
                         / (a * eps))
            cols["decay" + c][i] = decay
            cols["drive" + c][i] = drive
            cols["eps" + c][i] = eps
            cols["rmu" + c][i] = 1.0 / getattr(m, "mu" + c)
            conductive |= a != 0
        cols["nonconductive"][i] = 0.0 if conductive else 1.0
    return MaterialTable(**{k: torch.as_tensor(v, device=device)
                            for k, v in cols.items()})


_PBC_MAP = {"periodic": PERIODIC_FIELDS, "absorb": NEIGHBOR_ABSORB,
            "reflect": NEIGHBOR_REFLECT}

_KIND_OF = {
    "ex": "edge_x", "ey": "edge_y", "ez": "edge_z",
    "cbx": "face_x", "cby": "face_y", "cbz": "face_z",
    "jfx": "edge_x", "jfy": "edge_y", "jfz": "edge_z",
    "rhof": "node", "rhob": "node",
}


class Simulation:
    """Top-level simulation object (vpic_simulation analogue) on the card
    unless ``device="cpu"`` is asked for.  A CUDA device raises when no
    GPU is available."""

    def __init__(self, seed: int = 0, device="cuda"):
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"Simulation(device={str(device)!r}): no "
                               "CUDA device is available")
        self.device = device
        self.seed = seed
        # the deck's numpy stream (maxwellian, uniform): the JAX package's,
        # so both packages load identical particles
        self.rng = np.random.default_rng(seed)
        self.cvac = 1.0
        self.eps0 = 1.0
        self.dt = 0.0
        self.num_step = 0
        self.grid: Optional[Grid] = None
        self.materials: List[_Material] = []
        self._material_regions: List[tuple] = []
        self._species: List[dict] = []
        self._field_sets: List[tuple] = []
        self.opts = StepOptions()
        self._hooks: dict = {}
        self._boundary_handlers: list = []
        self._emitters: list = []
        self._advance_packed = None
        # under the packed cycle the newest state is the eager packed
        # mirror (_pstate), the graphs' static buffers (_static_packed) or,
        # before the first step, the caller's unpacked states
        self._pstate = None
        self._static_packed = False
        # the step as CUDA graphs (engine/graphs.py), where _graph_ok()
        # admits the deck; the cycle multiple M of its dispatch plan
        self._graphs = None
        self._cycle_mult = 1
        # steps taken eagerly and through graphs, graphs captured and
        # replayed (per unit kind); the seconds of each capture
        self.dispatch_counts = collections.Counter()
        self.capture_times: list = []
        self._traj = None
        self.states: List[SimState] = []
        self.step_count = 0
        # per shard, in rank order: its device and its ShardComm, set by
        # finalize
        self.mesh = [device]
        self.comms: list = []

    # -- units / time ----------------------------------------------------
    def define_units(self, cvac: float, eps0: float):
        self.cvac, self.eps0 = float(cvac), float(eps0)

    def define_timestep(self, dt: float):
        self.dt = float(dt)

    def courant_length(self, lx, ly, lz, nx, ny, nz):
        """vpic.hxx:537-544."""
        w = 0.0
        if nx > 1:
            w += (nx / lx) ** 2
        if ny > 1:
            w += (ny / ly) ** 2
        if nz > 1:
            w += (nz / lz) ** 2
        return 1.0 / math.sqrt(w)

    # -- grid / materials / species ----------------------------------------
    def define_periodic_grid(self, x0, y0, z0, x1, y1, z1, nx, ny, nz,
                             px=1, py=1, pz=1):
        """partition_periodic_box (partition.c:36-85): ``nx, ny, nz``
        global cells on ``px, py, pz`` shards."""
        return self._make_grid(x0, y0, z0, x1, y1, z1, nx, ny, nz,
                               (px, py, pz), PERIODIC_FIELDS,
                               PERIODIC_FIELDS)

    def define_absorbing_grid(self, x0, y0, z0, x1, y1, z1, nx, ny, nz,
                              px=1, py=1, pz=1, pbc="absorb"):
        """partition_absorbing_box (partition.c:88-140): absorbing fields
        on every face, particles ``pbc``."""
        return self._make_grid(x0, y0, z0, x1, y1, z1, nx, ny, nz,
                               (px, py, pz), ABSORB_FIELDS, _PBC_MAP[pbc])

    def define_reflecting_grid(self, x0, y0, z0, x1, y1, z1, nx, ny, nz,
                               px=1, py=1, pz=1):
        """partition_metal_box (partition.c:142-177)."""
        return self._make_grid(x0, y0, z0, x1, y1, z1, nx, ny, nz,
                               (px, py, pz), ANTI_SYMMETRIC_FIELDS,
                               NEIGHBOR_REFLECT)

    def _make_grid(self, x0, y0, z0, x1, y1, z1, nx, ny, nz, shards, fbc,
                   pbc):
        px, py, pz = (int(p) for p in shards)
        if min(px, py, pz) < 1 or nx % px or ny % py or nz % pz:
            raise ValueError(f"{(nx, ny, nz)} cells do not split into "
                             f"{(px, py, pz)} equal shards")
        self.grid = Grid(nx=nx // px, ny=ny // py, nz=nz // pz, dt=self.dt,
                         cvac=self.cvac, eps0=self.eps0, gx0=x0, gy0=y0,
                         gz0=z0, gx1=x1, gy1=y1, gz1=z1, gpx=px, gpy=py,
                         gpz=pz, fbc=(fbc,) * 6, pbc=(pbc,) * 6)
        return self.grid

    def join_domain(self, face: int, neighbors):
        """Custom wiring of a sharded axis (join_domain, vpic.hxx:313-331;
        grid/ops.c join_grid): ``neighbors[s]`` is the axis position of
        the shard adjacent through ``face`` to the shard at position s.
        Joined faces are interior: field halos and migrating lanes follow
        the wiring and no local boundary applies.  Wire both opposite
        faces consistently."""
        g = self.grid
        n = (g.gpx, g.gpy, g.gpz)[FACE_AXIS[face]]
        neighbors = tuple(int(v) for v in neighbors)
        if n < 2:
            raise ValueError("join_domain needs a sharded axis")
        if sorted(neighbors) != list(range(n)):
            raise ValueError(f"neighbors must be a permutation of 0..{n - 1}")
        join = list(g.join)
        join[face] = neighbors
        opp = join[OPP[face]]
        if opp is not None and any(opp[t] != s
                                   for s, t in enumerate(neighbors)):
            raise ValueError("the wiring disagrees with the opposite face's")
        self.grid = dataclasses.replace(g, join=tuple(join))
        return self.grid

    def set_domain_field_bc(self, face: int, bc: int):
        """set_fbc analogue (src/grid/ops.c)."""
        fbc = list(self.grid.fbc)
        fbc[face] = bc
        self.grid = dataclasses.replace(self.grid, fbc=tuple(fbc))

    def set_domain_particle_bc(self, face: int, bc):
        """set_pbc analogue; ``bc`` is 'periodic', 'absorb', 'reflect', a
        raw code, or a handler registered with :meth:`define_boundary`."""
        if isinstance(bc, BoundaryHandler):
            bc = handler_code(self._boundary_handlers.index(bc), face)
        elif isinstance(bc, str) and bc not in _PBC_MAP:
            raise ValueError(f"unknown particle boundary {bc!r}")
        pbc = list(self.grid.pbc)
        pbc[face] = _PBC_MAP.get(bc, bc)
        self.grid = dataclasses.replace(self.grid, pbc=tuple(pbc))

    def define_boundary(self, handler):
        """Register a custom particle boundary handler (add_boundary,
        src/grid/add_boundary.c:9-32); use it with
        :meth:`set_domain_particle_bc`."""
        self._boundary_handlers.append(handler)
        return handler

    def define_surface_emitter(self, model, face=None, components=None,
                               region=None):
        """Register a surface emitter (define_surface_emitter,
        deck_wrapper.cxx:390-463) on every cell of a domain ``face``, on
        an explicit (vox, face) component list, or on every exterior-cell
        face that touches ``region(x, y, z)``."""
        if components is None:
            if region is not None:
                vox, faces = emodels.region_surface_components(self.grid,
                                                               region)
                components = (tuple(vox.tolist()), tuple(faces.tolist()))
            else:
                if face is None:
                    raise ValueError("give a face, components or a region")
                vox = emodels.domain_face_components(self.grid, face)
                components = (tuple(vox.tolist()), (face,) * len(vox))
        model = dataclasses.replace(model, components=components)
        model.bind(self.grid)
        self._emitters.append(model)
        return model

    def define_volume_emitter(self, model, region):
        """Register a volume emitter (define_volume_emitter,
        deck_wrapper.cxx:346-383): every cell inside ``region(x, y, z)``
        becomes a face-less component (face = -1), which the face laws
        skip."""
        vox, faces = emodels.region_volume_components(self.grid, region)
        model = dataclasses.replace(
            model, components=(tuple(vox.tolist()), tuple(faces.tolist())))
        model.bind(self.grid)
        self._emitters.append(model)
        return model

    def define_material(self, name, eps=1.0, mu=1.0, sigma=0.0, zeta=0.0):
        """A material with the next id (define_material, vpic.hxx);
        ``eps``, ``mu``, ``sigma`` and ``zeta`` are scalars or per-axis
        triples.  Material 0 fills every point that no region claims."""
        m = _Material(name, len(self.materials), *_as3(eps), *_as3(mu),
                      *_as3(sigma), *_as3(zeta))
        self.materials.append(m)
        return m

    def set_region_material(self, region_fn, material):
        """Give ``material`` to every point of the id sublattices (E
        edges, nodes, B faces, cell centres) whose position satisfies
        ``region_fn(x, y, z)`` (set_region_material,
        deck_wrapper.cxx:119-227).  Regions apply in order, so a later one
        wins where two overlap; the ghost planes keep material 0."""
        self._material_regions.append((region_fn, material.id))

    def define_species(self, name, q_m, max_np, sort_interval=0):
        # capacity rounded up to whole 1024-slot blocks, as the JAX package
        # does, so both packages hold the same slots
        h = dict(name=name, sid=len(self._species), q_m=float(q_m),
                 max_np=-(-int(max_np) // 1024) * 1024,
                 sort_interval=int(sort_interval), batches=[])
        self._species.append(h)
        return h

    def set_field(self, comp: str, fn):
        """comp = fn(x, y, z) over its owned sublattice."""
        if comp not in _KIND_OF:
            raise ValueError(f"unknown field component {comp!r}")
        self._field_sets.append((comp, fn))

    def component_coords(self, comp: str, shard=(0, 0, 0)):
        """Sparse [z,y,x] meshgrids of the positions of one component's
        owned sublattice on one shard (deck_wrapper.cxx:467-503)."""
        g = self.grid
        kind = _KIND_OF[comp]
        axes = []
        for a, (gmin, d, n) in enumerate(((g.gx0, g.dx, g.nx),
                                          (g.gy0, g.dy, g.ny),
                                          (g.gz0, g.dz, g.nz))):
            sl = own_slice(g, kind, a)
            idx = np.arange(sl.start, sl.stop) + shard[a] * n
            node_aligned = (
                kind == "node"
                or (kind.startswith("edge_") and "xyz".index(kind[-1]) != a)
                or (kind.startswith("face_") and "xyz".index(kind[-1]) == a))
            axes.append(gmin + (idx - 1 + (0.0 if node_aligned else 0.5))
                        * d)
        Z, Y, X = np.meshgrid(axes[2], axes[1], axes[0], indexing="ij")
        return X, Y, Z

    def inject_particle(self, species, x, y, z, ux, uy, uz, q, tag=0,
                        update_rhob=False):
        """Vectorized injection at global coordinates (misc.cxx:16-106);
        placement happens at finalize, where ``update_rhob`` deposits -q
        into rhob (misc.cxx:92-96)."""
        x = np.atleast_1d(np.asarray(x, np.float64))
        arr = lambda v: np.broadcast_to(
            np.atleast_1d(np.asarray(v, np.float64)), x.shape)
        species["batches"].append(dict(
            x=x, y=arr(y), z=arr(z), ux=arr(ux), uy=arr(uy), uz=arr(uz),
            q=arr(q), tag=np.broadcast_to(
                np.atleast_1d(np.asarray(tag, np.int32)), x.shape),
            update_rhob=bool(update_rhob)))

    def make_injector(self, species):
        """The in-step injector of ``species`` (a name or the handle of
        define_species), to call from the ``user_particle_injection``
        hook (``deck/inject.py``)."""
        if self.grid is None:
            raise RuntimeError("define a grid first")
        h = (self._species_by_name(species) if isinstance(species, str)
             else species)
        return dinject.Injector(sid=h["sid"], g=self.grid)

    def maxwellian(self, n, ut):
        """n normal momenta of thermal spread ut from the deck's numpy
        stream (mt_{d,f}randn analogue, mtrand.h:39-146)."""
        return self.rng.normal(0.0, ut, size=n)

    def uniform(self, n, lo, hi):
        return self.rng.uniform(lo, hi, size=n)

    # -- finalize ----------------------------------------------------------
    def _initial_state(self, shard=(0, 0, 0), dev=None) -> SimState:
        """The state of one shard before ``initialize_state``
        (``vpic_tpu/deck/api.py:_build_shard_state``): its field regions,
        its material ids, the injected particles it owns (the far-wall
        rule on the last shard of a local high-x face, misc.cxx:37-40),
        its random state (seed * 65537 + rank)."""
        g = self.grid
        dev = self.device if dev is None else dev
        sx, sy, sz = shard
        lo = shard_origin(g, shard)
        hi = tuple(o + (b - a) / p for o, a, b, p in zip(
            lo, (g.gx0, g.gy0, g.gz0), (g.gx1, g.gy1, g.gz1),
            (g.gpx, g.gpy, g.gpz)))
        field = {k: np.zeros(g.shape, np.float32) for k in _KIND_OF}
        for comp, fn in self._field_sets:
            x, y, z = self.component_coords(comp, shard)
            ix = tuple(own_slice(g, _KIND_OF[comp], a) for a in (2, 1, 0))
            field[comp][ix] = np.broadcast_to(
                np.asarray(fn(x, y, z), np.float32), x.shape)
        f = FieldState.zeros(g, dev).replace(
            **{k: torch.as_tensor(v, device=dev) for k, v in field.items()})

        matg = self._material_grid(shard, dev)

        def cellify(c, c0, c1, n):
            # robust float64 global -> (offset, cell) conversion
            t = n * ((c - c0) / (c1 - c0))
            ic = t.astype(np.int64)
            t = t - ic
            t = (t + t) - 1.0
            far = ic == n
            return np.where(far, 1.0, t), np.where(far, n - 1, ic) + 1

        species = []
        rhob_batches = []
        for h in self._species:
            cols = {k: [] for k in ("dx", "dy", "dz", "i", "ux", "uy", "uz",
                                    "q", "tag")}
            for b in h["batches"]:
                inside = [(b[c] >= lo[a]) & (b[c] < hi[a])
                          for a, c in enumerate("xyz")]
                own = inside[0] & inside[1] & inside[2]
                # far-wall ownership on a local high-x face (misc.cxx:37-40)
                if sx == g.gpx - 1 and g.fbc[3] != PERIODIC_FIELDS:
                    own |= (b["x"] == hi[0]) & inside[1] & inside[2]
                if not own.any():
                    continue
                dxv, ix = cellify(b["x"][own], lo[0], hi[0], g.nx)
                dyv, iy = cellify(b["y"][own], lo[1], hi[1], g.ny)
                dzv, iz = cellify(b["z"][own], lo[2], hi[2], g.nz)
                cols["dx"].append(dxv.astype(np.float32))
                cols["dy"].append(dyv.astype(np.float32))
                cols["dz"].append(dzv.astype(np.float32))
                cols["i"].append((ix + g.nxg * (iy + g.nyg * iz))
                                 .astype(np.int32))
                for k in ("ux", "uy", "uz", "q"):
                    cols[k].append(b[k][own].astype(np.float32))
                cols["tag"].append(b["tag"][own].astype(np.int32))
                if b["update_rhob"]:
                    rhob_batches.append({k: cols[k][-1] for k in
                                         ("i", "q", "dx", "dy", "dz")})
            total = sum(len(c) for c in cols["dx"])
            if total > h["max_np"]:
                raise ValueError(f"species {h['name']}: {total} > max_np "
                                 f"{h['max_np']}")
            sp = SpeciesState.create(h["name"], h["sid"], h["q_m"],
                                     h["max_np"], h["sort_interval"], dev)
            if total:
                upd = {}
                for k, parts in cols.items():
                    buf = torch.zeros_like(getattr(sp, k), device="cpu")
                    buf[:total] = torch.as_tensor(np.concatenate(parts))
                    upd[k] = buf.to(dev)
                sp = sp.replace(np=torch.tensor(total, dtype=torch.int32,
                                                device=dev), **upd)
            species.append(sp)

        for b in rhob_batches:
            t = {k: torch.as_tensor(v, device=dev) for k, v in b.items()}
            f = paux.accumulate_rhob(f, g, t["i"], -t["q"], t["dx"], t["dy"],
                                     t["dz"], torch.ones_like(t["q"],
                                                              dtype=bool))
        return SimState(
            field=f,
            interpolator=torch.zeros((g.nv, 18), dtype=torch.float32,
                                     device=dev),
            species=tuple(species),
            grid_arrays=make_grid_arrays(g, shard, device=dev),
            materials=build_material_table(self.materials, g, dev),
            step=torch.tensor(0, dtype=torch.int32, device=dev),
            rng=rnd.make_key(self.seed * 65537
                             + sx + g.gpx * (sy + g.gpy * sz), dev),
            boundary_state=tuple(h.init_state(len(self._species), dev)
                                 for h in self._boundary_handlers),
            material_grid=matg)

    def _material_grid(self, shard, dev) -> Optional[MaterialGrid]:
        """The id grids of the deck's regions on one shard
        (``vpic_tpu/deck/api.py``'s ``_build_shard_state``): ``emat*``,
        ``nmat`` and ``fmat*`` over their components' owned sublattices,
        ``cmat`` at the cell centres, the ghost planes left at 0; None
        without a region."""
        if not self._material_regions:
            return None
        g = self.grid
        comps = dict(ematx="ex", ematy="ey", ematz="ez", nmat="rhof",
                     fmatx="cbx", fmaty="cby", fmatz="cbz", cmat=None)
        ids = {}
        for name in MATERIAL_ID_FIELDS:
            comp = comps[name]
            arr = np.zeros(g.shape, np.int32)
            if comp is None:
                centres = [g0 + (np.arange(1, n + 1) + s * n - 0.5) * d
                           for g0, n, d, s in ((g.gx0, g.nx, g.dx, shard[0]),
                                               (g.gy0, g.ny, g.dy, shard[1]),
                                               (g.gz0, g.nz, g.dz,
                                                shard[2]))]
                Z, Y, X = np.meshgrid(centres[2], centres[1], centres[0],
                                      indexing="ij")
                ix = (slice(1, g.nz + 1), slice(1, g.ny + 1),
                      slice(1, g.nx + 1))
            else:
                X, Y, Z = self.component_coords(comp, shard)
                ix = tuple(own_slice(g, _KIND_OF[comp], a)
                           for a in (2, 1, 0))
            sub = np.zeros(arr[ix].shape, np.int32)
            for region_fn, mid in self._material_regions:
                inside = np.asarray(region_fn(X, Y, Z), bool)
                sub = np.where(inside, np.int32(mid), sub)
            arr[ix] = sub
            ids[name] = torch.as_tensor(arr, device=dev)
        return MaterialGrid(**ids)

    def finalize(self, devices=None, **hooks):
        """Build the state and the step; ``hooks`` are the deck's
        ``user_particle_collisions``, ``user_particle_injection``,
        ``user_current_injection`` and ``user_field_injection`` sections
        (``engine/step.py:make_advance``).  ``devices``: where the shards
        go, shard r on ``devices[r % len(devices)]`` (default: the
        simulation's device).  The device-clock spans' rings are emptied
        (``engine/spans.reset``): their records are this deck's."""
        g = self.grid
        if g is None:
            raise RuntimeError("define a grid first")
        spans.reset()
        if not self.materials:
            self.define_material("vacuum")
        self._hooks = hooks
        # each species' injected tags: nothing after finalize creates or
        # tags particles, so these bound its tagged lanes for good
        self._tagged = [sum(int(np.count_nonzero(b["tag"]))
                            for b in h["batches"]) for h in self._species]
        self.mesh = dist.make_mesh(g, devices or [self.device])
        self.comms = dist.make_comms(g, self.mesh)
        self._build_advance()
        self.states = dist.make_distributed_init(g, self.comms)(
            [self._initial_state(s, d) for s, d in
             zip(dist.shard_coords(g), self.mesh)])
        return self.states

    def _build_advance(self):
        g = self.grid
        kw = dict(emitters=tuple(self._emitters),
                  boundary_handlers=tuple(self._boundary_handlers),
                  **self._hooks)
        self._advance = dist.make_distributed_advance(g, self.comms,
                                                      self.opts, **kw)
        self._advance_packed = (
            make_advance(g, self.comms[0], self.opts, packed=True, **kw)
            if self._packed_ok() else None)
        # the JAX package's B cycles exist only on the fused path
        # (vpic_tpu/deck/api.py:713)
        self._cycle_mult = (cycle_mult(self.opts, self._sort_intervals())
                            if resolve_paths(g, self.opts).fused else 1)
        if self._graphs is not None:
            self._graphs.close()
        self._graphs = (graphs.GraphRunner(
            self.mesh[0], self.dispatch_counts, self.capture_times,
            self.opts) if self._graph_ok() else None)

    def _packed_ok(self) -> bool:
        """The packed cycle (``vpic_tpu/deck/api.py:651-711``) runs only
        under ``merge_sort``, the one path where the layout carries
        meaning (the key0/ctot carry), and needs the fused push, untagged
        particles and a closed deck: no boundary rounds, emitters or deck
        hooks, so that nothing creates, kills or migrates particles."""
        if self.grid.is_multishard:
            # migration mutates lanes every step (vpic_tpu/deck/api.py:667)
            return False
        paths = resolve_paths(self.grid, self.opts)
        closed = not (needs_boundary(
            self.grid, None, self._emitters, self._boundary_handlers,
            self._hooks.get("user_particle_injection"))
            or any(v is not None for v in self._hooks.values()))
        return (paths.merge_sort and paths.fused and closed
                and not any(self._tagged))

    def _graph_ok(self) -> bool:
        """The step runs as CUDA graphs (``engine/graphs.py``) where every
        shard lives on the one card (``dist.make_mesh`` names each card by
        its index), decided once per build from the configuration as the
        JAX package decides ``packed_ok``.  Admitted: every such deck,
        several shards, boundary rounds, emitters, the injection hook and
        the collision hook included, whose keys and draws are device
        operations on the state's key (``core/random.py``), and the packed
        cycle with the merge re-sort, which decides fast or full on the
        device (``particles/sort.py``).  Refused: a mesh over several
        devices (a graph belongs to one), which steps eagerly, as every
        deck does on the CPU."""
        return len(set(self.mesh)) == 1 and self.mesh[0].type == "cuda"

    def _sort_intervals(self):
        return [h["sort_interval"] for h in self._species]

    def _graph_key(self, start: int, n: int) -> tuple:
        """The key of the graph of steps ``start`` to ``start + n - 1``,
        on every deck, sharded or not: per step the sort flags that the
        graph fixes (``engine/step.graph_sort_flags``), as the JAX
        package's dispatch units fix them; the step decides its cleans,
        sync and Marder passes on the card."""
        return tuple(graph_sort_flags(t, self.grid, self.opts,
                                      self._sort_intervals())
                     for t in range(start, start + n))

    def _unit_body(self, states, start: int, n: int):
        """Steps ``start`` to ``start + n - 1`` of the per-shard states, op
        by op: the body that a graph captures, with the sort flags of
        :meth:`_graph_key` and no host step, so that the cleans, the sync
        and the Marder passes are decided from the state's step on the
        card (on a sharded deck one conditional node around every shard's
        part, ``engine/cond.py``).  Under the packed cycle the states are
        the one packed state, stepped by the packed advance (as
        :meth:`advance_eager` steps it; the JAX package's packed cycle
        bodies, ``vpic_tpu/deck/api.py:680-740``)."""
        for t in range(start, start + n):
            flags = graph_sort_flags(t, self.grid, self.opts,
                                     self._sort_intervals())
            if self._advance_packed is None:
                states = self._advance(states, flags, None)
            else:
                states = [self._advance_packed(states[0], flags, None)]
        return states

    @property
    def graphed(self) -> bool:
        """Whether :meth:`advance` runs the step as CUDA graphs."""
        return self._graphs is not None

    def modify_runparams(self, **kw):
        """Runtime overrides of ``num_step`` and of :class:`StepOptions`
        fields on a built deck (modify_runparams, dump.cxx:824-890): the
        advance is rebuilt from the new options with the deck's handlers,
        emitters and hooks (its CUDA graphs dropped, new ones captured as
        the steps need them), and a packed state is unpacked first."""
        names = {f.name for f in dataclasses.fields(StepOptions)}
        unknown = sorted(set(kw) - names - {"num_step"})
        if unknown:
            raise ValueError(f"unknown run parameters {unknown}")
        if "num_step" in kw:
            self.num_step = int(kw.pop("num_step"))
        if not kw:
            return
        if self.comms:
            self.states = self.states
        self.opts = dataclasses.replace(self.opts, **kw)
        if self.comms:
            self._build_advance()

    # -- state: one per shard, in rank order.  Under the packed cycle the
    # species live in a packed mirror between steps: the eager one
    # (``_pstate``) or the graphs' static buffers (``_static_packed``).
    # Under the graphs the states live in the graphs' static buffers
    # (``_graphs.static``, every shard's).  The caller's view is a copy made
    # from the newest of them when it is read ------------------------------
    @property
    def states(self) -> List[SimState]:
        """The per-shard states in rank order (empty before finalize).
        After an advance on the graphs or on the packed cycle the first
        read copies the state out of the buffers that hold it, so a state
        the caller holds is a value: a later advance does not change it.
        On the graphs an edit made to it is kept (the next advance copies
        the view back in); on the packed cycle it is not, as in the JAX
        package, whose packed mirror goes on from its carry."""
        if self._state_stale:
            self._states = graphs.clone_state(self._newest())
            self._state_stale = False
        return self._states

    @states.setter
    def states(self, value):
        self._states = list(value)
        self._pstate = None
        self._static_packed = False
        self._state_stale = False

    def _newest(self) -> List[SimState]:
        """The newest per-shard states after an advance, unpacked where
        packed, sharing tensors with the buffers that hold them."""
        src = ([self._pstate] if self._pstate is not None
               else self._graphs.static)
        return [dataclasses.replace(st, species=tuple(
            ppush.unpack_species(sp, self.grid)
            if isinstance(sp, PackedSpecies) else sp for sp in st.species))
            for st in src]

    def _packed(self, st: SimState) -> SimState:
        """The first pack of a state for the packed cycle: each species
        sorted (``aux.sort_p``, which compacts) and packed, with no merge
        carry (``key0 = -1``, so its first merge re-sort sorts in full)."""
        return dataclasses.replace(st, species=tuple(
            ppush.pack_species(paux.sort_p(sp), self.grid)
            for sp in st.species))

    def _one(self, items, what):
        if len(items) > 1:
            raise ValueError(f"a sharded deck has one {what} per shard: "
                             f"read {what}s")
        return items[0] if items else None

    @property
    def state(self) -> Optional[SimState]:
        """The state of an unsharded deck (the JAX package's
        ``sim.state``); None before finalize."""
        return self._one(self.states, "state")

    @state.setter
    def state(self, value: SimState):
        self.states = [value]

    @property
    def comm(self):
        """The exchange of an unsharded deck (a one-shard ``ShardComm``)."""
        return self._one(self.comms, "comm")

    def _shard_states(self):
        """(shard, rank, state) of every shard, in rank order."""
        return zip(dist.shard_coords(self.grid), range(self.grid.n_shards),
                   self._read_states())

    def _read_states(self) -> List[SimState]:
        """The states for a read that keeps no tensor of them (the
        diagnostics): the buffers that hold the newest state themselves
        (unpacked under the packed cycle), else :attr:`states`."""
        if self._state_stale:
            return self._newest()
        return self.states

    # -- stepping ----------------------------------------------------------
    def advance(self, n=1):
        """Advance ``n`` steps and return the new state, as the JAX
        package's ``advance`` does (``vpic_tpu/deck/api.py:878``):
        :attr:`state` on an unsharded deck, :attr:`states` on a sharded
        one.  Where :attr:`graphed`, ``n`` steps are the units of the JAX
        package's dispatch loop (``engine/graphs.plan``: super-cycles,
        cycles, steps), each a replay of its CUDA graph on the static
        buffers, captured the first time its key comes up, and the state
        returned is a copy out of those buffers (:attr:`states`);
        otherwise the steps run op by op (:meth:`advance_eager`)."""
        self.advance_steps(n)
        return self.states if self.grid.is_multishard else self.state

    def advance_steps(self, n=1) -> None:
        """:meth:`advance` without its read of the state: the form a timed
        loop calls, since the read copies the graphs' static buffers (or
        unpacks a packed state)."""
        r = self._graphs
        if r is None:
            self.advance_eager(n)
            return
        if self._advance_packed is not None:
            # the packed mirror goes on from its carry: the eager one is
            # copied in, or the state is packed first (on the host's
            # orders, before any capture)
            if not self._static_packed:
                r.load([self._pstate if self._pstate is not None
                        else self._packed(self.states[0])])
                self._pstate = None
                self._static_packed = True
        elif not self._state_stale:
            # the caller's view is the newest state: copy it in
            r.load(self._states)
        # a read makes a new view from the buffers
        self._state_stale = True
        self._states = None
        k, M = self.opts.resort_interval, self._cycle_mult
        for kind, count in graphs.plan(self.step_count, n, k, M,
                                       cycles=k > 1):
            steps = graphs.unit_steps(kind, k, M)
            for _ in range(count):
                r.run(kind, self._graph_key(self.step_count, steps),
                      self.step_count, steps, self._unit_body)
                self.step_count += steps

    def advance_eager(self, n=1):
        """Advance ``n`` steps op by op through the step function, on any
        deck.  A ``torch.profiler`` trace attributes a kernel to the
        step-part scope (``engine/step.PHASES``) that launched it only
        here: a graph's replay launches its kernels from no scope, so the
        part attribution of ``tools/profile_step.py`` and of
        ``chip_smoke.py``'s traces steps this way on purpose.  The parts'
        device-clock spans (``engine/spans.py``) are stamped both here and
        inside a replay; wall times come from :meth:`advance`."""
        g = self.grid
        for _ in range(n):
            flags = step_sort_flags(self.step_count, g, self.opts,
                                    self._sort_intervals())
            if self._advance_packed is None:
                self.states = self._advance(self.states, flags,
                                            self.step_count)
            else:
                if self._static_packed:
                    # the graphs' packed mirror, carry and all
                    self._pstate = graphs.clone_state(
                        self._graphs.static)[0]
                    self._static_packed = False
                elif self._pstate is None:
                    self._pstate = self._packed(self.states[0])
                self._pstate = self._advance_packed(self._pstate, flags,
                                                    self.step_count)
                self._state_stale = True
            self.step_count += 1
            self.dispatch_counts["eager_steps"] += 1

    # -- diagnostics -------------------------------------------------------
    def energies(self):
        """dump_energies values (dump.cxx:37-78): 6 field energies and the
        kinetic energy of each species, as Python floats."""
        g = self.grid
        ef, ep = 0.0, [0.0] * len(self._species)
        # summed over the shards in rank order, in float64
        for st in self._read_states():
            ef = ef + stencil.local_energy_f(st.field, g, st.materials,
                                             st.material_grid).cpu()
            ep = [e + float(ppush.energy_p(sp, st.interpolator, g))
                  for e, sp in zip(ep, st.species)]
        out = dict(zip(("ex", "ey", "ez", "bx", "by", "bz"),
                       stencil.finish_energy_f(g, ef).tolist()))
        for h, e in zip(self._species, ep):
            out[h["name"]] = e * (g.cvac * g.cvac / h["q_m"])
        return out

    def mover_counts(self):
        """Per-species cumulative dropped-mover counts (the reference's
        "Ignoring %i unprocessed movers", advance.cxx:98-103)."""
        counts = {h["name"]: 0 for h in self._species}
        for st in self._read_states():
            for sp in st.species:
                counts[sp.name] += int(sp.nm)
        return counts

    def warn_dropped_movers(self, log=None):
        """Warn (advance.cxx:98-103) when a species dropped movers since
        the previous call; returns the cumulative counts."""
        counts = self.mover_counts()
        prev = getattr(self, "_warned_movers", {})
        self._warned_movers = counts
        for name, total in counts.items():
            nm = total - prev.get(name, 0)
            if nm:
                msg = (f"ignoring {nm} unprocessed movers for species "
                       f"{name!r} by step {self.step_count} (a lane still "
                       "moving at the walk's segment cap, left pending "
                       "after the boundary rounds, or emitted or injected "
                       "past max_np: raise max_inj, num_comm_round or the "
                       "species' max_np)")
                if log is not None:
                    log(f"WARNING: {msg}")
                else:
                    warnings.warn(msg, RuntimeWarning, stacklevel=2)
        return counts

    def boundary_tallies(self, handler):
        """A handler's state (given as the handler or its index) as numpy,
        summed over the shards (the reference's per-rank counters of
        absorb_tally.c): the tally counters of ``AbsorbTally``, the ring
        of ``LinkBoundary`` (read ``states[r].boundary_state`` for each
        shard's ring)."""
        idx = (handler if isinstance(handler, int)
               else self._boundary_handlers.index(handler))
        per = [st.boundary_state[idx] for st in self._read_states()]
        if isinstance(per[0], dict):
            return {k: sum(p[k].cpu().numpy() for p in per) for k in per[0]}
        return sum(p.cpu().numpy() for p in per)

    def checksum_fields(self):
        """SHA-1 of the full field state of every shard
        (output_checksum_fields, misc.cxx:109-139)."""
        return diagnostics.checksum_fields(self._read_states())

    def checksum_species(self, sp_name):
        return diagnostics.checksum_species(
            self._read_states(), self._species_by_name(sp_name)["sid"])

    def time_phases(self, n_steps=3):
        """Seconds per call of each part of the step (the p/s/g/f/u_time
        analogue, vpic.hxx:214-218)."""
        return diagnostics.time_phases(self, n_steps)

    def _species_by_name(self, name):
        for h in self._species:
            if h["name"] == name:
                return h
        raise KeyError(f"no species {name!r}")

    # -- dumps (the reference's V0 binary and energies text) -------------
    def dump_energies(self, fname, append=True):
        """dump.cxx:37-78."""
        e = self.energies()
        ioenergies.dump_energies(
            fname, self.step_count,
            [e[k] for k in ("ex", "ey", "ez", "bx", "by", "bz")],
            {h["name"]: e[h["name"]] for h in self._species}, self.grid.dt,
            append)

    def dump_fields(self, fbase, ftag=True):
        """One file per rank; returns their paths in rank order."""
        g = self.grid
        return [iodump.dump_fields(st, g, fbase, self.step_count, shard,
                                   rank, g.n_shards, ftag)
                for shard, rank, st in self._shard_states()]

    def dump_grid(self, fbase):
        g = self.grid
        return [iodump.dump_grid(st, g, fbase, shard, rank, g.n_shards)
                for shard, rank, st in self._shard_states()]

    def _hydro(self, sp_name):
        """Each shard's (nv, 14) hydro moments of one species, cleared,
        accumulated and synchronized (dump.cxx:224-265), the shared faces
        merged across the shards (sf_interface.h:156-163), on the shard's
        device."""
        return dist.make_distributed_hydro(
            self.grid, self.comms,
            self._species_by_name(sp_name)["sid"])(self._read_states())

    def dump_hydro(self, sp_name, fbase, ftag=True):
        g, h = self.grid, self._species_by_name(sp_name)
        return [iodump.dump_hydro(one, g, fbase, self.step_count, h["sid"],
                                  h["q_m"], shard, rank, g.n_shards, ftag)
                for (shard, rank, _), one in zip(self._shard_states(),
                                                 self._hydro(sp_name))]

    def dump_species(self, fname):
        """ASCII species listing (dump.cxx:82-101)."""
        return iodump.dump_species_ascii(
            fname, [(h["name"], h["sid"], h["q_m"]) for h in self._species])

    def dump_materials(self, fname):
        """ASCII material listing (dump.cxx:103-120)."""
        return iodump.dump_materials_ascii(fname, self.materials)

    def dump_particles(self, sp_name, fbase, ftag=True):
        """Time-centered particle dump (dump.cxx:267-325)."""
        g, sid = self.grid, self._species_by_name(sp_name)["sid"]
        return [iodump.dump_particles(
            ppush.center_p(st.species[sid], st.interpolator, g), g, fbase,
            self.step_count, shard, rank, g.n_shards, ftag)
            for shard, rank, st in self._shard_states()]

    # -- tracers (the pdlfs tracer deck library, trecon-part/tracer.cxx) --
    def make_tracers(self, src_species, name, stride=1, max_np=None,
                     tag_base=1):
        """Create a zero-charge tracer species from every ``stride``-th
        staged particle of ``src_species`` (tag_tracer + hijack_tracers,
        tracer.cxx:118-198; q = 0 makes the push deposit nothing for
        them).  Call between injection and finalize."""
        batches = src_species["batches"]
        cat = lambda k: (np.concatenate([b[k] for b in batches])
                         if batches else np.zeros((0,)))
        sel = slice(0, None, stride)
        xs = cat("x")[sel]
        n = xs.shape[0]
        if max_np is None:
            max_np = max(8 * n, 64)
        tr = self.define_species(name, src_species["q_m"], max_np)
        self.inject_particle(
            tr, xs, cat("y")[sel], cat("z")[sel], cat("ux")[sel],
            cat("uy")[sel], cat("uz")[sel], q=0.0,
            tag=np.arange(tag_base, tag_base + n, dtype=np.int32))
        return tr

    def collect_trajectories(self):
        """Record every tagged particle's state at the current step (the
        per-step half of dump_traj, tracer.cxx:254-301).  A species whose
        injected particles carry no tag has none (nothing here creates or
        tags particles) and is not read; the others are selected on the
        device and copied with one host read each."""
        if self._traj is None:
            self._traj = iotracers.TrajectoryAccumulator()
        if not any(self._tagged):
            return
        g = self.grid
        for h, cap in zip(self._species, self._tagged):
            if not cap:
                continue
            recs = []
            for shard, _, st in self._shard_states():
                sp = st.species[h["sid"]]
                rec = iotracers.collect_records(
                    dict(tag=sp.tag, alive=sp.alive, dx=sp.dx, dy=sp.dy,
                         dz=sp.dz, i=sp.i, ux=sp.ux, uy=sp.uy, uz=sp.uz),
                    self.step_count, g.dt, capacity=cap)
                if rec.shape[0]:
                    # voxels on the global ghosted grid, so that one origin
                    # decodes every shard's records (exact below 2^24; the
                    # same voxels on one shard)
                    rec[:, 4] = iotracers.globalize_voxels(
                        g, rec[:, 4].astype(np.int64), shard)
                recs.append(rec)
            rec = np.concatenate(recs, axis=0)
            if rec.shape[0]:
                self._traj.add(h["name"], rec)

    def dump_traj(self, dirname, per_tag_files=False):
        """Write accumulated tracer trajectories (dump_traj,
        tracer.cxx:254-301; per_tag_files=True reproduces the reference's
        one-file-per-tracer append layout)."""
        if self._traj is None:
            return []
        return iotracers.write_traj(self._traj, dirname, per_tag_files)

    def dump_tracers_h5part(self, path, species_name):
        """H5Part tracer file (trecon-hdf5's dumptracer_h5part.cxx)."""
        if self._traj is None:
            raise RuntimeError("call collect_trajectories() first")
        return iotracers.write_h5part(self._traj, path, species_name)

    def write_global_header(self, base, field_dp=None, species_dumps=None,
                            field_dir="fields", field_base="fields"):
        """Banded-dump global header <base>.vpc (dump.cxx:978-1115)."""
        if species_dumps is None:
            species_dumps = [(h["name"], "hydro", h["name"],
                              banded.DumpParameters())
                             for h in self._species]
        return write_global_header(base, self.grid,
                                   field_dp or banded.DumpParameters(),
                                   species_dumps, field_dir, field_base)

    def dump_energy_diag(self, sp_name, dirname, nex: int, emax: float,
                         vth: float, nbin: int = 800):
        """In-deck KE diagnostics (energy.cxx:1-201): the per-cell
        energy-band distribution and the global log-KE spectrum."""
        h = self._species_by_name(sp_name)
        out = []
        for _, rank, st in self._shard_states():
            sp = st.species[h["sid"]]
            alive = sp.alive
            band = ed.energy_band_dist(self.grid, sp.ux, sp.uy, sp.uz, sp.i,
                                       alive, nex, emax, vth)
            edist = ed.energy_spectrum(sp.ux, sp.uy, sp.uz, alive, vth,
                                       nbin=nbin)
            out.append(ed.dump_energy_diag(dirname, self.step_count,
                                           h["name"], rank, band, edist))
        return out

    def standard_diagnostics(self, outdir=".", *, energies_interval=50,
                             fields_interval=0, hydro_interval=None,
                             hydro_species=None, particle_interval=0,
                             particle_species=(), restart_interval=0,
                             quota_hours=None, field_dp=None,
                             hydro_dp=None):
        """The production decks' ``begin_diagnostics`` as a reusable helper
        (trecon-part turbulence.cxx:1015-1247, JAX ``api.py:1191-1264``):
        the rundata directory layout, one-time grid, materials and species
        dumps and the global header, interval energies, banded field dumps
        (and at step 1), V0 hydro dumps, particle dumps, and the two-slot
        rotating restart with wall-clock-quota self-termination.

        Returns ``diag()``: call it after each :meth:`advance`.  It returns
        False when the quota fired (a defensive checkpoint was written;
        stop the run)."""
        out = str(outdir)
        for d in ("fields", "hydro", "rundata", "restart1", "restart2",
                  "particle", "tracer"):
            os.makedirs(os.path.join(out, d), exist_ok=True)
        if hydro_interval is None:
            hydro_interval = fields_interval
        if hydro_species is None:
            hydro_species = [h["name"] for h in self._species]
        fdp = field_dp or banded.DumpParameters()
        hdp = hydro_dp or banded.DumpParameters()
        rot = ckpt.RotatingCheckpointer(out, quota_hours=quota_hours)
        init_done = []

        def run():
            s = self.step_count
            if s == 0 or not init_done:
                self.dump_grid(f"{out}/rundata/grid")
                self.dump_materials(f"{out}/rundata/materials")
                self.dump_species(f"{out}/rundata/species")
                self.write_global_header(
                    f"{out}/global", field_dp=fdp,
                    species_dumps=[(h["name"], "hydro",
                                    f"{h['name']}hydro", hdp)
                                   for h in self._species])
                init_done.append(True)
            if energies_interval and s % energies_interval == 0:
                self.dump_energies(f"{out}/rundata/energies", append=s != 0)
            if fields_interval and (s == 1 or s % fields_interval == 0):
                g = self.grid
                for shard, rank, st in self._shard_states():
                    banded.field_dump(st, g, f"{out}/fields/fields.{s}."
                                      f"{rank}", fdp, s, shard, rank,
                                      g.n_shards)
            if hydro_interval and s % hydro_interval == 0:
                for name in hydro_species:
                    self.dump_hydro(name, f"{out}/hydro/{name}hydro")
            if particle_interval and s and s % particle_interval == 0:
                for name in particle_species:
                    self.dump_particles(name,
                                        f"{out}/particle/{name}particle")
            if restart_interval and s and s % restart_interval == 0:
                rot.save(self._read_states(), self.grid,
                         self._checkpoint_meta())
            if rot.over_quota():
                rot.save(self._read_states(), self.grid,
                         self._checkpoint_meta())
                return False
            return True

        return run

    # -- checkpoint / restart ---------------------------------------------
    def _checkpoint_meta(self, extra=None):
        meta = dict(step_count=self.step_count,
                    opts=dataclasses.asdict(self.opts))
        meta.update(extra or {})
        return meta

    def checkpoint(self, path, extra=None):
        """Write a checkpoint of the state (``io/checkpoint.py``; replaces
        dump_restart, dump.cxx:333-556), and the accumulated tracer
        trajectories beside it in ``<path>.traj.npz``, so that they survive
        a quota kill (dump_tracer_restart, tracer.cxx:199-253)."""
        out = ckpt.save_checkpoint(path, self._read_states(), self.grid,
                                   self._checkpoint_meta(extra))
        if self._traj is not None:
            self._traj.save_npz(str(path) + ".traj.npz")
        return out

    def restore(self, path):
        """Load a checkpoint saved by :meth:`checkpoint` into this
        identically configured simulation, on its device, with its tracer
        trajectories where it has them."""
        meta = ckpt.load_meta(path)
        self.states = ckpt.load_checkpoint(path, self._read_states(),
                                           self.mesh)
        self.step_count = int(meta["extra"].get(
            "step_count", int(self.states[0].step)))
        tr = str(path) + ".traj.npz"
        if os.path.exists(tr):
            self._traj = iotracers.TrajectoryAccumulator.load_npz(tr)
        return self.states
