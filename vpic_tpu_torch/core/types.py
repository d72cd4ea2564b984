"""Core state types of the PyTorch port.

The same contract as ``vpic_tpu/core/types.py``, written for PyTorch:

- :class:`Grid` is the static, hashable geometry/units/topology of one
  domain (a copy of the JAX package's class: that module imports jax).
- :class:`FieldState` holds 16 float32 tensors of shape ``(nz+2, ny+2,
  nx+2)`` (one ghost layer per side, x fastest).
- :class:`SpeciesState` is one species in structure-of-arrays form with a
  fixed capacity ``max_np``; ``np`` and ``nm`` are 0-d int32 tensors on the
  species' device, so a step never waits for the host.  Slots ``>= np`` are
  dead: ``q = 0``, voxel 0.
- :class:`SimState` is everything that evolves across a step.

Every state class is a frozen dataclass; functions return new instances
with :func:`dataclasses.replace`.

Voxel linear index: ``i = x + (nx+2)*(y + (ny+2)*z)``, the C-order
flattening of a ``[z, y, x]`` array.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

# ---------------------------------------------------------------------------
# Boundary condition codes (reference: grid.h:57-69)
# ---------------------------------------------------------------------------

ANTI_SYMMETRIC_FIELDS = PEC_FIELDS = METAL_FIELDS = -1
SYMMETRIC_FIELDS = -2
PMC_FIELDS = -3
ABSORB_FIELDS = -4
PERIODIC_FIELDS = -5   # self-join of a face (single shard along that axis)
REMOTE_FIELDS = -6     # face joined to a neighboring shard (halo exchange)

# Particle boundary interactions encoded in the local neighbor table.
NEIGHBOR_REFLECT = -1          # reflect_particles
NEIGHBOR_ABSORB = -2           # absorb_particles
# -3 - face: particle leaves through `face` to the neighboring shard
NEIGHBOR_MIGRATE_BASE = -3
# <= -9: custom boundary handler id = -(code + 9)
NEIGHBOR_CUSTOM_BASE = -9

# Face numbering (move_p.c:123: neighbor[6*i + (v0>0 ? 3 : 0) + type]):
#   0,1,2 = low x, low y, low z faces;  3,4,5 = high x, high y, high z.
FACE_AXIS = (0, 1, 2, 0, 1, 2)
FACE_DIR = (-1, -1, -1, 1, 1, 1)


# ---------------------------------------------------------------------------
# Grid
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Grid:
    """Static grid geometry, units and topology of one domain (the scalar
    part of ``grid_t``, src/grid/grid.h:112-167)."""

    nx: int
    ny: int
    nz: int
    dt: float = 1.0
    cvac: float = 1.0
    eps0: float = 1.0
    damp: float = 0.0
    gx0: float = 0.0
    gy0: float = 0.0
    gz0: float = 0.0
    gx1: float = 1.0
    gy1: float = 1.0
    gz1: float = 1.0
    gpx: int = 1
    gpy: int = 1
    gpz: int = 1
    # field / particle boundary condition per global face (-x,-y,-z,+x,+y,+z)
    fbc: tuple = (PERIODIC_FIELDS,) * 6
    pbc: tuple = (PERIODIC_FIELDS,) * 6
    join: tuple = (None,) * 6

    @property
    def gnx(self) -> int:
        return self.nx * self.gpx

    @property
    def gny(self) -> int:
        return self.ny * self.gpy

    @property
    def gnz(self) -> int:
        return self.nz * self.gpz

    @property
    def dx(self) -> float:
        return (self.gx1 - self.gx0) / self.gnx

    @property
    def dy(self) -> float:
        return (self.gy1 - self.gy0) / self.gny

    @property
    def dz(self) -> float:
        return (self.gz1 - self.gz0) / self.gnz

    @property
    def rdx(self) -> float:
        return 1.0 / self.dx

    @property
    def rdy(self) -> float:
        return 1.0 / self.dy

    @property
    def rdz(self) -> float:
        return 1.0 / self.dz

    @property
    def nxg(self) -> int:
        return self.nx + 2

    @property
    def nyg(self) -> int:
        return self.ny + 2

    @property
    def nzg(self) -> int:
        return self.nz + 2

    @property
    def nv(self) -> int:
        """Number of voxels including ghosts."""
        return self.nxg * self.nyg * self.nzg

    @property
    def shape(self) -> tuple:
        """Ghosted array shape, ``[z, y, x]`` order."""
        return (self.nzg, self.nyg, self.nxg)

    def voxel(self, x, y, z):
        return x + self.nxg * (y + self.nyg * z)


# ---------------------------------------------------------------------------
# Device-resident state
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class GridArrays:
    """``neighbor[i, f]``: the destination voxel (>= 0) through face f of
    voxel i, or a negative boundary code (NEIGHBOR_*).  (nv, 6) int32."""

    neighbor: torch.Tensor


FIELD_COMPONENTS = (
    "ex", "ey", "ez", "div_e_err",
    "cbx", "cby", "cbz", "div_b_err",
    "tcax", "tcay", "tcaz", "rhob",
    "jfx", "jfy", "jfz", "rhof",
)


@dataclasses.dataclass(frozen=True)
class FieldState:
    """Yee-mesh field state (SoA form of ``field_t``,
    field_advance.h:56-171); every component is float32
    ``(nz+2, ny+2, nx+2)``.  ``cb*`` store c*B."""

    ex: torch.Tensor
    ey: torch.Tensor
    ez: torch.Tensor
    div_e_err: torch.Tensor
    cbx: torch.Tensor
    cby: torch.Tensor
    cbz: torch.Tensor
    div_b_err: torch.Tensor
    tcax: torch.Tensor
    tcay: torch.Tensor
    tcaz: torch.Tensor
    rhob: torch.Tensor
    jfx: torch.Tensor
    jfy: torch.Tensor
    jfz: torch.Tensor
    rhof: torch.Tensor

    @classmethod
    def zeros(cls, g: Grid, device="cpu") -> "FieldState":
        return cls(**{k: torch.zeros(g.shape, dtype=torch.float32,
                                     device=device)
                      for k in FIELD_COMPONENTS})

    def replace(self, **kw) -> "FieldState":
        return dataclasses.replace(self, **kw)


MATERIAL_COLUMNS = ("decayx", "decayy", "decayz", "drivex", "drivey",
                    "drivez", "rmux", "rmuy", "rmuz", "nonconductive",
                    "epsx", "epsy", "epsz")


@dataclasses.dataclass(frozen=True)
class MaterialTable:
    """Per-material FDTD coefficients (standard/sfa.c:138-174), each a
    (n_mat,) float32 tensor."""

    decayx: torch.Tensor
    decayy: torch.Tensor
    decayz: torch.Tensor
    drivex: torch.Tensor
    drivey: torch.Tensor
    drivez: torch.Tensor
    rmux: torch.Tensor
    rmuy: torch.Tensor
    rmuz: torch.Tensor
    nonconductive: torch.Tensor
    epsx: torch.Tensor
    epsy: torch.Tensor
    epsz: torch.Tensor


def vacuum_material_table(device="cpu") -> MaterialTable:
    """Single vacuum material (eps=mu=1, sigma=0): decay=drive=rmu=1."""
    one = torch.ones((1,), dtype=torch.float32, device=device)
    return MaterialTable(**{k: one for k in MATERIAL_COLUMNS})


SPECIES_COLUMNS = ("dx", "dy", "dz", "i", "ux", "uy", "uz", "q",
                   "mdx", "mdy", "mdz", "pc", "tag")
_INT_COLUMNS = ("i", "pc", "tag")


_SLOTS: dict = {}


def slot_index(n: int, device) -> torch.Tensor:
    """``arange(n)`` as int32 on ``device``, made once per (n, device):
    the liveness test of every step reads it several times."""
    key = (n, torch.device(device))
    if key not in _SLOTS:
        _SLOTS[key] = torch.arange(n, dtype=torch.int32, device=device)
    return _SLOTS[key]


@dataclasses.dataclass(frozen=True)
class SpeciesState:
    """One particle species (``species_t`` + its particle array,
    species_advance.h:28-93).  ``dx,dy,dz`` are cell-relative positions in
    [-1,1], ``i`` the voxel, ``ux,uy,uz`` momenta (gamma*beta), ``q`` the
    charge weight; ``q_m`` is host data, so a push reads no device scalar;
    ``mdx..mdz`` and ``pc`` the pending displacement and
    boundary status of an unfinished mover; ``nm`` counts dropped movers
    since the start (advance.cxx:98-103)."""

    name: str
    sid: int
    max_np: int
    sort_interval: int
    q_m: float              # charge/mass ratio, a float32 value

    np: torch.Tensor        # 0-d int32 live count
    nm: torch.Tensor        # 0-d int32 dropped-mover count
    dx: torch.Tensor        # (max_np,) float32
    dy: torch.Tensor
    dz: torch.Tensor
    i: torch.Tensor         # (max_np,) int32
    ux: torch.Tensor
    uy: torch.Tensor
    uz: torch.Tensor
    q: torch.Tensor
    mdx: torch.Tensor
    mdy: torch.Tensor
    mdz: torch.Tensor
    pc: torch.Tensor        # (max_np,) int32
    tag: torch.Tensor       # (max_np,) int32

    @classmethod
    def create(cls, name: str, sid: int, q_m: float, max_np: int,
               sort_interval: int = 0, device="cpu") -> "SpeciesState":
        cols = {k: torch.zeros((max_np,), device=device,
                               dtype=torch.int32 if k in _INT_COLUMNS
                               else torch.float32)
                for k in SPECIES_COLUMNS}
        scalar = lambda v, dt: torch.tensor(v, dtype=dt, device=device)
        return cls(name=name, sid=sid, max_np=max_np,
                   sort_interval=sort_interval,
                   q_m=float(np.float32(q_m)),
                   np=scalar(0, torch.int32), nm=scalar(0, torch.int32),
                   **cols)

    def replace(self, **kw) -> "SpeciesState":
        return dataclasses.replace(self, **kw)

    @property
    def alive(self) -> torch.Tensor:
        """(max_np,) bool: slot < np and not a zombie (i < 0)."""
        return (slot_index(self.max_np, self.i.device) < self.np) & (
            self.i >= 0)


@dataclasses.dataclass(frozen=True)
class PackedSpecies:
    """One species as the ``(8, max_np)`` row block ``[dx dy dz ux uy uz q
    vox]`` (``vpic_tpu/core/types.py:PackedSpecies``), with the merge
    re-sort's carry.  Valid only while nothing creates, kills, tags or
    migrates particles: ``np`` is constant, there are no zombies, and dead
    slots (``>= np``) hold all-zero rows.  Row 7 holds the plain voxel as
    an exact float32 integer, so grids need ``nv < 2**24``.  Convert with
    ``particles.push.pack_species`` / ``unpack_species``."""

    name: str
    sid: int
    max_np: int
    sort_interval: int
    q_m: float

    np: torch.Tensor        # 0-d int32 live count
    nm: torch.Tensor        # 0-d int32 dropped-mover (and sort anomaly) count
    pk: torch.Tensor        # (8, max_np) float32 rows
    # the previous sort's sorted keys (dead lanes nv; key0[0] < 0: no
    # snapshot, the next merge re-sort falls back to a full sort) and
    # ctot[v] = # lanes with key0 < v, (nv+3,) int32
    key0: torch.Tensor      # (max_np,) int32
    ctot: torch.Tensor      # (nv+3,) int32

    def replace(self, **kw) -> "PackedSpecies":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class SimState:
    """Everything that evolves across a step.  The single-device
    configuration has a single material (no per-voxel material grid).
    ``rng`` is the counter-based random state of ``core/random.py`` (the
    JAX package's ``jax.random`` key), drawn from by the boundary rounds,
    the reflux handler, the emitters and the deck hooks;
    ``boundary_state`` holds one state per custom boundary handler
    (``boundary/models.py``: tally counters, link rings)."""

    field: FieldState
    interpolator: torch.Tensor      # (nv, 18) float32, layout IP below
    species: tuple                  # tuple[SpeciesState, ...]
    grid_arrays: GridArrays
    materials: MaterialTable
    step: torch.Tensor              # 0-d int32
    rng: Optional[torch.Tensor] = None   # (2,) int64, on the host
    boundary_state: tuple = ()


# Interpolator component layout (interpolator_t, sf_interface.h:45-58)
IP = dict(
    ex=0, dexdy=1, dexdz=2, d2exdydz=3,
    ey=4, deydz=5, deydx=6, d2eydzdx=7,
    ez=8, dezdx=9, dezdy=10, d2ezdxdy=11,
    cbx=12, dcbxdx=13,
    cby=14, dcbydy=15,
    cbz=16, dcbzdz=17,
)
N_IP = 18
