"""Plain PyTorch reference of one periodic PIC deck: VPIC's step on a
periodic box of vacuum, written from the reference kernels and free of the
program under test.

Transcribed in vector form from the loop form of
``advance_p.cxx:68-183`` / ``move_p.c:20-136`` (push, walk, current),
``load_interpolator.cxx:72-121``, ``unload_accumulator.cxx:40-63``,
``advance_b.c``, ``advance_e.c`` (vacuum: decay = drive = rmu = 1, no
damping), ``rho_p.c`` (charge), ``compute_div_e_err.c``,
``clean_div_e.c``, ``compute_div_b_err.c``, ``clean_div_b.c``,
``uncenter_p.cxx`` and ``initialize.cxx:13-100``, with the step order of
``advance.cxx:13-244``.  ``picbench/tests`` hold it to a scalar float64
transcription of the same kernels.

Everything is periodic on every axis, so a field is an ``(nz, ny, nx)``
array with no ghosts and every neighbour is a ``torch.roll``; the
duplicated planes of a ghosted Yee mesh are one plane here.  A species is
its cells ``cell`` (3, n) int64 (x, y, z from 0), its offsets ``off`` (3,
n) in [-1, 1], momenta ``u`` (3, n), charges ``q`` (n,) and ``q_m``.  The
float type is the caller's: float64 for the reference, a lower one for a
control.  No sort: a sort permutes particles and changes no physics.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

E, B, J = ("ex", "ey", "ez"), ("cbx", "cby", "cbz"), ("jfx", "jfy", "jfz")
# lanes per pass of the particle loops (bounds the (lanes, 18) gathers)
BLOCK = 1 << 22
# Marder coefficient of clean_div_e.c / clean_div_b.c
MARDER = 0.3888889
# streak segments a lane may take in one step: one per face crossed plus
# the last; under the Courant limit at most one crossing per axis
MAX_SEGMENTS = 8


@dataclasses.dataclass(frozen=True)
class Box:
    """A periodic box of ``n`` cells per axis (x, y, z) from ``lo`` to
    ``hi``, time step ``dt``, light speed ``cvac`` and ``eps0``."""

    n: tuple
    lo: tuple
    hi: tuple
    dt: float
    cvac: float = 1.0
    eps0: float = 1.0

    @property
    def d(self):
        return tuple((h - l) / n for l, h, n in zip(self.lo, self.hi,
                                                    self.n))

    @property
    def rd(self):
        return tuple(1.0 / d for d in self.d)

    @property
    def cells(self) -> int:
        return self.n[0] * self.n[1] * self.n[2]

    def p(self, axis: int, scale: float) -> float:
        """A difference's coefficient along ``axis``; an axis of one cell
        has no derivative."""
        return scale * self.rd[axis] if self.n[axis] > 1 else 0.0


def courant_length(lengths, n) -> float:
    """vpic.hxx:537-544: the axes of more than one cell."""
    return 1.0 / math.sqrt(sum((k / l) ** 2 for l, k in zip(lengths, n)
                               if k > 1))


# -- neighbours on the periodic mesh ([z, y, x] arrays; axis 0 is x) ------

def ahead(a, axis):
    """The value at index + 1 along ``axis``."""
    return torch.roll(a, -1, dims=2 - axis)


def behind(a, axis):
    """The value at index - 1 along ``axis``."""
    return torch.roll(a, 1, dims=2 - axis)


def wraps(box: Box) -> tuple:
    """The axes across which a position gap wraps: every axis."""
    return (True, True, True)


def planes(comp: str, box: Box) -> tuple:
    """The ``[z, y, x]`` slices of a ghosted array (one ghost layer, as
    ``vpic_tpu_torch/core/types.py`` lays it out) that hold ``comp``'s
    planes here: 1..n on every axis, the seam's duplicated plane n + 1
    left out."""
    return tuple(slice(1, box.n[a] + 1) for a in (2, 1, 0))


def nodes(box: Box) -> int:
    """Rows of :func:`node_deposit`'s ``out``: one node a cell."""
    return box.cells


def settled(sp: dict, box: Box) -> dict:
    """The species as the comparison reads it: as it is (no face of this
    box reflects)."""
    return sp


def flat(box: Box, cell):
    """Cell (3, n) -> flat index x + nx (y + ny z)."""
    nx, ny, _ = box.n
    return cell[0] + nx * (cell[1] + ny * cell[2])


# -- field <-> particle staging --------------------------------------------

def interpolator(F: dict, box: Box):
    """(cells, 18) coefficients (interpolator_t)."""

    def quad(w0, w1, w2, w3):
        return [0.25 * (w0 + w1 + w2 + w3), 0.25 * (-w0 + w1 - w2 + w3),
                0.25 * (-w0 - w1 + w2 + w3), 0.25 * (w0 - w1 - w2 + w3)]

    ex, ey, ez = (F[c] for c in E)
    cols = (quad(ex, ahead(ex, 1), ahead(ex, 2), ahead(ahead(ex, 1), 2))
            + quad(ey, ahead(ey, 2), ahead(ey, 0), ahead(ahead(ey, 2), 0))
            + quad(ez, ahead(ez, 0), ahead(ez, 1), ahead(ahead(ez, 0), 1)))
    for axis, c in enumerate(B):
        b, b1 = F[c], ahead(F[c], axis)
        cols += [0.5 * (b + b1), 0.5 * (b1 - b)]
    return torch.stack([c.reshape(-1) for c in cols], dim=-1)


def fields_at(ip, off):
    """E and cB at the particles from their gathered (m, 18) rows."""
    dx, dy, dz = off
    c = ip.unbind(-1)
    ex = (c[0] + dy * c[1]) + dz * (c[2] + dy * c[3])
    ey = (c[4] + dz * c[5]) + dx * (c[6] + dz * c[7])
    ez = (c[8] + dx * c[9]) + dy * (c[10] + dx * c[11])
    return (ex, ey, ez), (c[12] + dx * c[13], c[14] + dy * c[15],
                          c[16] + dz * c[17])


def rotate(u, b, v0):
    """The Boris rotation of advance_p.cxx:91-102, v0 = (q dt'/2mc)/gamma,
    with its tan(theta/2)/(theta/2) series."""
    ux, uy, uz = u
    bx, by, bz = b
    v1 = bx * bx + by * by + bz * bz
    v2 = v0 * v0 * v1
    v3 = v0 * (1 + v2 * (1.0 / 3.0 + v2 * (2.0 / 15.0)))
    v4 = 2 * (v3 / (1 + v1 * v3 * v3))
    w0 = ux + v3 * (uy * bz - uz * by)
    w1 = uy + v3 * (uz * bx - ux * bz)
    w2 = uz + v3 * (ux * by - uy * bx)
    return (ux + v4 * (w1 * bz - w2 * by), uy + v4 * (w2 * bx - w0 * bz),
            uz + v4 * (w0 * by - w1 * bx))


def accumulate_j(acc, idx, q, sd, sm):
    """ACCUMULATE_J of one streak segment into ``acc`` (cells, 12)."""
    v5 = q * sd[0] * sd[1] * sd[2] / 3.0
    cols = []
    for X, Y, Z in ((0, 1, 2), (1, 2, 0), (2, 0, 1)):
        v = q * sd[X]
        lo_y, hi_y, lo_z, hi_z = 1 - sm[Y], 1 + sm[Y], 1 - sm[Z], 1 + sm[Z]
        cols += [v * lo_y * lo_z + v5, v * hi_y * lo_z - v5,
                 v * lo_y * hi_z - v5, v * hi_y * hi_z + v5]
    acc.index_add_(0, idx, torch.stack(cols, dim=-1))


def walk(box: Box, cell, pos, disp, q, acc):
    """move_p: streak segments to the first face crossed, the current of
    each into ``acc``, until the displacement is used up.  Returns the new
    cells and offsets."""
    cell, pos, disp = cell.clone(), pos.clone(), disp.clone()
    lanes = torch.arange(q.shape[0], device=q.device)
    n = torch.tensor(box.n, device=q.device)[:, None]
    for _ in range(MAX_SEGMENTS):
        c, p, d, qq = cell[:, lanes], pos[:, lanes], disp[:, lanes], q[lanes]
        sdir = torch.where(d > 0, 1.0, -1.0).to(d.dtype)
        frac = torch.where(d == 0, torch.full_like(d, float("inf")),
                           (sdir - p) / torch.where(d == 0, 1.0, d))
        v3 = torch.full_like(qq, 2.0)
        typ = torch.full_like(lanes, 3)
        for a in range(3):
            less = frac[a] < v3
            v3 = torch.where(less, frac[a], v3)
            typ = torch.where(less, a, typ)
        v3 = 0.5 * v3
        sd = d * v3
        accumulate_j(acc, flat(box, c), qq, sd, p + sd)
        d = d - sd
        p = p + 2 * sd
        crossing = typ < 3
        a = typ.clamp(max=2)
        onehot = torch.nn.functional.one_hot(a, 3).T.bool() & crossing
        step = sdir.gather(0, a[None]).to(torch.int64)[0]
        c = torch.where(onehot, (c + step) % n, c)
        p = torch.where(onehot, -sdir, p)
        cell[:, lanes], pos[:, lanes], disp[:, lanes] = c, p, d
        lanes = lanes[crossing]
        if lanes.numel() == 0:
            break
    # a lane still walking here (none under the Courant limit) keeps its
    # partial streak, and the comparison shows it
    return cell, pos


def push(sp: dict, ip, box: Box, acc) -> dict:
    """advance_p of one species: interpolate, half kick, rotate, half
    kick, then the walk and its current.  Returns the pushed species."""
    qdt_2mc = 0.5 * sp["q_m"] * box.dt / box.cvac
    cdt_d = [box.cvac * box.dt * r for r in box.rd]
    cells, offs, us = [], [], []
    n = sp["q"].shape[0]
    for s in range(0, n, BLOCK):
        cell, off = sp["cell"][:, s:s + BLOCK], sp["off"][:, s:s + BLOCK]
        q = sp["q"][s:s + BLOCK]
        e, b = fields_at(ip[flat(box, cell)], off)
        ha = [qdt_2mc * v for v in e]
        u = [v + h for v, h in zip(sp["u"][:, s:s + BLOCK], ha)]
        u = rotate(u, b, qdt_2mc / torch.sqrt(1 + u[0] * u[0] + u[1] * u[1]
                                              + u[2] * u[2]))
        u = torch.stack([v + h for v, h in zip(u, ha)])
        rg = 1 / torch.sqrt(1 + (u * u).sum(0))
        disp = torch.stack([u[a] * cdt_d[a] * rg for a in range(3)])
        cell, off = walk(box, cell, off, disp, q, acc)
        cells.append(cell)
        offs.append(off)
        us.append(u)
    return dict(sp, cell=torch.cat(cells, 1), off=torch.cat(offs, 1),
                u=torch.cat(us, 1))


def unload(acc, box: Box) -> dict:
    """Quadrant currents -> jf (unload_accumulator.cxx:40-63)."""
    nx, ny, nz = box.n
    a = acc.reshape(nz, ny, nx, 12).unbind(-1)
    rx, ry, rz = box.rd
    cx, cy, cz = (0.25 * ry * rz / box.dt, 0.25 * rz * rx / box.dt,
                  0.25 * rx * ry / box.dt)
    return dict(
        jfx=cx * (a[0] + behind(a[1], 1) + behind(a[2], 2)
                  + behind(behind(a[3], 1), 2)),
        jfy=cy * (a[4] + behind(a[5], 2) + behind(a[6], 0)
                  + behind(behind(a[7], 2), 0)),
        jfz=cz * (a[8] + behind(a[9], 0) + behind(a[10], 1)
                  + behind(behind(a[11], 0), 1)))


def node_deposit(box: Box, cell, off, weights, out):
    """Trilinear deposit of ``weights`` (m, k) at the 8 nodes of each
    particle's cell, weight (1 +/- x)(1 +/- y)(1 +/- z) (rho_p.c), into
    ``out`` (cells, k); a node past the last wraps to the first."""
    n = torch.tensor(box.n, device=cell.device)[:, None]
    for k in range(8):
        o = torch.tensor([k & 1, k >> 1 & 1, k >> 2 & 1],
                         device=cell.device)[:, None]
        w = torch.ones_like(off[0])
        for a in range(3):
            w = w * (1 + off[a] if k >> a & 1 else 1 - off[a])
        out.index_add_(0, flat(box, (cell + o) % n), weights * w[:, None])
    return out


def rho(species, box: Box, dtype) -> torch.Tensor:
    """rhof on the nodes: every species' charge, r8V q per particle."""
    r8V = 0.125 * box.rd[0] * box.rd[1] * box.rd[2]
    nx, ny, nz = box.n
    dev = species[0]["q"].device
    out = torch.zeros((box.cells, 1), dtype=dtype, device=dev)
    for sp in species:
        for s in range(0, sp["q"].shape[0], BLOCK):
            node_deposit(box, sp["cell"][:, s:s + BLOCK],
                         sp["off"][:, s:s + BLOCK],
                         (r8V * sp["q"][s:s + BLOCK])[:, None], out)
    return out.reshape(nz, ny, nx)


# -- fields ----------------------------------------------------------------

def advance_b(F: dict, box: Box, frac: float) -> dict:
    """cB -= frac c dt curl E."""
    px, py, pz = (box.p(a, frac * box.cvac * box.dt) for a in range(3))
    ex, ey, ez = (F[c] for c in E)
    return dict(F,
                cbx=F["cbx"] - (py * (ahead(ez, 1) - ez)
                                - pz * (ahead(ey, 2) - ey)),
                cby=F["cby"] - (pz * (ahead(ex, 2) - ex)
                                - px * (ahead(ez, 0) - ez)),
                cbz=F["cbz"] - (px * (ahead(ey, 0) - ey)
                                - py * (ahead(ex, 1) - ex)))


def advance_e(F: dict, box: Box) -> dict:
    """E += c dt curl cB - dt/eps0 J (vacuum, no damping)."""
    px, py, pz = (box.p(a, box.cvac * box.dt) for a in range(3))
    bx, by, bz = (F[c] for c in B)
    cj = box.dt / box.eps0
    return dict(F,
                ex=F["ex"] + (py * (bz - behind(bz, 1))
                              - pz * (by - behind(by, 2))) - cj * F["jfx"],
                ey=F["ey"] + (pz * (bx - behind(bx, 2))
                              - px * (bz - behind(bz, 0))) - cj * F["jfy"],
                ez=F["ez"] + (px * (by - behind(by, 0))
                              - py * (bx - behind(bx, 1))) - cj * F["jfz"])


def div_e(F: dict, box: Box):
    """div E on the nodes."""
    return sum(box.p(a, 1.0) * (F[c] - behind(F[c], a))
               for a, c in enumerate(E))


def div_e_err(F: dict, rhof, box: Box):
    return div_e(F, box) - (rhof + F["rhob"]) / box.eps0


def div_b_err(F: dict, box: Box):
    return sum(box.p(a, 1.0) * (ahead(F[c], a) - F[c])
               for a, c in enumerate(B))


def _alphadt(box: Box):
    p = [box.p(a, 1.0) for a in range(3)]
    return MARDER / sum(v * v for v in p), p


def _rms(err, box: Box) -> float:
    return box.eps0 * float(torch.sqrt(torch.mean(err.double() ** 2)))


def clean_e_pass(F: dict, err, box: Box) -> dict:
    """E += alphadt grad(div_e_err) (clean_div_e.c)."""
    al, p = _alphadt(box)
    return dict(F, **{c: F[c] + al * p[a] * (ahead(err, a) - err)
                      for a, c in enumerate(E)})


def clean_b_pass(F: dict, err, box: Box) -> dict:
    """cB += alphadt grad(div_b_err) (clean_div_b.c)."""
    al, p = _alphadt(box)
    return dict(F, **{c: F[c] + al * p[a] * (err - behind(err, a))
                      for a, c in enumerate(B)})


def clean_div_e(F: dict, species, box: Box) -> dict:
    """advance.cxx:151-173: up to two Marder passes, each where the rms
    error before it is above 0."""
    rhof = rho(species, box, F["ex"].dtype)
    for _ in range(2):
        err = div_e_err(F, rhof, box)
        if not _rms(err, box) > 0:
            break
        F = clean_e_pass(F, err, box)
    return F


def clean_div_b(F: dict, box: Box) -> dict:
    """advance.cxx:177-195, as :func:`clean_div_e`."""
    for _ in range(2):
        err = div_b_err(F, box)
        if not _rms(err, box) > 0:
            break
        F = clean_b_pass(F, err, box)
    return F


# -- the step and the initial state ----------------------------------------

def step(F: dict, species: list, box: Box, t: int, cleans: dict):
    """One step from step ``t``: push every species, unload the current,
    B half, E, B half, the interval cleans, as advance.cxx orders them.
    ``cleans``: the div E and div B clean intervals (0: never).  Returns
    (fields, species)."""
    ip = interpolator(F, box)
    acc = torch.zeros((box.cells, 12), dtype=F["ex"].dtype,
                      device=F["ex"].device)
    species = [push(sp, ip, box, acc) for sp in species]
    F = dict(F, **unload(acc, box))
    F = advance_b(advance_e(advance_b(F, box, 0.5), box), box, 0.5)
    de, db = cleans.get("div_e", 0), cleans.get("div_b", 0)
    if de and t % de == 0:
        F = clean_div_e(F, species, box)
    if db and t % db == 0:
        F = clean_div_b(F, box)
    return F, species


def sample(fn, comp: str, box: Box):
    """A field component set from ``fn(x, y, z)`` over the periodic mesh:
    evaluated at the component's Yee positions (deck_wrapper.cxx:467-503),
    and where a component lies on the nodes of an axis (E across its
    edge, cB along its face normal) the two planes that the periodic seam
    shares averaged into one, as the first shared-face sync does
    (remote.c:298-414).  Returns a float64 numpy array [z, y, x]."""
    import numpy as np
    kind = comp[-1]
    on_nodes = [(a != "xyz".index(kind)) == comp.startswith("e")
                for a in range(3)]
    axes = []
    for a in range(3):
        k = box.n[a] + on_nodes[a]
        axes.append(box.lo[a] + (np.arange(k) + (0.0 if on_nodes[a]
                                                 else 0.5)) * box.d[a])
    Z, Y, X = np.meshgrid(axes[2], axes[1], axes[0], indexing="ij")
    v = np.broadcast_to(np.asarray(fn(X, Y, Z), np.float64), X.shape)
    for a in range(3):
        if on_nodes[a]:
            ax = 2 - a
            first = np.take(v, [0], axis=ax)
            last = np.take(v, [box.n[a]], axis=ax)
            v = np.concatenate([0.5 * (first + last),
                                np.take(v, range(1, box.n[a]), axis=ax)],
                               axis=ax)
    return v


def cellify(x, lo, hi, n):
    """Global coordinates -> (cell from 0, offset in [-1, 1]); a point on
    the far wall belongs to the last cell."""
    t = n * ((x - lo) / (hi - lo))
    c = torch.floor(t)
    off = 2 * (t - c) - 1
    far = c >= n
    return (torch.where(far, n - 1, c).to(torch.int64),
            torch.where(far, torch.ones_like(off), off))


def initial_state(inputs: dict, box: Box, dtype, device):
    """initialize.cxx:13-100 on the deck's inputs: the fields from their
    functions, one div B clean, rhob from the charge, a div E clean where
    its error is above 0, and the momenta uncentered (u_0 -> u_{-1/2}).
    ``inputs``: ``fields`` (component -> its values over the periodic
    mesh, float64) and ``species`` (each ``q_m`` and the float64 columns
    ``x, y, z, ux, uy, uz, q``).  Returns (fields, species)."""
    nx, ny, nz = box.n
    F = {c: torch.zeros((nz, ny, nx), dtype=dtype, device=device)
         for c in E + B + J + ("rhob",)}
    for c, v in inputs["fields"].items():
        F[c] = torch.as_tensor(v, device=device).to(dtype)
    F = clean_b_pass(F, div_b_err(F, box), box)
    species = []
    for raw in inputs["species"]:
        col = lambda k: torch.as_tensor(raw[k], device=device).to(
            torch.float64)
        cells, offs = zip(*(cellify(col(k), box.lo[a], box.hi[a], box.n[a])
                            for a, k in enumerate("xyz")))
        species.append(dict(
            name=raw["name"], q_m=raw["q_m"], cell=torch.stack(cells),
            off=torch.stack(offs).to(dtype),
            u=torch.stack([col(k) for k in ("ux", "uy", "uz")]).to(dtype),
            q=col("q").to(dtype)))
    rhof = rho(species, box, dtype)
    F["rhob"] = box.eps0 * div_e(F, box) - rhof
    err = div_e_err(F, rhof, box)
    if _rms(err, box) > 0:
        F = clean_e_pass(F, err, box)
    ip = interpolator(F, box)
    return F, [uncenter(sp, ip, box) for sp in species]


def uncenter(sp: dict, ip, box: Box) -> dict:
    """u_0 -> u_{-1/2}: a backward half rotation, then a backward half
    kick (uncenter_p.cxx:14-70)."""
    qdt_2mc = 0.5 * sp["q_m"] * box.dt / box.cvac
    us = []
    for s in range(0, sp["q"].shape[0], BLOCK):
        e, b = fields_at(ip[flat(box, sp["cell"][:, s:s + BLOCK])],
                         sp["off"][:, s:s + BLOCK])
        u = sp["u"][:, s:s + BLOCK]
        g = torch.sqrt(1 + (u * u).sum(0))
        u = rotate(u, b, -0.5 * qdt_2mc / g)
        us.append(torch.stack([v - qdt_2mc * f for v, f in zip(u, e)]))
    return dict(sp, u=torch.cat(us, 1))
