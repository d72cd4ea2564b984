"""Plain PyTorch reference of a PIC deck in a box with conducting walls:
VPIC's step on a box that is periodic along some axes and closed along
the others by conducting (PEC, ``anti_symmetric_fields``) field faces and
reflecting (``reflect_particles``) particle faces at both ends, written
from the reference kernels and free of the program under test.

What touches no neighbour comes from :mod:`picbench.reference.pic` (the
interpolated fields at a particle, the Boris rotation, a segment's
current, the uncentering, the cells of a load); what does is written here
from

- ``move_p.c:20-136``: a streak that reaches a reflecting face stops on it
  (its offset put exactly on the face), deposits its current up to it,
  and flips the remaining displacement and the momentum normal to it; the
  particle stays in its cell and walks on;
- ``local.c``: on a PEC face the ghosts of tangential cB, of normal E and
  of ``div_b_err`` mirror the first plane inside (an even image), and the
  adjusts zero tangential E, tangential J, ``rhof``, ``rhob`` and
  ``div_e_err`` on the wall's plane (``local_adjust_tang_e``,
  ``local_adjust_jf``, ``local_adjust_rhof``, ``local_adjust_rhob``,
  ``local_adjust_div_e``); normal cB is left as it is (its adjust is the
  symmetric face's);
- ``unload_accumulator.cxx:40-63``: a node on a wall takes the current of
  the cells on its inner side only (a ghost cell holds none);
- ``advance_b.c``, ``advance_e.c`` (vacuum), ``compute_div_e_err.c``,
  ``clean_div_e.c``, ``compute_div_b_err.c``, ``clean_div_b.c``,
  ``compute_rhob.c`` and ``initialize.cxx:13-100`` on that mesh, in the
  step order of ``advance.cxx:13-244``.

The mesh.  A field is an array ``[z, y, x]`` without ghosts.  Along a
periodic axis it has ``n`` planes, the seam's duplicated plane one plane,
and a neighbour is a ``torch.roll``, as in ``pic.py``.  Along a wall axis
a component that lies on the nodes of that axis (E and J across it, cB
along it, the charges) has ``n + 1`` planes: both walls are planes of
their own; one that lies on the cells has ``n``.  With every axis
periodic the arithmetic is ``pic.py``'s, operation for operation.  A
snapshot's ghosted arrays map onto these by :func:`planes`.

Departures from the reference kernels, each of no consequence here:

- the Marder passes are gated, as in ``pic.py``, on the plain rms of the
  error being above 0, where VPIC weights the boundary nodes (the rms
  only decides whether it is above 0);
- no radiation damping (``tca``): the decks are vacuum with no damping;
- no sort and no shared-face sync: a sort permutes particles, and with one
  plane for the seam the sync has nothing to average;
- a streak that has not ended after :data:`MAX_SEGMENTS` segments keeps
  its partial walk (none does under the Courant limit), as in ``pic.py``.
"""

from __future__ import annotations

import dataclasses

import torch

from picbench.reference import pic
from picbench.reference.pic import (  # noqa: F401  (the module interface)
    B, BLOCK, E, J, MARDER, MAX_SEGMENTS, accumulate_j, cellify,
    courant_length, fields_at, flat, rotate, uncenter)


@dataclasses.dataclass(frozen=True)
class Box(pic.Box):
    """A box as :class:`pic.Box` whose axes with ``walls`` set (x, y, z)
    are closed by a conducting, reflecting wall at both ends."""

    walls: tuple = (False, False, True)

    @property
    def node_n(self) -> tuple:
        """Node planes per axis: one more than cells along a wall axis."""
        return tuple(n + bool(w) for n, w in zip(self.n, self.walls))


def wraps(box: Box) -> tuple:
    """The axes across which a position gap wraps: the periodic ones."""
    return tuple(not w for w in box.walls)


def on_nodes(comp: str, axis: int) -> bool:
    """Whether field component ``comp`` lies on the nodes of ``axis``: E
    and J across their own axis, cB along its own, the charges and
    ``div_e_err`` on every axis (field_advance.h:80-171)."""
    if comp in ("rhof", "rhob", "div_e_err"):
        return True
    own = "xyz".index(comp[-1])
    return (axis != own) == (comp[0] in "ej")


def planes(comp: str, box: Box) -> tuple:
    """The ``[z, y, x]`` slices of a ghosted array (one ghost layer, as
    ``vpic_tpu_torch/core/types.py`` lays it out) that hold ``comp``'s
    planes here: 1..n, and the far wall's plane n + 1 where ``comp`` lies
    on the nodes of a wall axis."""
    return tuple(slice(1, box.n[a] + 1 + (box.walls[a]
                                          and on_nodes(comp, a)))
                 for a in (2, 1, 0))


def nodes(box: Box) -> int:
    """Rows of :func:`node_deposit`'s ``out``: the mesh's nodes."""
    nx, ny, nz = box.node_n
    return nx * ny * nz


# the width (in offset, of 2 a cell) over which :func:`settled` turns a
# lane's normal momentum toward a reflecting face's inside: wide enough
# that the turn's slope, 2|u|/FACE, takes a float32 position's rounding
# (about 1e-7) to a momentum's (about 1e-6 |u|), also in a species of a
# few thousand lanes whose moments are sparse
FACE = 0.1


def settled(sp: dict, box: Box) -> dict:
    """The species as the comparison reads it.  A lane within :data:`FACE`
    of a reflecting face (in the wall's cell) whose normal momentum points
    out has that component turned inward, fully on the face and less the
    farther it lies, to not at all at :data:`FACE`.  Whether a streak that
    ends on the face reflects there is a rounding's choice (move_p.c weighs
    the fraction of the streak to the face against 2), so a float32
    program and a float64 reference may take it apart; a lane on the face
    whose momentum points out reflects at the start of its next move
    having moved nowhere.  The turn is continuous in the lane's position,
    so two readings of one lane a rounding apart stay a rounding apart.  A
    lane that missed a reflection or a flip ends away from the face, and
    is read as it is."""
    u = sp["u"]
    for a in range(3):
        if not box.walls[a]:
            continue
        c, o = sp["cell"][a], sp["off"][a]
        low, high = c == 0, c == box.n[a] - 1
        dist = torch.where(low, 1 + o, 1 - o)
        near = (low | high) & (dist < FACE)
        if not bool(near.any()):
            continue
        inward = torch.where(low, 1.0, -1.0).to(u.dtype)
        un = u[a] * inward
        turn = 1 - 2 * (1 - dist / FACE).clamp(0, 1)
        u = u.clone() if u is sp["u"] else u
        u[a] = torch.where(near & (un < 0), un * turn, un) * inward
    return dict(sp, u=u)


# -- neighbours ([z, y, x] arrays; axis 0 is x) -----------------------------

def _narrow(a, axis, start, length):
    return a.narrow(2 - axis, start, length)


def lo(a, axis, box: Box):
    """Of a node array along ``axis``: the node below each cell."""
    return _narrow(a, axis, 0, box.n[axis]) if box.walls[axis] else a


def hi(a, axis, box: Box):
    """Of a node array along ``axis``: the node above each cell."""
    return (_narrow(a, axis, 1, box.n[axis]) if box.walls[axis]
            else pic.ahead(a, axis))


def fwd(a, axis, box: Box):
    """A node array's difference across each cell along ``axis``."""
    return hi(a, axis, box) - lo(a, axis, box)


def _ghosts(c, axis, box: Box, mirror: bool):
    """The ghost planes below and above a cell array along a wall axis:
    the first and last planes inside (a PEC face's even image), or 0."""
    n = box.n[axis]
    first, last = _narrow(c, axis, 0, 1), _narrow(c, axis, n - 1, 1)
    if not mirror:
        first, last = torch.zeros_like(first), torch.zeros_like(last)
    return first, last


def above(c, axis, box: Box, mirror: bool):
    """Of a cell array along ``axis``: the cell above each node (on a wall
    axis a ghost past the last)."""
    if not box.walls[axis]:
        return c
    return torch.cat([c, _ghosts(c, axis, box, mirror)[1]], dim=2 - axis)


def below(c, axis, box: Box, mirror: bool):
    """Of a cell array along ``axis``: the cell below each node (on a wall
    axis a ghost before the first)."""
    if not box.walls[axis]:
        return pic.behind(c, axis)
    return torch.cat([_ghosts(c, axis, box, mirror)[0], c], dim=2 - axis)


def bwd(c, axis, box: Box):
    """A cell array's difference across each node along ``axis``, with a
    PEC face's mirrored ghosts."""
    return above(c, axis, box, True) - below(c, axis, box, True)


def zero_walls(F: dict, comps, box: Box) -> dict:
    """The PEC adjusts: each of ``comps`` zeroed on the wall planes of the
    wall axes whose nodes it lies on (tangential E and J, the charges,
    ``div_e_err``)."""
    out = dict(F)
    for c in comps:
        v = out[c]
        for a in range(3):
            if box.walls[a] and on_nodes(c, a):
                v = v.clone()
                n = box.node_n[a]
                _narrow(v, a, 0, 1).zero_()
                _narrow(v, a, n - 1, 1).zero_()
        out[c] = v
    return out


def _zero(v, name, box: Box):
    return zero_walls({name: v}, (name,), box)[name]


# -- field <-> particle staging ---------------------------------------------

def interpolator(F: dict, box: Box):
    """(cells, 18) coefficients (interpolator_t), as ``pic.interpolator``
    with each node plane taken from the mesh."""

    def quad(w0, w1, w2, w3):
        return [0.25 * (w0 + w1 + w2 + w3), 0.25 * (-w0 + w1 - w2 + w3),
                0.25 * (-w0 - w1 + w2 + w3), 0.25 * (w0 - w1 - w2 + w3)]

    def corners(v, Y, Z):
        # v at (y, z), (y+1, z), (y, z+1), (y+1, z+1) of each cell
        return quad(lo(lo(v, Y, box), Z, box), hi(lo(v, Z, box), Y, box),
                    hi(lo(v, Y, box), Z, box), hi(hi(v, Y, box), Z, box))

    cols = (corners(F["ex"], 1, 2) + corners(F["ey"], 2, 0)
            + corners(F["ez"], 0, 1))
    for axis, c in enumerate(B):
        b, b1 = lo(F[c], axis, box), hi(F[c], axis, box)
        cols += [0.5 * (b + b1), 0.5 * (b1 - b)]
    return torch.stack([c.reshape(-1) for c in cols], dim=-1)


def walk(box: Box, cell, pos, disp, u, q, acc):
    """move_p with reflecting walls: streak segments to the first face
    crossed, the current of each into ``acc``, until the displacement is
    used up; a face of a wall reflects.  Returns the new cells, offsets
    and momenta."""
    cell, pos, disp, u = cell.clone(), pos.clone(), disp.clone(), u.clone()
    lanes = torch.arange(q.shape[0], device=q.device)
    n = torch.tensor(box.n, device=q.device)[:, None]
    wall = torch.tensor(box.walls, device=q.device)[:, None]
    for _ in range(MAX_SEGMENTS):
        c, p, d, uu = cell[:, lanes], pos[:, lanes], disp[:, lanes], \
            u[:, lanes]
        qq = q[lanes]
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
        to = c + step
        reflect = onehot & wall & ((to < 0) | (to >= n))
        cross = onehot & ~reflect
        c = torch.where(cross, to % n, c)
        # on the face exactly: the far side's offset after a crossing,
        # this side's after a reflection (move_p.c:112-126)
        p = torch.where(cross, -sdir, torch.where(reflect, sdir, p))
        d = torch.where(reflect, -d, d)
        uu = torch.where(reflect, -uu, uu)
        cell[:, lanes], pos[:, lanes], disp[:, lanes] = c, p, d
        u[:, lanes] = uu
        lanes = lanes[crossing]
        if lanes.numel() == 0:
            break
    return cell, pos, u


def push(sp: dict, ip, box: Box, acc) -> dict:
    """advance_p of one species, as ``pic.push``, with the walls' walk."""
    qdt_2mc = 0.5 * sp["q_m"] * box.dt / box.cvac
    cdt_d = [box.cvac * box.dt * r for r in box.rd]
    cells, offs, us = [], [], []
    for s in range(0, sp["q"].shape[0], BLOCK):
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
        cell, off, u = walk(box, cell, off, disp, u, q, acc)
        cells.append(cell)
        offs.append(off)
        us.append(u)
    return dict(sp, cell=torch.cat(cells, 1), off=torch.cat(offs, 1),
                u=torch.cat(us, 1))


def unload(acc, box: Box) -> dict:
    """Quadrant currents -> jf (unload_accumulator.cxx:40-63), tangential
    J then zeroed on the walls (local_adjust_jf)."""
    nx, ny, nz = box.n
    a = acc.reshape(nz, ny, nx, 12).unbind(-1)
    rx, ry, rz = box.rd
    cx, cy, cz = (0.25 * ry * rz / box.dt, 0.25 * rz * rx / box.dt,
                  0.25 * rx * ry / box.dt)

    def up(v, axis):
        return above(v, axis, box, False)

    def dn(v, axis):
        return below(v, axis, box, False)

    J = dict(
        jfx=cx * (up(up(a[0], 1), 2) + dn(up(a[1], 2), 1)
                  + dn(up(a[2], 1), 2) + dn(dn(a[3], 1), 2)),
        jfy=cy * (up(up(a[4], 2), 0) + dn(up(a[5], 0), 2)
                  + dn(up(a[6], 2), 0) + dn(dn(a[7], 2), 0)),
        jfz=cz * (up(up(a[8], 0), 1) + dn(up(a[9], 1), 0)
                  + dn(up(a[10], 0), 1) + dn(dn(a[11], 0), 1)))
    return zero_walls(J, pic.J, box)


def node_deposit(box: Box, cell, off, weights, out):
    """Trilinear deposit of ``weights`` (m, k) at the 8 nodes of each
    particle's cell (rho_p.c) into ``out`` (:func:`nodes`, k); a node past
    the last wraps to the first along a periodic axis, and is the far
    wall's along a wall axis."""
    n = torch.tensor(box.n, device=cell.device)[:, None]
    wrap = torch.tensor(wraps(box), device=cell.device)[:, None]
    nx, ny, _ = box.node_n
    for k in range(8):
        o = torch.tensor([k & 1, k >> 1 & 1, k >> 2 & 1],
                         device=cell.device)[:, None]
        w = torch.ones_like(off[0])
        for a in range(3):
            w = w * (1 + off[a] if k >> a & 1 else 1 - off[a])
        at = cell + o
        at = torch.where(wrap, at % n, at)
        out.index_add_(0, at[0] + nx * (at[1] + ny * at[2]),
                       weights * w[:, None])
    return out


def rho(species, box: Box, dtype) -> torch.Tensor:
    """rhof on the nodes: every species' charge, r8V q per particle, zero
    on the walls (local_adjust_rhof)."""
    r8V = 0.125 * box.rd[0] * box.rd[1] * box.rd[2]
    nx, ny, nz = box.node_n
    dev = species[0]["q"].device
    out = torch.zeros((nodes(box), 1), dtype=dtype, device=dev)
    for sp in species:
        for s in range(0, sp["q"].shape[0], BLOCK):
            node_deposit(box, sp["cell"][:, s:s + BLOCK],
                         sp["off"][:, s:s + BLOCK],
                         (r8V * sp["q"][s:s + BLOCK])[:, None], out)
    return _zero(out.reshape(nz, ny, nx), "rhof", box)


# -- fields -----------------------------------------------------------------

def advance_b(F: dict, box: Box, frac: float) -> dict:
    """cB -= frac c dt curl E (a wall's normal cB sees tangential E, 0)."""
    px, py, pz = (box.p(a, frac * box.cvac * box.dt) for a in range(3))
    ex, ey, ez = (F[c] for c in E)
    return dict(F,
                cbx=F["cbx"] - (py * fwd(ez, 1, box) - pz * fwd(ey, 2, box)),
                cby=F["cby"] - (pz * fwd(ex, 2, box) - px * fwd(ez, 0, box)),
                cbz=F["cbz"] - (px * fwd(ey, 0, box) - py * fwd(ex, 1, box)))


def advance_e(F: dict, box: Box) -> dict:
    """E += c dt curl cB - dt/eps0 J (vacuum, no damping) over the PEC
    ghosts of tangential cB, then tangential E zeroed on the walls."""
    px, py, pz = (box.p(a, box.cvac * box.dt) for a in range(3))
    bx, by, bz = (F[c] for c in B)
    cj = box.dt / box.eps0
    F = dict(F,
             ex=F["ex"] + (py * bwd(bz, 1, box) - pz * bwd(by, 2, box))
             - cj * F["jfx"],
             ey=F["ey"] + (pz * bwd(bx, 2, box) - px * bwd(bz, 0, box))
             - cj * F["jfy"],
             ez=F["ez"] + (px * bwd(by, 0, box) - py * bwd(bx, 1, box))
             - cj * F["jfz"])
    return zero_walls(F, E, box)


def div_e(F: dict, box: Box):
    """div E on the nodes, over the PEC ghosts of normal E."""
    return sum(box.p(a, 1.0) * bwd(F[c], a, box) for a, c in enumerate(E))


def div_e_err(F: dict, rhof, box: Box):
    """div E - (rhof + rhob)/eps0, zero on the walls (local_adjust_div_e)."""
    return _zero(div_e(F, box) - (rhof + F["rhob"]) / box.eps0,
                 "div_e_err", box)


def div_b_err(F: dict, box: Box):
    return sum(box.p(a, 1.0) * fwd(F[c], a, box) for a, c in enumerate(B))


def _alphadt(box: Box):
    p = [box.p(a, 1.0) for a in range(3)]
    return MARDER / sum(v * v for v in p), p


def _nonzero(err, box: Box) -> bool:
    return pic._rms(err, box) > 0


def clean_e_pass(F: dict, err, box: Box) -> dict:
    """E += alphadt grad(div_e_err) (clean_div_e.c), tangential E zeroed
    on the walls."""
    al, p = _alphadt(box)
    F = dict(F, **{c: F[c] + al * p[a] * fwd(err, a, box)
                   for a, c in enumerate(E)})
    return zero_walls(F, E, box)


def clean_b_pass(F: dict, err, box: Box) -> dict:
    """cB += alphadt grad(div_b_err) over the PEC ghosts of div_b_err
    (clean_div_b.c)."""
    al, p = _alphadt(box)
    return dict(F, **{c: F[c] + al * p[a] * bwd(err, a, box)
                      for a, c in enumerate(B)})


def clean_div_e(F: dict, species, box: Box) -> dict:
    """advance.cxx:151-173: up to two Marder passes, each where the rms
    error before it is above 0."""
    rhof = rho(species, box, F["ex"].dtype)
    for _ in range(2):
        err = div_e_err(F, rhof, box)
        if not _nonzero(err, box):
            break
        F = clean_e_pass(F, err, box)
    return F


def clean_div_b(F: dict, box: Box) -> dict:
    """advance.cxx:177-195, as :func:`clean_div_e`."""
    for _ in range(2):
        err = div_b_err(F, box)
        if not _nonzero(err, box):
            break
        F = clean_b_pass(F, err, box)
    return F


# -- the step and the initial state ------------------------------------------

def step(F: dict, species: list, box: Box, t: int, cleans: dict):
    """One step from step ``t``, as ``pic.step``: push every species,
    unload the current, B half, E, B half, the interval cleans.  Returns
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
    """A field component set from ``fn(x, y, z)``: evaluated at its Yee
    positions (deck_wrapper.cxx:467-503); along a periodic axis where it
    lies on the nodes the seam's two planes averaged into one, as the
    first shared-face sync does (remote.c:298-414); along a wall axis
    every node plane kept.  Returns a float64 numpy array [z, y, x]."""
    import numpy as np
    axes, seams = [], []
    for a in range(3):
        node = on_nodes(comp, a)
        k = box.n[a] + node
        axes.append(box.lo[a] + (np.arange(k) + (0.0 if node else 0.5))
                    * box.d[a])
        seams.append(node and not box.walls[a])
    Z, Y, X = np.meshgrid(axes[2], axes[1], axes[0], indexing="ij")
    v = np.broadcast_to(np.asarray(fn(X, Y, Z), np.float64), X.shape).copy()
    for a in range(3):
        if seams[a]:
            ax = 2 - a
            first = np.take(v, [0], axis=ax)
            last = np.take(v, [box.n[a]], axis=ax)
            v = np.concatenate([0.5 * (first + last),
                                np.take(v, range(1, box.n[a]), axis=ax)],
                               axis=ax)
    return v


def shape(comp: str, box: Box) -> tuple:
    """``comp``'s ``[z, y, x]`` shape on the mesh."""
    return tuple(box.n[a] + (box.walls[a] and on_nodes(comp, a))
                 for a in (2, 1, 0))


def initial_state(inputs: dict, box: Box, dtype, device):
    """initialize.cxx:13-100 on the deck's inputs, as
    ``pic.initial_state``: tangential E zeroed on the walls (the first
    sync's adjust), one div B clean, rhob from the charge (zero on the
    walls), a div E clean where its rms error is above 0, and the momenta
    uncentered.  ``inputs``: ``fields`` (component -> its values on the
    mesh, float64, :func:`sample`) and ``species`` (each ``q_m`` and the
    float64 columns ``x, y, z, ux, uy, uz, q``).  Returns (fields,
    species)."""
    F = {c: torch.zeros(shape(c, box), dtype=dtype, device=device)
         for c in E + B + J + ("rhob",)}
    for c, v in inputs["fields"].items():
        F[c] = torch.as_tensor(v, device=device).to(dtype)
    F = zero_walls(F, E, box)
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
    F["rhob"] = _zero(box.eps0 * div_e(F, box) - rhof, "rhob", box)
    err = div_e_err(F, rhof, box)
    if _nonzero(err, box):
        F = clean_e_pass(F, err, box)
    ip = interpolator(F, box)
    return F, [uncenter(sp, ip, box) for sp in species]
