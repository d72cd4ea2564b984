"""Field <-> particle staging arrays (``vpic_tpu/sf/interp.py``).

- :func:`load_interpolator`: Yee fields -> 18 coefficients per voxel
  (load_interpolator.cxx:72-121).
- :func:`unload_accumulator`: quadrant currents -> jf through the 7-point
  quadrant stencil scaled by 0.25*r*dA/dt (unload_accumulator.cxx:40-63).

The accumulator is ``(nv, 12)`` float32, components [jx0..jx3, jy0..jy3,
jz0..jz3] as ``accumulator_t`` (sf_interface.h:60-77).
"""

from __future__ import annotations

import torch

from ..core.types import FieldState, Grid, N_IP


def load_interpolator(f: FieldState, g: Grid) -> torch.Tensor:
    """The (nv, 18) interpolator (layout core.types.IP)."""
    nzg, nyg, nxg = g.shape

    def shifted(arr, dx=0, dy=0, dz=0):
        # zero-filled at the far end: those entries belong to ghost voxels
        # whose coefficients are never gathered
        out = torch.zeros_like(arr)
        out[:nzg - dz, :nyg - dy, :nxg - dx] = arr[dz:, dy:, dx:]
        return out

    fourth, half = 0.25, 0.5

    def e_coeffs(w0, w1, w2, w3):
        a = fourth * ((w3 + w0) + (w1 + w2))
        b = fourth * ((w3 - w0) + (w1 - w2))
        c = fourth * ((w3 - w0) - (w1 - w2))
        d = fourth * ((w3 + w0) - (w1 + w2))
        return a, b, c, d

    ex = e_coeffs(f.ex, shifted(f.ex, dy=1), shifted(f.ex, dz=1),
                  shifted(f.ex, dy=1, dz=1))
    ey = e_coeffs(f.ey, shifted(f.ey, dz=1), shifted(f.ey, dx=1),
                  shifted(f.ey, dz=1, dx=1))
    ez = e_coeffs(f.ez, shifted(f.ez, dx=1), shifted(f.ez, dy=1),
                  shifted(f.ez, dx=1, dy=1))
    bx1, by1, bz1 = (shifted(f.cbx, dx=1), shifted(f.cby, dy=1),
                     shifted(f.cbz, dz=1))
    comps = [*ex, *ey, *ez,
             half * (bx1 + f.cbx), half * (bx1 - f.cbx),
             half * (by1 + f.cby), half * (by1 - f.cby),
             half * (bz1 + f.cbz), half * (bz1 - f.cbz)]
    out = torch.stack([c.reshape(-1) for c in comps], dim=-1)
    assert out.shape == (g.nv, N_IP)
    return out


def unload_accumulator(f: FieldState, acc: torch.Tensor,
                       g: Grid) -> FieldState:
    """Accumulated quadrant currents -> f.jf; assumes the accumulator's
    ghost entries are zero (particles live in owned voxels only)."""
    a = acc.reshape(g.nzg, g.nyg, g.nxg, 12)
    cx = 0.25 * g.rdy * g.rdz / g.dt
    cy = 0.25 * g.rdz * g.rdx / g.dt
    cz = 0.25 * g.rdx * g.rdy / g.dt

    def back(k, dx=0, dy=0, dz=0):
        """a[..., k] at (x-dx, y-dy, z-dz) over the block [1, n+1]^3."""
        return a[1 - dz: g.nz + 2 - dz, 1 - dy: g.ny + 2 - dy,
                 1 - dx: g.nx + 2 - dx, k]

    blk = (slice(1, g.nz + 2), slice(1, g.ny + 2), slice(1, g.nx + 2))

    def add(arr, v):
        out = arr.clone()
        out[blk] += v
        return out

    return f.replace(
        jfx=add(f.jfx, cx * (back(0) + back(1, dy=1) + back(2, dz=1)
                             + back(3, dy=1, dz=1))),
        jfy=add(f.jfy, cy * (back(4) + back(5, dz=1) + back(6, dx=1)
                             + back(7, dz=1, dx=1))),
        jfz=add(f.jfz, cz * (back(8) + back(9, dx=1) + back(10, dy=1)
                             + back(11, dx=1, dy=1))))


def clear_jf(f: FieldState, g: Grid) -> FieldState:
    z = torch.zeros(g.shape, dtype=torch.float32, device=f.jfx.device)
    return f.replace(jfx=z, jfy=z, jfz=z)


def clear_rhof(f: FieldState, g: Grid) -> FieldState:
    return f.replace(rhof=torch.zeros(g.shape, dtype=torch.float32,
                                      device=f.rhof.device))
