"""Field post-processing (``vpic_tpu/post/fields.py``; the reference's
analysis toolbox interfaces/matlab/gauge_fields.m, smooth_field.m,
center_field.m and interfaces/c/poynting2d.c's physics), in PyTorch:

- :func:`gauge_fields`: Coulomb-gauge scalar/vector potentials and the
  microscopic charge density from Yee-mesh E/B via FFT inversion of the
  7-point Laplacian (gauge_fields.m:28-41 math).
- :func:`smooth_field`: isotropic Fourier low-pass with a linear
  transition band between lambda_pass and lambda_stop
  (smooth_field.m:33-52).
- :func:`center_field`: node-centering by averaging, optionally undone
  spectrally (center_field.m:36-72).
- :func:`poynting_flux`: node-centered S = E x B / mu0 plus the 2D
  domain-boundary flux lines the poynting2d.c join tool consumes.

Inputs are tensors or numpy arrays; the outputs are float64 tensors on
the first input's device (``torch.fft`` on that device).  Array
convention: owned interior fields shaped (nz, ny, nx), z slowest, i.e.
``FieldState`` arrays with ghosts stripped (:func:`owned_interior`).  All
operations assume a periodic grid, like the originals.
"""

from __future__ import annotations

import math

import torch


def _f64(a, device=None) -> torch.Tensor:
    t = torch.as_tensor(a)
    return t.to(device=device or t.device, dtype=torch.float64)


def owned_interior(a, g) -> torch.Tensor:
    """Strip ghost planes from a (nzg, nyg, nxg) field array."""
    return torch.as_tensor(a)[1:g.nz + 1, 1:g.ny + 1, 1:g.nx + 1]


def _inv_laplacian_kernel(nx, ny, nz, dx, dy, dz, device):
    """Discretized 1/k^2 for the 7-point Yee Laplacian
    (gauge_fields.m:78-87), in (z,y,x) order."""
    line = lambda n, d: ((2.0 / d) * torch.sin(
        (math.pi / n) * torch.arange(n, dtype=torch.float64,
                                     device=device))) ** 2
    kern = (line(nz, dz)[:, None, None] + line(ny, dy)[None, :, None]
            + line(nx, dx)[None, None, :])
    kern[0, 0, 0] = 1.0
    kern = 1.0 / kern
    kern[0, 0, 0] = 0.0          # integral of potential = 0
    return kern


def _ddx_back(a, d, axis):
    """Backward difference with periodic wrap: (a - roll(a, +1)) / d."""
    return (a - torch.roll(a, 1, dims=axis)) / d


def _filter(kern, v):
    return torch.fft.ifftn(kern * torch.fft.fftn(v)).real


def gauge_fields(g, ex, ey, ez, bx, by, bz, eps0=None):
    """(phi, ax, ay, az, rho) in the Coulomb gauge (gauge_fields.m).

    Inputs are owned-interior Yee fields, (nz, ny, nx).  ``rho`` is
    eps0 * div E (microscopic charge density); potentials integrate to
    zero over the box."""
    eps0 = g.eps0 if eps0 is None else eps0
    dev = torch.as_tensor(ex).device
    ex, ey, ez, bx, by, bz = (_f64(a, dev) for a in (ex, ey, ez, bx, by, bz))
    kern = _inv_laplacian_kernel(g.nx, g.ny, g.nz, g.dx, g.dy, g.dz, dev)

    # div E on the Yee mesh (backward differences, gauge_fields.m:91-93)
    dive = (_ddx_back(ex, g.dx, 2) + _ddx_back(ey, g.dy, 1)
            + _ddx_back(ez, g.dz, 0))
    phi = _filter(kern, dive)

    # A = curl G with laplacian G = -B (gauge_fields.m:96-102)
    gx, gy, gz = (_filter(kern, b) for b in (bx, by, bz))
    ax = _ddx_back(gz, g.dy, 1) - _ddx_back(gy, g.dz, 0)
    ay = _ddx_back(gx, g.dz, 0) - _ddx_back(gz, g.dx, 2)
    az = _ddx_back(gy, g.dx, 2) - _ddx_back(gx, g.dy, 1)

    return phi, ax, ay, az, eps0 * dive


def smooth_field(g, v, lambda_stop, lambda_pass):
    """Fourier low-pass (smooth_field.m): wavelengths < lambda_stop
    removed, > lambda_pass preserved, linear roll-off between."""
    v = _f64(v)
    nz, ny, nx = v.shape

    def kline(n, d):
        k = 2 * math.pi * torch.arange(n, dtype=torch.float64,
                                       device=v.device) / n
        k = torch.where(k > math.pi, k - 2 * math.pi, k)
        return k / d

    kx, ky, kz = kline(nx, g.dx), kline(ny, g.dy), kline(nz, g.dz)
    kr2 = (kz[:, None, None] ** 2 + ky[None, :, None] ** 2
           + kx[None, None, :] ** 2)
    kp2 = (2 * math.pi / lambda_pass) ** 2
    ks2 = (2 * math.pi / lambda_stop) ** 2
    hk = torch.where(kr2 < kp2, 1.0, torch.where(
        kr2 <= ks2, (ks2 - kr2) / (ks2 - kp2), 0.0))
    return _filter(hk, v)


def center_field(g, v, centered=(False, False, False), method=0):
    """Node-center ``v`` on a periodic grid (center_field.m).

    ``centered[a]`` is True when v is ALREADY node-aligned along axis a
    (x, y, z physical order); non-aligned axes are averaged with the
    periodic backward neighbor.  method=1 spectrally undoes the
    averaging's amplitude response (center_field.m:48-72)."""
    v = _f64(v)
    nz, ny, nx = v.shape
    for a in (0, 1, 2):
        if not centered[2 - a]:
            v = 0.5 * (torch.roll(v, 1, dims=a) + v)
    if method == 1:
        def filt(n, needs):
            if not needs:
                return torch.ones(n, dtype=torch.float64, device=v.device)
            gl = torch.abs(torch.cos(math.pi * torch.arange(
                n, dtype=torch.float64, device=v.device) / n))
            if n % 2 == 0:
                gl[n // 2] = 1.0
            gl = 1.0 / gl
            if n % 2 == 0:
                gl[n // 2] = 0.0    # lost Nyquist info
            return gl
        gz = filt(nz, not centered[2])
        gy = filt(ny, not centered[1])
        gx = filt(nx, not centered[0])
        v = _filter(gz[:, None, None] * gy[None, :, None]
                    * gx[None, None, :], v)
    return v


def poynting_flux(g, ex, ey, ez, cbx, cby, cbz, mu0=1.0):
    """Node-centered Poynting vector S = E x B / mu0 from owned-interior
    Yee fields, plus the 2D boundary flux lines (x-z plane) the
    poynting2d.c join tool aggregates: (sx, sy, sz, lines) with
    lines = dict(top, bottom, left, right) — S_z along the z faces
    (length nx) and S_x along the x faces (length nz)."""
    # centered[a] True = node-aligned along axis a: ex lies on x-edges
    # (averaged in x), cbx on x-faces (averaged in y and z)
    exc = center_field(g, ex, centered=(False, True, True))
    eyc = center_field(g, ey, centered=(True, False, True))
    ezc = center_field(g, ez, centered=(True, True, False))
    bxc = center_field(g, cbx, centered=(True, False, False))
    byc = center_field(g, cby, centered=(False, True, False))
    bzc = center_field(g, cbz, centered=(False, False, True))
    sx = (eyc * bzc - ezc * byc) / mu0
    sy = (ezc * bxc - exc * bzc) / mu0
    sz = (exc * byc - eyc * bxc) / mu0
    ymid = sx.shape[1] // 2
    lines = dict(
        bottom=sz[0, ymid, :].clone(), top=sz[-1, ymid, :].clone(),
        left=sx[:, ymid, 0].clone(), right=sx[:, ymid, -1].clone(),
    )
    return sx, sy, sz, lines
