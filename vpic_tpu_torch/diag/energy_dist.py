"""In-deck kinetic-energy diagnostics (``vpic_tpu/diag/energy_dist.py``;
decks/trecon-part/energy.cxx:1-201), computed on the species' device:

- :func:`energy_band_dist`: the per-cell energy-banded distribution.
  ``nex`` linear bands of width dke = emax*eth/nex (eth = vth^2/2); each
  live particle's relativistic KE (gamma - 1) counts in band k of its
  cell, overflow in the last band; each cell normalized to unit sum, and
  ghost cells take their inward neighbor's values.
- :func:`energy_spectrum`: the global log-spaced KE histogram, nbin bins
  over [1e-4, 1e4) in log10(ke) with the reference's +1 bin offset.
- :func:`dump_energy_diag` / :func:`read_energy_diag`: the files, with the
  reference's names (turbulence.cxx:27-28).

Counts are integers; the float arithmetic is the JAX package's numpy
operation order in float32 (the spectrum's bin arithmetic after log10 in
float64, as numpy promotes it), with true divisions by tensors so that no
division becomes a multiplication by a reciprocal.  Only the (nex, nv) and
(nbin,) results reach the host.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from ..interop import to_numpy


def relativistic_ke(ux, uy, uz):
    """gamma - 1 in mc^2 units (energy.cxx:99-101), float32.  The square
    root is taken in float64 and rounded once to float32, which is the
    correctly rounded float32 root on every device (PyTorch's float32
    ``sqrt`` on the CPU is not)."""
    gam2 = 1.0 + ux * ux + uy * uy + uz * uz
    return torch.sqrt(gam2.to(torch.float64)).to(torch.float32) - 1.0


def _div(a, b: float):
    """a / float32(b), one correctly rounded division."""
    return a / torch.full_like(a, b)


def energy_band_dist(g, ux, uy, uz, cell, alive, nex: int, emax: float,
                     vth: float):
    """(nex, nv) float32 normalized per-cell energy-band distribution."""
    eth = vth * vth / 2.0
    dke = emax * eth / nex
    ke = relativistic_ke(ux[alive], uy[alive], uz[alive])
    k = torch.clamp(_div(ke, dke).to(torch.int64), max=nex - 1)
    cells = cell[alive].to(torch.int64)
    counts = torch.bincount(k * g.nv + cells, minlength=nex * g.nv)
    counts = counts.reshape(nex, g.nv)
    tot = counts.sum(dim=0)
    dist = counts.to(torch.float32)
    dist = torch.where(tot > 0, dist / torch.clamp(tot, min=1)
                       .to(torch.float32), dist)

    # ghost cells copy their inward-clamped neighbor (energy.cxx:138-160)
    dev = dist.device
    iz, iy, ix = torch.meshgrid(torch.arange(g.nzg, device=dev),
                                torch.arange(g.nyg, device=dev),
                                torch.arange(g.nxg, device=dev),
                                indexing="ij")
    nid = (ix.clamp(1, g.nx) + g.nxg * (iy.clamp(1, g.ny)
                                        + g.nyg * iz.clamp(1, g.nz)))
    return dist[:, nid.reshape(-1)]


def energy_spectrum(ux, uy, uz, alive, vth: float, nbin: int = 800,
                    eminp: float = 1e-4, emaxp: float = 1e4):
    """(nbin,) float32 global log-KE histogram (energy.cxx:95-110)."""
    ke = relativistic_ke(ux[alive], uy[alive], uz[alive])
    lo = float(np.log10(eminp))
    dloge = float((np.log10(emaxp) - np.log10(eminp)) / nbin)
    ke = ke[ke > 0]
    t = torch.log10(ke).to(torch.float64) - lo
    # the reference's bin index includes a +1 offset (energy.cxx:108)
    k = (t / torch.full_like(t, dloge) + 1).to(torch.int64)
    k = k[(k >= 0) & (k <= nbin - 1)]
    return torch.bincount(k, minlength=nbin).to(torch.float32)


def dump_energy_diag(dirname, step: int, species_name: str, rank: int,
                     dist, edist):
    """Write the band and spectrum files with the reference layout
    (HYDRO_FILE_FORMAT 'hydro/T.%d/%s.%d.%d', SPEC_FILE_FORMAT
    'hydro/T.%d/spectrum-%s.%d.%d'; bands appended, spectrum rewritten)."""
    d = Path(dirname) / f"T.{step}"
    d.mkdir(parents=True, exist_ok=True)
    band_path = d / f"{species_name}.{step}.{rank}"
    with open(band_path, "ab") as fh:
        fh.write(np.ascontiguousarray(to_numpy(dist), "<f4").tobytes())
    spec_path = d / f"spectrum-{species_name}.{step}.{rank}"
    with open(spec_path, "wb") as fh:
        fh.write(np.ascontiguousarray(to_numpy(edist), "<f4").tobytes())
    return band_path, spec_path


def read_energy_diag(dirname, step: int, species_name: str, rank: int,
                     nex: int, nv: int, nbin: int = 800):
    """Readers for the two files -> ((nex, nv), (nbin,))."""
    d = Path(dirname) / f"T.{step}"
    dist = np.fromfile(d / f"{species_name}.{step}.{rank}",
                       "<f4").reshape(-1, nv)[-nex:]
    edist = np.fromfile(d / f"spectrum-{species_name}.{step}.{rank}", "<f4")
    return dist, edist
