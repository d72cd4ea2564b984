"""What one particle push needs, counted from the work and not from an
implementation (VPIC's advance_p + move_p on float32 particles): each
input read once and each output written once.

Per live particle: 8 float32 words read (3 offsets, the voxel, 3
momenta, the charge) and 7 written (offsets, voxel, momenta).  Per cell
of the mesh, once per species: its 18-word interpolator read and its
12-word current accumulator written.  Operations: 246 per push
(README.performance:8-10)."""

from __future__ import annotations

WORD = 4
PARTICLE_READ, PARTICLE_WRITTEN = 8, 7
INTERP, ACCUMULATOR = 18, 12
FLOPS_PER_PUSH = 246
# NVIDIA H100 SXM data sheet: HBM3 bandwidth and float32 rate outside the
# tensor cores, at the full 700 W power limit
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS_PER_S = 67e12


def push_bytes(live: int, cells: int) -> int:
    """Bytes one push of a species of ``live`` particles needs."""
    return (WORD * (PARTICLE_READ + PARTICLE_WRITTEN) * live
            + WORD * (INTERP + ACCUMULATOR) * cells)


def push_flops(live: int) -> int:
    return FLOPS_PER_PUSH * live


def least_seconds(live_per_species, cells: int) -> float:
    """The least time one step's pushes could take on the card: the larger
    of the bytes over the bandwidth and the operations over the rate."""
    b = sum(push_bytes(n, cells) for n in live_per_species)
    f = sum(push_flops(n) for n in live_per_species)
    return max(b / PEAK_BYTES_PER_S, f / PEAK_FLOPS_PER_S)
