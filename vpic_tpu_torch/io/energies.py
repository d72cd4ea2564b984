"""Energies time-series writer (``vpic_tpu/io/energies.py``;
dump_energies, src/vpic/dump.cxx:37-78): gnuplot-style text with a '%%'
header, one line per dump: step ex ey ez bx by bz <per-species KE...>."""

from __future__ import annotations

from pathlib import Path


def dump_energies(fname, step: int, field_en, species_en: dict,
                  dt: float, append: bool = True):
    path = Path(fname)
    path.parent.mkdir(parents=True, exist_ok=True)
    mode = "a" if append and path.exists() else "w"
    with open(path, mode) as f:
        if mode == "w":
            f.write("%% Layout\n%% step ex ey ez bx by bz")
            for name in species_en:
                f.write(f' "{name}"')
            f.write("\n")
            f.write(f"%% timestep = {dt:e}\n")
        f.write(f"{step}")
        for v in field_en:
            f.write(f" {float(v):e}")
        for v in species_en.values():
            f.write(f" {float(v):e}")
        f.write("\n")
