"""The banded-dump global header (``<base>.vpc``) for visualization tools
(``vpic_tpu/io/global_header.py``; vpic_simulation::global_header,
src/vpic/dump.cxx:978-1115): an ASCII metadata file describing the grid,
topology, and the variable lists of the field dump plus each species'
hydro dump."""

from __future__ import annotations

from pathlib import Path

from .banded import DumpParameters

# dump.cxx:892-914 fieldInfo: (name, degree, elements, type, size) per
# output GROUP; the group -> component mapping follows field_indeces.
FIELD_INFO = (
    ("Electric Field", "VECTOR", 3, "FLOATING_POINT", 4, ("ex", "ey", "ez")),
    ("Electric Field Divergence Error", "SCALAR", 1, "FLOATING_POINT", 4,
     ("div_e_err",)),
    ("Magnetic Field", "VECTOR", 3, "FLOATING_POINT", 4,
     ("cbx", "cby", "cbz")),
    ("Magnetic Field Divergence Error", "SCALAR", 1, "FLOATING_POINT", 4,
     ("div_b_err",)),
    ("TCA Field", "VECTOR", 3, "FLOATING_POINT", 4,
     ("tcax", "tcay", "tcaz")),
    ("Bound Charge Density", "SCALAR", 1, "FLOATING_POINT", 4, ("rhob",)),
    ("Free Current Field", "VECTOR", 3, "FLOATING_POINT", 4,
     ("jfx", "jfy", "jfz")),
    ("Charge Density", "SCALAR", 1, "FLOATING_POINT", 4, ("rhof",)),
)

# dump.cxx:916-928 hydroInfo
HYDRO_INFO = (
    ("Current Density", "VECTOR", 3, "FLOATING_POINT", 4,
     ("jx", "jy", "jz")),
    ("Charge Density", "SCALAR", 1, "FLOATING_POINT", 4, ("rho",)),
    ("Momentum Density", "VECTOR", 3, "FLOATING_POINT", 4,
     ("px", "py", "pz")),
    ("Kinetic Energy Density", "SCALAR", 1, "FLOATING_POINT", 4, ("ke",)),
    ("Stress Tensor", "TENSOR", 6, "FLOATING_POINT", 4,
     ("txx", "tyy", "tzz", "tyz", "tzx", "txy")),
)

_RULE = "#" * 80


def _comment(lines, text):
    lines += [_RULE, f"# {text}", _RULE]


def _groups(info, selected):
    out = []
    for name, degree, elements, typ, size, comps in info:
        if not selected or any(c in selected for c in comps):
            out.append((name, degree, elements, typ, size))
    return out


def write_global_header(base, g, field_dp: DumpParameters,
                        species_dumps, field_dir="fields",
                        field_base="fields"):
    """Write ``<base>.vpc``.

    species_dumps: list of (name, directory, base_filename,
    DumpParameters) per output species, mirroring the dumpParams vector
    (dump.cxx:978).
    """
    lines = []
    _comment(lines, "Header version information")
    lines.append("VPIC_HEADER_VERSION 1.0.0\n")
    _comment(lines, "Header size for data file headers in bytes")
    lines.append("DATA_HEADER_SIZE 123\n")
    _comment(lines, "Time step increment")
    lines.append(f"GRID_DELTA_T {g.dt:f}\n")
    _comment(lines, "GRID_CVAC")
    lines.append(f"GRID_CVAC {g.cvac:f}\n")
    _comment(lines, "GRID_EPS0")
    lines.append(f"GRID_EPS0 {g.eps0:f}\n")
    _comment(lines, "Grid extents in the x-dimension")
    lines.append(f"GRID_EXTENTS_X {g.gx0:f} {g.gx1:f}\n")
    _comment(lines, "Grid extents in the y-dimension")
    lines.append(f"GRID_EXTENTS_Y {g.gy0:f} {g.gy1:f}\n")
    _comment(lines, "Grid extents in the z-dimension")
    lines.append(f"GRID_EXTENTS_Z {g.gz0:f} {g.gz1:f}\n")
    _comment(lines, "Spatial step increment in x-dimension")
    lines.append(f"GRID_DELTA_X {g.dx:f}\n")
    _comment(lines, "Spatial step increment in y-dimension")
    lines.append(f"GRID_DELTA_Y {g.dy:f}\n")
    _comment(lines, "Spatial step increment in z-dimension")
    lines.append(f"GRID_DELTA_Z {g.dz:f}\n")
    _comment(lines, "Domain partitions in x-dimension")
    lines.append(f"GRID_TOPOLOGY_X {g.gpx}\n")
    _comment(lines, "Domain partitions in y-dimension")
    lines.append(f"GRID_TOPOLOGY_Y {g.gpy}\n")
    _comment(lines, "Domain partitions in z-dimension")
    lines.append(f"GRID_TOPOLOGY_Z {g.gpz}\n")

    _comment(lines, "Field data information")
    lines.append(f"FIELD_DATA_DIRECTORY {field_dir}")
    lines.append(f"FIELD_DATA_BASE_FILENAME {field_base}")
    groups = _groups(FIELD_INFO, field_dp.select)
    lines.append(f"FIELD_DATA_VARIABLES {len(groups)}")
    for name, degree, elements, typ, size in groups:
        lines.append(f'"{name}" {degree} {elements} {typ} {size}')
    lines.append("")

    _comment(lines, "Number of species with output data")
    lines.append(f"NUM_OUTPUT_SPECIES {len(species_dumps)}\n")
    for k, (name, sdir, sbase, dp) in enumerate(species_dumps, start=1):
        _comment(lines, f"Species({k}) data information")
        lines.append(f"SPECIES_DATA_DIRECTORY {sdir}")
        lines.append(f"SPECIES_DATA_BASE_FILENAME {sbase}")
        groups = _groups(HYDRO_INFO, dp.select)
        lines.append(f"HYDRO_DATA_VARIABLES {len(groups)}")
        for gname, degree, elements, typ, size in groups:
            lines.append(f'"{gname}" {degree} {elements} {typ} {size}')
        if k < len(species_dumps):
            lines.append("")

    path = Path(f"{base}.vpc")
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text("\n".join(lines) + "\n")
    return path
