"""Shared helpers of the port's multi-shard tests (tests/test_torch_shard*.py
and tests/test_torch_shard_graphs.py): the decks of
tests/multi_device/test_shard*.py in either package, per-shard snapshots,
and the bars that hold the port to the JAX package and to its own
one-shard run (see tests/test_torch_shard.py).  Not collected: the name
does not start with ``test_``."""

import dataclasses

import numpy as np

from vpic_tpu_torch.core.types import FIELD_COMPONENTS
from vpic_tpu_torch.deck.api import Simulation as TSim
from vpic_tpu_torch.engine import distributed as tdist
from vpic_tpu_torch.interop import state_to_numpy, unstack_numpy
from vpic_tpu_torch.io import tracers as iotracers

ULPS = 16
EPS32 = float(np.finfo(np.float32).eps)
E_BAR = 1e-6
L = 1.0


def port(seed):
    return TSim(seed=seed, device="cpu")


def deck(make, px=1, py=1, pz=1, seed=3, **opts):
    """tests/multi_device/test_shard.py:build in either package, with
    ``opts`` for its StepOptions."""
    nx, ny, nz = 8, 4, 4
    sim = make(seed)
    sim.define_units(1.0, 1.0)
    sim.define_timestep(0.9 * sim.courant_length(L, L, L, nx, ny, nz))
    sim.define_periodic_grid(0, 0, 0, L, L, L, nx, ny, nz, px, py, pz)
    sim.opts = dataclasses.replace(sim.opts, **opts)
    sim.define_material("vacuum")
    e = sim.define_species("electron", -1.0, 4096)
    rng = np.random.default_rng(12345)
    n = 1024
    x, y, z = (rng.uniform(0, L, n) for _ in range(3))
    ux, uy, uz = (rng.normal(0, 0.3, n) for _ in range(3))
    sim.inject_particle(e, x, y, z, ux, uy, uz, q=-1.0 / n)
    sim.set_field("ex", lambda x, y, z: 0.01 * np.sin(2 * np.pi * x))
    sim.set_field("cbz", lambda x, y, z: 0.02 * np.cos(2 * np.pi * y))
    sim.finalize()
    return sim


def bounded(make, px=1, pz=1, seed=9):
    """test_shard.py:build_bounded: reflecting x faces, absorbing y."""
    nx, ny, nz = 8, 6, 4
    sim = make(seed)
    sim.define_units(1.0, 1.0)
    sim.define_timestep(0.9 * sim.courant_length(L, L, L, nx, ny, nz))
    sim.define_reflecting_grid(0, 0, 0, L, L, L, nx, ny, nz, px, 1, pz)
    sim.set_domain_particle_bc(1, "absorb")
    sim.set_domain_particle_bc(4, "absorb")
    sim.opts = dataclasses.replace(sim.opts, clean_div_e_interval=1)
    sim.define_material("vacuum")
    e = sim.define_species("electron", -1.0, 4096)
    rng = np.random.default_rng(777)
    n = 1024
    x, y, z = (rng.uniform(0.05, 0.95, n) for _ in range(3))
    ux, uy, uz = (rng.normal(0, 0.4, n) for _ in range(3))
    sim.inject_particle(e, x, y, z, ux, uy, uz, q=-1.0 / n)
    sim.set_field("ex", lambda x, y, z: 0.01 * np.sin(np.pi * x))
    sim.finalize()
    return sim


def cycled(make, px=1, seed=3, resort=2, ion_mult=2):
    """test_shard.py:_build_cycled: two species, the resort cadence."""
    nx, ny, nz = 8, 4, 4
    sim = make(seed)
    sim.define_units(1.0, 1.0)
    sim.define_timestep(0.9 * sim.courant_length(L, L, L, nx, ny, nz))
    sim.define_periodic_grid(0, 0, 0, L, L, L, nx, ny, nz, px, 1, 1)
    sim.define_material("vacuum")
    sim.opts = dataclasses.replace(sim.opts, resort_interval=resort)
    e = sim.define_species("electron", -1.0, 4096)
    i = sim.define_species("ion", 1.0 / 25.0, 4096,
                           sort_interval=ion_mult * resort)
    rng = np.random.default_rng(777)
    n = 1024
    for sp, sgn, ut in ((e, -1.0, 0.3), (i, 1.0, 0.06)):
        x, y, z = (rng.uniform(0, L, n) for _ in range(3))
        sim.inject_particle(sp, x, y, z, rng.normal(0, ut, n),
                            rng.normal(0, ut, n), rng.normal(0, ut, n),
                            q=sgn / n)
    sim.set_field("ex", lambda x, y, z: 0.01 * np.sin(2 * np.pi * x))
    sim.finalize()
    return sim


# -- snapshots --------------------------------------------------------------


def shard_dicts(sim):
    """Per-shard numpy dicts in rank order, from either package."""
    g = sim.grid
    if isinstance(sim, TSim):
        return [state_to_numpy(st) for st in sim.states]
    d = state_to_numpy(sim.state)
    return unstack_numpy(d, g.gpx * g.gpy * g.gpz) if g.is_multishard \
        else [d]


def owned_field(dicts, g, comp):
    """The owned block of ``comp`` over the global box."""
    own = lambda d: d[f"field/{comp}"][1:g.nz + 1, 1:g.ny + 1, 1:g.nx + 1]
    rank = lambda sx, sy, sz: sx + g.gpx * (sy + g.gpy * sz)
    return np.concatenate([np.concatenate([np.concatenate(
        [own(dicts[rank(sx, sy, sz)]) for sx in range(g.gpx)], axis=2)
        for sy in range(g.gpy)], axis=1) for sz in range(g.gpz)], axis=0)


def particle_set(dicts, g, k=0):
    """The live lanes of species k over every shard, with voxels on the
    global ghosted grid, ordered by (global voxel, dx, dy, dz)."""
    cols = {c: [] for c in ("gi", "dx", "dy", "dz", "ux", "uy", "uz", "q",
                            "tag")}
    for r, d in enumerate(dicts):
        pre = f"species/{k}/"
        i = d[pre + "i"]
        alive = (np.arange(i.shape[0]) < int(d[pre + "np"])) & (i >= 0)
        shard = tdist.shard_coords(g)[r]
        cols["gi"].append(iotracers.globalize_voxels(g, i[alive], shard))
        for c in cols:
            if c != "gi":
                cols[c].append(d[pre + c][alive])
    cols = {c: np.concatenate(v) for c, v in cols.items()}
    order = np.lexsort((cols["dz"], cols["dy"], cols["dx"], cols["gi"]))
    return {c: v[order] for c, v in cols.items()}


def snap(sim):
    return dict(g=sim.grid, d=shard_dicts(sim), e=sim.energies(),
                nm=sim.mover_counts())


def run(sim, steps):
    """The snapshot of ``sim`` advanced ``steps`` steps."""
    sim.advance(steps)
    return snap(sim)


def near(a, b, scale, what):
    """``a`` within ULPS float32 ulps of ``scale`` of ``b``; returns the
    largest difference in those ulps."""
    d = float(np.abs(np.asarray(a, np.float64) - b).max(initial=0.0))
    assert d <= ULPS * EPS32 * scale, (
        f"{what}: max |diff| {d!r}, {d / (EPS32 * scale or 1.0):.1f} ulps "
        f"of {scale!r}")
    return d / (EPS32 * scale) if d else 0.0


SCALE_OF = dict(
    **dict.fromkeys(("ex", "ey", "ez"), ("ex", "ey", "ez")),
    **dict.fromkeys(("cbx", "cby", "cbz", "div_b_err"),
                    ("cbx", "cby", "cbz")),
    **dict.fromkeys(("tcax", "tcay", "tcaz"), ("tcax", "tcay", "tcaz")),
    **dict.fromkeys(("jfx", "jfy", "jfz"), ("jfx", "jfy", "jfz")),
    **dict.fromkeys(("rhob", "rhof", "div_e_err"), ("rhob", "rhof")))


def field_scale(dicts, comp):
    """The largest magnitude over the shards of the vector ``comp``
    belongs to (E, cB, tca, J; rho for the charges and div_e_err, which
    is div E less rho; cB for div_b_err)."""
    return max(float(np.abs(d[f"field/{c}"]).max())
               for d in dicts for c in SCALE_OF[comp])


def same_fields(t_dicts, j_dicts):
    """Every field component of every shard; returns the largest
    difference in ulps."""
    return max(near(a[f"field/{comp}"], b[f"field/{comp}"],
                    field_scale(j_dicts, comp), f"shard {r} {comp}")
               for comp in FIELD_COMPONENTS
               for r, (a, b) in enumerate(zip(t_dicts, j_dicts)))


def check_against_jax(t, j, species=1):
    """The port's snapshot ``t`` against the JAX package's ``j`` of the
    same topology."""
    g = t["g"]
    worst = dict(fields=same_fields(t["d"], j["d"]), particles=0.0)
    for k in range(species):
        a, b = particle_set(t["d"], g, k), particle_set(j["d"], g, k)
        np.testing.assert_array_equal(a["gi"], b["gi"])
        np.testing.assert_array_equal(a["tag"], b["tag"])
        for c in ("dx", "dy", "dz", "ux", "uy", "uz", "q"):
            worst["particles"] = max(worst["particles"], near(
                a[c], b[c], float(np.abs(b[c]).max(initial=0.0)),
                f"species {k} {c}"))
    for name, e in j["e"].items():
        np.testing.assert_allclose(t["e"][name], e, rtol=E_BAR, atol=1e-12,
                                   err_msg=name)
    assert t["nm"] == j["nm"]
    worst["energy_rel"] = max(abs(t["e"][n] - e) / abs(e)
                              for n, e in j["e"].items() if e)
    return worst


def check_against_one(many, one, comps, rtol=2e-4, atol=2e-5, e_rtol=1e-4,
                      species=1):
    """The port's N-shard snapshot against its one-shard run at the JAX
    test's bars; alive counts exact."""
    for comp in comps:
        np.testing.assert_allclose(owned_field(many["d"], many["g"], comp),
                                   owned_field(one["d"], one["g"], comp),
                                   rtol=rtol, atol=atol, err_msg=comp)
    for k, e in one["e"].items():
        np.testing.assert_allclose(many["e"][k], e, rtol=e_rtol, atol=1e-9,
                                   err_msg=k)
    for k in range(species):
        assert alive(many, k) == alive(one, k)


def alive(s, k=0):
    return sum(int(((np.arange(d[f"species/{k}/i"].shape[0])
                     < int(d[f"species/{k}/np"]))
                    & (d[f"species/{k}/i"] >= 0)).sum()) for d in s["d"])
