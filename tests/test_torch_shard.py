"""Several shards in one process (vpic_tpu_torch/engine/distributed.py) on
the CPU, held to the JAX package's multi-shard engine topology for
topology: every case of tests/multi_device/test_shard.py at its size
(8x4x4 cells, 1024 lanes), built in both packages from the same deck on
the 8-device CPU mesh of tests/conftest.py, each JAX topology built once
in a module-scoped fixture.

Bars against the JAX package: voxels exact, particles compared as sets
ordered by (global voxel, position), every float array (each field
component of every shard, each particle column) within ULPS = 16 float32
ulps of its own scale (the largest magnitude in the JAX run of the
particle column, or of the field vector that the component belongs to:
E, cB, tca, J, or rho for the charges and div_e_err), energies to 1e-6
relative,
alive counts exact.  Measured on the CPU: at most 10.5 ulps (particle dx
of the two-shard run at step 20, where the orbits have amplified the
deposits' summation order for 20 steps), at most 8.0 ulps in every other
case (the absorb tally's particles; fields at most 7.1), energies within
1.6e-7 relative (this module's ``__main__`` prints each case's).  Against the
port's own one-shard run: the JAX test's bars (fields rtol 2e-4 / atol
2e-5, 3e-4 / 3e-5 where it uses them; energies rtol 1e-4).  Also: the
neighbor table of every shard, the voxel remap, two seeded multi-shard
runs with equal checksums, a bitwise multi-shard restart, the stacked
interop form, a broken or late shard failing the call in bounded time,
migration past ``mig_cap`` retried in the next round, and a two-shard run
of each of the port's decks against its one-shard run.

The cases are split in three files by the module fixtures they share:
test_torch_shard_equivalence.py (the two-shard, eight-shard and bounded
topologies), test_torch_shard_cycled.py (the resort cadence) and this one
(join_domain, the absorb tally, the load imbalance and the port's own
contracts); the shared decks, snapshots and checks are in
_torch_shard_common.py."""

import time
from pathlib import Path

import numpy as np
import pytest
import torch

from vpic_tpu.boundary.models import AbsorbTally as JTally
from vpic_tpu.core.types import ABSORB_FIELDS
from vpic_tpu.deck.api import Simulation as JSim
from vpic_tpu.grid import partition as jpart
from vpic_tpu.particles import boundary as jboundary

from vpic_tpu_torch.boundary.models import AbsorbTally as TTally
from vpic_tpu_torch.cli import run as cli
from vpic_tpu_torch.comm.facecomm import ShardError
from vpic_tpu_torch.core.types import Grid
from vpic_tpu_torch.engine import distributed as tdist
from vpic_tpu_torch.grid import partition as tpart
from vpic_tpu_torch.particles import boundary as tboundary

from tests import torch_decks
from tests._torch_shard_common import (L, alive, check_against_jax,
                                       check_against_one, deck, near,
                                       owned_field, particle_set, port, run,
                                       snap)


def skewed(make, px=1):
    """test_shard.py:build_skewed: every particle in shard 0's half."""
    nx, ny, nz = 8, 4, 4
    sim = make(7)
    sim.define_units(1.0, 1.0)
    sim.define_timestep(0.9 * sim.courant_length(L, L, L, nx, ny, nz))
    sim.define_periodic_grid(0, 0, 0, L, L, L, nx, ny, nz, px, 1, 1)
    sim.define_material("vacuum")
    e = sim.define_species("electron", -1.0, 4096)
    rng = np.random.default_rng(99)
    n = 1024
    sim.inject_particle(e, rng.uniform(0, 0.5 * L, n), rng.uniform(0, L, n),
                        rng.uniform(0, L, n), rng.normal(0, 0.3, n),
                        rng.normal(0, 0.3, n), rng.normal(0, 0.3, n),
                        q=-1.0 / n)
    sim.set_field("ex", lambda x, y, z: 0.01 * np.sin(2 * np.pi * x))
    sim.finalize()
    return sim


def tally_box(make, tally_cls, px=1):
    """test_shard.py:test_two_shard_absorb_tally's deck."""
    nx, ny, nz = 8, 4, 4
    sim = make(13)
    sim.define_units(1.0, 1.0)
    sim.define_timestep(0.9 * sim.courant_length(L, L, L, nx, ny, nz))
    sim.define_absorbing_grid(0, 0, 0, L, L, L, nx, ny, nz, px, 1, 1)
    tally = sim.define_boundary(tally_cls(n_species=1))
    for face in range(6):
        sim.set_domain_particle_bc(face, tally)
    sim.define_material("vacuum")
    e = sim.define_species("electron", -1.0, 4096)
    rng = np.random.default_rng(55)
    n = 1024
    sim.inject_particle(e, rng.uniform(0.05, 0.95, n),
                        rng.uniform(0.05, 0.95, n),
                        rng.uniform(0.05, 0.95, n),
                        rng.normal(0.3, 0.3, n), rng.normal(0, 0.2, n),
                        rng.normal(0, 0.2, n), q=-1.0 / n)
    sim.finalize()
    return sim, tally


_JOIN = np.random.default_rng(9911)
JOIN_N = 512
JOIN_LANES = (_JOIN.uniform(0, L, JOIN_N), _JOIN.uniform(0, L, JOIN_N),
              _JOIN.uniform(0, L, JOIN_N), _JOIN.normal(0.4, 0.3, JOIN_N),
              *_JOIN.normal(0, 0.3, (2, JOIN_N)))


def joined(make, loops: bool):
    """test_shard.py:test_join_domain_pairwise_loops: ``loops``, the
    [0, 2L] box of 4 x-shards wired as two 2-shard loops; else the 2-shard
    periodic box of L."""
    ny, nz = 4, 4
    sim = make(5)
    sim.define_units(1.0, 1.0)
    sim.define_timestep(0.9 * sim.courant_length(L, L, L, 8, ny, nz))
    if loops:
        sim.define_periodic_grid(0, 0, 0, 2 * L, L, L, 16, ny, nz, 4, 1, 1)
        sim.set_domain_field_bc(0, ABSORB_FIELDS)
        sim.set_domain_field_bc(3, ABSORB_FIELDS)
        sim.set_domain_particle_bc(0, "absorb")
        sim.set_domain_particle_bc(3, "absorb")
        sim.join_domain(3, (1, 0, 3, 2))
        sim.join_domain(0, (1, 0, 3, 2))
    else:
        sim.define_periodic_grid(0, 0, 0, L, L, L, 8, ny, nz, 2, 1, 1)
    sim.define_material("vacuum")
    e = sim.define_species("electron", -1.0, 4096)
    sim.inject_particle(e, *JOIN_LANES, q=-1.0 / JOIN_N)
    sim.finalize()
    return sim


# -- fixtures: each JAX topology built and run once --------------------------


@pytest.fixture(scope="module")
def joined_runs():
    return (run(joined(JSim, True), 6), run(joined(port, True), 6),
            run(joined(port, False), 6))


@pytest.fixture(scope="module")
def tally_runs():
    out = []
    for make, cls, px in ((JSim, JTally, 2), (port, TTally, 2),
                          (port, TTally, 1)):
        sim, tally = tally_box(make, cls, px)
        sim.advance(10)
        out.append(dict(snap(sim), tally=np.asarray(
            sim.boundary_tallies(tally))))
    return out


@pytest.fixture(scope="module")
def skewed_runs():
    return (run(skewed(JSim, px=2), 6), run(skewed(port, px=2), 6),
            run(skewed(port), 6))


# -- the cases of tests/multi_device/test_shard.py -------------------------


def test_multishard_cli_smoke(tmp_path, capsys):
    """The port's CLI on a 2-shard deck: the status line sums every
    shard's np."""
    path = tmp_path / "deck2.py"
    path.write_text('''
import numpy as np
from vpic_tpu_torch.deck.api import Simulation

def deck(device="cuda"):
    nx, ny, nz = 8, 4, 4
    L = 1.0
    sim = Simulation(seed=3, device=device)
    sim.define_units(1.0, 1.0)
    sim.define_timestep(0.9 * sim.courant_length(L, L, L, nx, ny, nz))
    sim.define_periodic_grid(0, 0, 0, L, L, L, nx, ny, nz, 2, 1, 1)
    sim.define_material("vacuum")
    e = sim.define_species("electron", -1.0, 4096)
    rng = np.random.default_rng(5)
    n = 256
    sim.inject_particle(e, rng.uniform(0, L, n), rng.uniform(0, L, n),
                        rng.uniform(0, L, n), rng.normal(0, 0.3, n),
                        rng.normal(0, 0.3, n), rng.normal(0, 0.3, n),
                        q=-1.0 / n)
    sim.num_step = 2
    return sim
''')
    assert cli.main([str(path), "--device", "cpu", "--status-interval",
                     "1"]) == 0
    out = capsys.readouterr().out
    assert "pushes/s" in out
    assert "done: 2 steps" in out


def test_join_domain_pairwise_loops(joined_runs):
    """A 4-shard x axis wired as two 2-shard loops: the left loop evolves
    as the 2-shard periodic box and the right loop stays empty; the port
    matches the JAX package's wiring."""
    j, t, b = joined_runs
    check_against_jax(t, j)
    g = t["g"]
    for comp in ("ex", "ey", "cbz", "jfx"):
        full = owned_field(t["d"], g, comp)
        np.testing.assert_allclose(full[..., :2 * g.nx],
                                   owned_field(b["d"], b["g"], comp),
                                   rtol=3e-4, atol=3e-5, err_msg=comp)
        assert np.abs(full[..., 2 * g.nx:]).max() == 0.0, comp
    assert alive(t) == alive(b) == JOIN_N


def test_two_shard_absorb_tally(tally_runs):
    j, t, t1 = tally_runs
    check_against_jax(t, j)
    assert int(t1["tally"][0]) == 1024 - alive(t1) > 0
    assert int(t["tally"][0]) == 1024 - alive(t) == int(t1["tally"][0])
    assert int(t["tally"][0]) == int(j["tally"][0])


def test_two_shard_static_load_imbalance(skewed_runs):
    j, t, t1 = skewed_runs
    check_against_jax(t, j)
    check_against_one(t, t1, ("ex", "ey", "ez", "cbx", "cby", "cbz"))
    assert alive(t) == 1024


# -- the port's own contracts ----------------------------------------------


@pytest.mark.parametrize("shards", [(2, 1, 1), (1, 2, 1), (2, 2, 2)])
@pytest.mark.parametrize("pbc", ["periodic", "reflect"])
def test_neighbor_table_of_every_shard(shards, pbc):
    """The per-shard neighbor tables, migrate codes included, equal the
    JAX package's for every shard."""
    from vpic_tpu.core.types import Grid as JGrid
    from vpic_tpu_torch.core.types import NEIGHBOR_REFLECT, PERIODIC_FIELDS

    code = PERIODIC_FIELDS if pbc == "periodic" else NEIGHBOR_REFLECT
    kw = dict(nx=4, ny=3, nz=2, gpx=shards[0], gpy=shards[1],
              gpz=shards[2], pbc=(code,) * 6)
    for shard in tdist.shard_coords(Grid(**kw)):
        np.testing.assert_array_equal(
            tpart.build_neighbor_table(Grid(**kw), shard),
            jpart.build_neighbor_table(JGrid(**kw), shard))


def test_remap_voxel_through_face_matches_jax():
    import jax.numpy as jnp
    from vpic_tpu.core.types import Grid as JGrid

    g, jg = Grid(nx=5, ny=4, nz=3), JGrid(nx=5, ny=4, nz=3)
    vox = torch.arange(g.nv, dtype=torch.int32)
    faces = torch.arange(g.nv, dtype=torch.int32) % 6
    for face in range(6):
        want = np.asarray(jboundary._remap_voxel_through_face(
            jg, jnp.asarray(vox.numpy()), face))
        np.testing.assert_array_equal(
            tboundary.remap_voxel_through_face(g, vox, face).numpy(), want)
        np.testing.assert_array_equal(tboundary.remap_voxel_through_face(
            g, vox, faces).numpy()[face::6], want[face::6])


def injecting(px, K=64):
    """deck()'s box with a user_particle_injection hook that adds K lanes
    a step at global positions on both halves of x, with aged pushes."""
    sim = port(3)
    sim.define_units(1.0, 1.0)
    sim.define_timestep(0.9 * sim.courant_length(L, L, L, 8, 4, 4))
    sim.define_periodic_grid(0, 0, 0, L, L, L, 8, 4, 4, px, 1, 1)
    sim.define_material("vacuum")
    e = sim.define_species("electron", -1.0, 4096)
    rng = np.random.default_rng(4)
    sim.inject_particle(e, *rng.uniform(0, L, (3, 256)),
                        *rng.normal(0, 0.3, (3, 256)), q=-1.0 / 256)
    inj = sim.make_injector("electron")
    pos = rng.uniform(0.05, 0.95, (3, K))
    mom = rng.normal(0, 0.3, (3, K)).astype(np.float32)
    age = rng.uniform(0, 1, K).astype(np.float32)

    def refill(state, acc, f):
        return inj(state, acc, f, x=pos[0], y=pos[1], z=pos[2], ux=mom[0],
                   uy=mom[1], uz=mom[2], q=np.full(K, -1.0 / 256,
                                                   np.float32), age=age)

    sim.finalize(user_particle_injection=refill)
    return sim, inj


def test_injection_on_shards_matches_one_shard():
    """Each shard's injector keeps the lanes of its own box (the step
    gives it its shard's comm): two shards inject, walk and migrate the
    same lanes as one shard over 4 steps: fields and energies at the JAX
    test's bars, the same voxels and the lanes' floats within ULPS ulps.  Outside the step the injector of a
    sharded grid has no shard and raises."""
    (one, _), (two, inj) = injecting(1), injecting(2)
    for sim in (one, two):
        sim.advance(4)
    a, b = snap(two), snap(one)
    check_against_one(a, b, ("ex", "ey", "ez", "cbx", "cby", "cbz", "jfx"))
    assert alive(a) == alive(b) == 256 + 4 * 64
    pa, pb = particle_set(a["d"], a["g"]), particle_set(b["d"], b["g"])
    np.testing.assert_array_equal(pa["gi"], pb["gi"])
    for c in ("dx", "dy", "dz", "ux", "uy", "uz"):
        near(pa[c], pb[c], float(np.abs(pb[c]).max()), c)
    st = two.states[0]
    acc = torch.zeros((two.grid.nv, 12))
    with pytest.raises(RuntimeError, match="sharded grid"):
        inj(st, acc, st.field, x=[0.5], y=[0.5], z=[0.5], ux=0.0, uy=0.0,
            uz=0.0, q=[0.0])


def test_seeded_multishard_runs_repeat():
    """Two 4-shard runs from one seed give equal checksums."""
    sums = []
    for _ in range(2):
        sim = deck(port, 2, 2, 1)
        sim.advance(4)
        sums.append((sim.checksum_fields(), sim.checksum_species("electron")))
    assert sums[0] == sums[1]


def test_multishard_restart_is_bitwise(tmp_path):
    """A checkpoint of every shard at step 3 restarts to the same fields
    and lanes at step 6 as the run that went on."""
    a = deck(port, 2, 1, 2)
    a.advance(3)
    a.checkpoint(tmp_path / "ck")
    a.advance(3)
    b = deck(port, 2, 1, 2)
    b.restore(tmp_path / "ck")
    assert b.step_count == 3
    b.advance(3)
    assert a.checksum_fields() == b.checksum_fields()
    assert a.checksum_species("electron") == b.checksum_species("electron")


def test_a_failing_shard_fails_the_call():
    """A shard that raises breaks the barrier of the others, and the call
    raises the shard's own exception, not the broken barrier."""
    g = Grid(nx=4, ny=4, nz=4, gpx=2)
    comms = tdist.make_comms(g, tdist.make_mesh(g, ["cpu"]), timeout=30)

    def body(comm):
        if comm.rank == 1:
            raise KeyError("shard one")
        comm.allsum(torch.tensor(1.0))

    t0 = time.perf_counter()
    with pytest.raises(KeyError, match="shard one"):
        tdist.run_shards(comms, body)
    assert time.perf_counter() - t0 < 10
    # the rendezvous is usable again
    assert [float(v) for v in tdist.run_shards(
        comms, lambda c: c.allsum(torch.tensor(float(c.rank))))] == [1.0, 1.0]


def test_a_barrier_timeout_raises_in_bounded_time():
    """A shard that never reaches the exchange that another waits at fails
    the call at once, and a shard that hangs makes the others' wait time
    out: the call raises ShardError after about the timeout."""
    g = Grid(nx=4, ny=4, nz=4, gpz=2)
    comms = tdist.make_comms(g, tdist.make_mesh(g, ["cpu"]), timeout=0.5)

    def skips(comm):
        if comm.rank == 0:
            comm.exchange({2: torch.zeros(3), 5: torch.zeros(3)})

    t0 = time.perf_counter()
    with pytest.raises(ShardError, match="finished without reaching"):
        tdist.run_shards(comms, skips)
    assert time.perf_counter() - t0 < 5

    def hangs(comm):
        if comm.rank == 0:
            time.sleep(1.5)
        comm.allsum(torch.tensor(1.0))

    t0 = time.perf_counter()
    with pytest.raises(ShardError, match="exceeded 0.5 s"):
        tdist.run_shards(comms, hangs)
    assert time.perf_counter() - t0 < 5


def test_shards_run_one_at_a_time():
    """The rendezvous runs the shard threads in turns by rank between
    barriers: no two of 16 shards run at once, with the interpreter
    switching threads every 10 us."""
    import sys

    g = Grid(nx=2, ny=2, nz=2, gpx=16)
    comms = tdist.make_comms(g, tdist.make_mesh(g, ["cpu"]), timeout=30)
    running, log = [0], []

    def body(comm):
        for k in range(3):
            running[0] += 1
            assert running[0] == 1
            log.append((k, comm.rank))
            time.sleep(0.001)
            running[0] -= 1
            comm.allsum(torch.tensor(0.0))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        tdist.run_shards(comms, body)
    finally:
        sys.setswitchinterval(interval)
    assert log == [(k, r) for k in range(3) for r in range(16)]


def test_exchange_pairing_follows_the_jax_ring():
    """A high face receives from shard s+1, a low face from s-1, a joined
    face from join[face][s] (vpic_tpu/comm/facecomm.py:89-115)."""
    g = Grid(nx=2, ny=2, nz=2, gpx=4)
    comms = tdist.make_comms(g, tdist.make_mesh(g, ["cpu"]), timeout=30)
    got = tdist.run_shards(comms, lambda c: c.exchange(
        {0: torch.tensor([c.rank]), 3: torch.tensor([10 + c.rank])}))
    for r, recv in enumerate(got):
        assert int(recv[0]) == 10 + (r - 1) % 4
        assert int(recv[3]) == (r + 1) % 4
    g = Grid(nx=2, ny=2, nz=2, gpx=4, join=((1, 0, 3, 2), None, None,
                                             (1, 0, 3, 2), None, None))
    comms = tdist.make_comms(g, tdist.make_mesh(g, ["cpu"]), timeout=30)
    got = tdist.run_shards(comms, lambda c: c.exchange(
        {0: torch.tensor([c.rank]), 3: torch.tensor([10 + c.rank])}))
    for r, recv in enumerate(got):
        assert int(recv[0]) == 10 + (1, 0, 3, 2)[r]
        assert int(recv[3]) == (1, 0, 3, 2)[r]
    assert [c.is_global_boundary(0) for c in comms] == [False] * 4


def test_migration_past_mig_cap_is_retried():
    """With two lanes per face per round, the lanes that do not fit keep
    their code and cross in a later round; lanes still pending after the
    last round are counted in nm, as the JAX package counts them, and no
    lane is lost.  Which lanes go first follows the slot order, so the
    port runs unsorted, as the JAX package's CPU path does (the unfused
    push without the sorted deposit)."""
    free = deck(port, px=2)
    capped = deck(port, px=2, mig_cap=2, fused_push=False,
                  sorted_deposit=False)
    jcapped = deck(JSim, px=2, mig_cap=2)
    for sim in (free, capped, jcapped):
        sim.advance(2)
    t, j = snap(capped), snap(jcapped)
    assert t["nm"] == j["nm"]
    assert alive(t) == alive(j) == alive(snap(free)) == 1024
    assert t["nm"]["electron"] > 0 and free.mover_counts()["electron"] == 0
    check_against_jax(t, j)


DECK_CASES = {
    "turbulence": (dict(TURB_NX=8, TURB_NY=8, TURB_NZ=8, TURB_PPC=2),
                   "TURB_PZ"),
    "trecon": (dict(TRECON_NX=16, TRECON_NZ=8, TRECON_PPC=4), "TRECON_PX"),
    "sigma": (dict(SIGMA_NX=16, SIGMA_NZ=8, SIGMA_PPC=4), "SIGMA_PZ"),
    "turbulence_fan": (dict(FAN_NX=8, FAN_NY=8, FAN_NZ=8, FAN_PPC=2),
                       "FAN_PY"),
}


@pytest.mark.parametrize("name", sorted(DECK_CASES))
def test_deck_on_two_shards_matches_one(monkeypatch, name):
    """Each of the port's decks, its shard knob at 2, against its own
    one-shard run over 8 steps at the JAX test's bars."""
    env, knob = DECK_CASES[name]
    runs = []
    for shards in (1, 2):
        _, tmod = torch_decks.modules(monkeypatch, name, {**env,
                                                          knob: shards})
        sim = tmod.deck(device="cpu")
        if not sim.states:
            sim.finalize()
        sim.advance(8)
        runs.append(dict(snap(sim), sim=sim))
    one, two = runs
    assert two["g"].n_shards == 2
    check_against_one(two, one, ("ex", "ey", "ez", "cbx", "cby", "cbz"),
                      rtol=3e-4, atol=3e-5, e_rtol=2e-4,
                      species=len(one["sim"].states[0].species))
    assert two["nm"] == one["nm"]


TURB = Path(__file__).resolve().parents[1] / "vpic_tpu_torch" / "decks" \
    / "turbulence.py"
TURB_ENV = dict(TURB_NX=8, TURB_NY=8, TURB_NZ=8, TURB_PPC=2, TURB_PZ=2,
                TURB_ENERGY_INTERVAL=1, TURB_FIELD_INTERVAL=2,
                TURB_PARTICLE_INTERVAL=4, TURB_RESTART_INTERVAL=2,
                TURB_TRACER_INTERVAL=2, TURB_SPECTRUM_INTERVAL=4)


def _turb_cli(monkeypatch, out, *args):
    for k, v in {**TURB_ENV, "TURB_OUT": out}.items():
        monkeypatch.setenv(k, str(v))
    return cli.main([str(TURB), "--device", "cpu", "--num-step", "4",
                     "--status-interval", "2", *args])


def test_sharded_cli_restart_reproduces_every_rank_dump(monkeypatch,
                                                        tmp_path):
    """The turbulence deck on two z shards (PEC z walls) through the CLI
    with its diagnostics: one dump per rank of each kind, a restart from
    step 2 that reproduces every step-4 dump of both ranks byte for byte,
    and hydro dumps whose shared node plane is equal on both ranks."""
    from vpic_tpu_torch.io import readers

    first, second = tmp_path / "first", tmp_path / "second"
    assert _turb_cli(monkeypatch, first) == 0
    assert _turb_cli(monkeypatch, second, "--restart",
                     str(first / "restart1" / "restart")) == 0
    dumps = sorted(p.relative_to(first) for p in first.rglob("*")
                   if p.is_file() and (p.name.endswith((".4.0", ".4.1"))
                                       or p.parent.name == "T.4"))
    ranks = [p.name.rsplit(".", 1)[1] for p in dumps
             if p.parts[0] != "spectra"]
    assert ranks.count("0") == ranks.count("1") == 1 + 6 + 4 + 2
    assert len(dumps) == 2 * (1 + 6 + 4 + 2 + 8)
    for rel in dumps:
        assert (first / rel).read_bytes() == (second / rel).read_bytes(), rel
    for name in ("eT", "eB", "iT", "iB"):
        base = first / "hydro" / f"{name}hydro.4"
        (h0, lo), (_, hi) = (readers.read_hydro(f"{base}.{r}")
                             for r in range(2))
        nz = h0["nz"]
        for k, v in lo.items():
            np.testing.assert_array_equal(v[nz + 1, 1:, 1:], hi[k][1, 1:, 1:],
                                          err_msg=f"{name} {k}")


def test_dryrun_multichip_counterpart():
    """engine/distributed.dryrun_multichip: the 2D (y, x) layout for two
    whole super-cycles and the z-sharded 3D case, each held to its
    one-shard run."""
    out = tdist.dryrun_multichip(2, device="cpu", log=lambda m: None)
    assert set(out) == {"2d", "3d-z"}
    assert all(np.isfinite(v) for e in out.values() for v in e.values())


def test_compare_layouts_counterpart():
    """engine/distributed.compare_layouts, the check of shards spread
    over several devices against the same shards on one, at a small size
    on two CPU "devices": equal checksums and a time per window."""
    out = tdist.compare_layouts(["cpu", "cpu"], steps=2, windows=1,
                                log=lambda m: None, nx=8, ny=8, npart=512,
                                device="cpu")
    assert out["spread"]["sums"] == out["one device"]["sums"]
    assert out["spread"]["mesh"] == ["cpu"] * 4
    assert all(len(v["step_s"]) == 1 for v in out.values())


def test_time_phases_on_shards():
    sim = deck(port, px=2)
    t = sim.time_phases(1)
    assert {"advance_e", "synchronize_jf", "advance_p[electron]"} <= set(t)
    assert all(v >= 0 for v in t.values())


if __name__ == "__main__":
    # each case's largest distance from the JAX package, in the units of
    # the module's bars, on the conftest's 8-device CPU mesh:
    #   JAX_PLATFORMS=cpu python -c "import tests.conftest, runpy;
    #   runpy.run_module('tests.test_torch_shard', run_name='__main__')"
    from tests.test_torch_shard_cycled import cycled_runs
    from tests.test_torch_shard_equivalence import (bounded_runs,
                                                    eight_shard, two_shard)

    def fx(f):
        return f._get_wrapped_function()()

    two, eight = fx(two_shard), fx(eight_shard)
    cases = {"two shards, step 5": (two[5]["t"], two[5]["j"], 1),
             "two shards, step 20": (two[20]["t"], two[20]["j"], 1),
             "eight shards, step 3": (eight[3][1], eight[3][0], 1),
             "eight shards 3D, step 4": (eight[4][1], eight[4][0], 1)}
    for name, f, k in (("reflect/absorb", bounded_runs, 1),
                       ("cycled", cycled_runs, 2),
                       ("join_domain loops", joined_runs, 1),
                       ("absorb tally", tally_runs, 1),
                       ("load imbalance", skewed_runs, 1)):
        j, t, _ = fx(f)
        cases[name] = (t, j, k)
    for name, (t, j, k) in cases.items():
        w = check_against_jax(t, j, species=k)
        print(f"{name}: fields {w['fields']:.1f} ulps, particles "
              f"{w['particles']:.1f} ulps, energies {w['energy_rel']:.3e}")
