"""The collisions deck of the port (``vpic_tpu_torch/decks/collisions.py``)
against the JAX package's (``decks/collisions.py``): the pitch-angle
rotation fed the JAX hook's own draws, and the hook on one state and key
in both packages (to float32 roundoff: rtol 4e-6, atol 1e-6), |u| kept
per lane, isotropization by statistics
(tests/test_tracers_collisions.py:77), the deck's numpy load, and the
deck through the port's CLI.
"""

import dataclasses
import importlib
import math

import numpy as np
import torch

import jax
import jax.numpy as jnp

from vpic_tpu.core.types import SimState as JState, SpeciesState as JSpecies

from vpic_tpu_torch import Simulation
from vpic_tpu_torch.cli import run as cli
from vpic_tpu_torch.core import random as rnd
from vpic_tpu_torch.core.types import SimState, SpeciesState
from vpic_tpu_torch.decks import collisions

from tests import torch_decks  # noqa: F401  (one torch thread)

FLOATS = dict(rtol=4e-6, atol=1e-6)
NU_DT = 0.05


def test_rotation_matches_jax_with_its_draws():
    """The JAX hook on one species; rotate_momenta on the draws it made
    (its key split as the hook splits it) gives its momenta."""
    jdeck = importlib.import_module("decks.collisions")
    n = 3000
    rng = np.random.default_rng(2)
    u = rng.normal(0, 0.3, (3, n)).astype(np.float32)
    u[:, :5] = 0.0                      # |u| = 0 lanes stay as they are
    u[0, 5:10] = 0.95                   # along x: the other helper axis
    u[1:, 5:10] = 0.01
    sp = JSpecies.create("e", 0, -1.0, n).replace(
        np=jnp.int32(n - 100), ux=jnp.asarray(u[0]), uy=jnp.asarray(u[1]),
        uz=jnp.asarray(u[2]))
    key = jax.random.key(7)
    state = JState(field=None, interpolator=None, species=(sp,),
                   grid_arrays=None, materials=None, material_grid=None,
                   rng=key, step=jnp.int32(0))
    out = jdeck.make_pitch_angle_collisions(NU_DT)(state).species[0]
    _, sub = jax.random.split(key)
    k1, k2 = jax.random.split(jax.random.split(sub, 1)[0])
    theta = jnp.sqrt(jnp.float32(2.0 * NU_DT)) * jax.random.normal(
        k1, (n,), jnp.float32)
    phi = jax.random.uniform(k2, (n,), jnp.float32, 0.0, 2.0 * math.pi)
    t = [torch.as_tensor(a) for a in u]
    rot = collisions.rotate_momenta(*t, torch.as_tensor(np.array(theta)),
                                    torch.as_tensor(np.array(phi)))
    keep = (np.arange(n) < n - 100) & ((u * u).sum(0) > 0)
    for k, c in enumerate(("ux", "uy", "uz")):
        mine = np.where(keep, rot[k].numpy(), u[k])
        np.testing.assert_allclose(mine, np.asarray(getattr(out, c)),
                                   err_msg=c, **FLOATS)


def test_hook_matches_jax_value_for_value():
    """Both hooks on one state of two species and one key: the port splits
    and draws as the JAX hook does, so every momentum agrees to float32
    roundoff and the new keys are equal."""
    jdeck = importlib.import_module("decks.collisions")
    n = 3000
    rng = np.random.default_rng(3)
    u = rng.normal(0, 0.3, (2, 3, n)).astype(np.float32)
    key = jax.random.key(123457)
    jspecies = tuple(JSpecies.create(f"s{k}", k, -1.0, n).replace(
        np=jnp.int32(n - 50 * k), ux=jnp.asarray(u[k, 0]),
        uy=jnp.asarray(u[k, 1]), uz=jnp.asarray(u[k, 2])) for k in (0, 1))
    jout = jdeck.make_pitch_angle_collisions(NU_DT)(JState(
        field=None, interpolator=None, species=jspecies, grid_arrays=None,
        materials=None, material_grid=None, rng=key, step=jnp.int32(0)))
    tspecies = tuple(SpeciesState.create(f"s{k}", k, -1.0, n).replace(
        np=torch.tensor(n - 50 * k, dtype=torch.int32),
        ux=torch.as_tensor(u[k, 0]), uy=torch.as_tensor(u[k, 1]),
        uz=torch.as_tensor(u[k, 2])) for k in (0, 1))
    tstate = SimState(field=None, interpolator=None, species=tspecies,
                      grid_arrays=None, materials=None,
                      step=torch.tensor(0), rng=rnd.make_key(123457))
    tout = collisions.make_pitch_angle_collisions(NU_DT)(tstate)
    for k in (0, 1):
        for c in ("ux", "uy", "uz"):
            np.testing.assert_allclose(
                getattr(tout.species[k], c).numpy(),
                np.asarray(getattr(jout.species[k], c)), err_msg=c,
                **FLOATS)
    np.testing.assert_array_equal(tout.rng.numpy(),
                                  np.asarray(jax.random.key_data(jout.rng)))


def small_deck(monkeypatch, nx=8, ppc=4):
    monkeypatch.setenv("COLL_NX", str(nx))
    monkeypatch.setenv("COLL_PPC", str(ppc))
    return collisions.deck(device="cpu")


def test_deck_loads_the_numpy_stream(monkeypatch):
    """The deck's particles are the JAX deck's numpy draws (seed 11):
    positions placed in their cells, charges -1/n."""
    sim = small_deck(monkeypatch)
    n = 8 * 8 * 4
    rng = np.random.default_rng(11)
    x, y = rng.uniform(0, 1, n), rng.uniform(0, 1, n)
    sp = sim.state.species[0]
    assert int(sp.np) == n
    g = sim.grid
    i = sp.i.numpy()[:n]
    xs = (i % g.nxg - 1 + (sp.dx.numpy()[:n] + 1) / 2) * g.dx
    ys = (i // g.nxg % g.nyg - 1 + (sp.dy.numpy()[:n] + 1) / 2) * g.dy
    np.testing.assert_allclose(xs, x, rtol=0, atol=1e-6)
    np.testing.assert_allclose(ys, y, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(sp.q.numpy()[:n], np.float32(-1.0 / n))


def test_hook_keeps_each_speed_and_isotropizes():
    """tests/test_tracers_collisions.py:77 on the port: 4000 nearly
    field-free electrons, anisotropy 16 falls below half in 40 steps, the
    kinetic energy sum |u|^2 is kept to 1e-3; one hook call keeps every
    lane's |u| to float32 roundoff."""
    n, nx, L = 4000, 8, 1.0
    sim = Simulation(seed=11, device="cpu")
    sim.define_units(1.0, 1.0)
    sim.define_timestep(0.9 * sim.courant_length(L, L, L, nx, nx, 1))
    sim.define_periodic_grid(0, 0, 0, L, L, L, nx, nx, 1)
    e = sim.define_species("electron", -1.0, 2 * n)
    sim.inject_particle(
        e, sim.uniform(n, 0, L), sim.uniform(n, 0, L), sim.uniform(n, 0, L),
        sim.maxwellian(n, 0.2), sim.maxwellian(n, 0.05),
        sim.maxwellian(n, 0.05), q=-1e-6 / n)
    hook = collisions.make_pitch_angle_collisions(NU_DT)
    sim.finalize(user_particle_collisions=hook)

    def speed2(state):
        sp = state.species[0]
        return (sp.ux.double() ** 2 + sp.uy.double() ** 2
                + sp.uz.double() ** 2)[sp.alive].numpy()

    once = hook(sim.state)
    # the hook takes one split of the state's key, as the JAX hook does
    assert torch.equal(once.rng, rnd.split(sim.state.rng)[0])
    np.testing.assert_allclose(np.sqrt(speed2(once)),
                               np.sqrt(speed2(sim.state)), rtol=2e-6)
    a0, k0 = collisions.anisotropy(sim), speed2(sim.state).sum()
    assert a0 > 5.0
    sim.advance(40)
    a1, k1 = collisions.anisotropy(sim), speed2(sim.state).sum()
    assert a1 < 0.5 * a0
    assert abs(k1 - k0) / k0 < 1e-3


def test_collisions_deck_through_the_cli(monkeypatch, tmp_path):
    """``python -m vpic_tpu_torch.cli.run vpic_tpu_torch/decks/
    collisions.py --num-step 50`` at 8x8 and 4 per cell, on the CPU, with
    a checkpoint at step 25: a second run restarted from it ends in the
    same state bit for bit."""
    monkeypatch.setenv("COLL_NX", "8")
    monkeypatch.setenv("COLL_PPC", "4")
    deck = str(collisions.__file__)
    ck = tmp_path / "ck"
    args = [deck, "--device", "cpu", "--num-step", "50",
            "--status-interval", "25", "--checkpoint-dir", str(ck),
            "--checkpoint-interval", "25"]
    states = []
    real = cli.load_deck

    def keep(path):
        mod = real(path)
        build = mod.deck

        def deck_kept(device):
            sim = build(device=device)
            states.append(sim)
            return sim
        mod.deck = deck_kept
        return mod

    monkeypatch.setattr(cli, "load_deck", keep)
    assert cli.main(args) == 0
    assert cli.main(args[:-4] + ["--restart", str(ck / "restart1" /
                                                  "restart")]) == 0
    first, second = states
    assert first.step_count == second.step_count == 50
    for a, b in zip(dataclasses.astuple(first.state.species[0])[5:],
                    dataclasses.astuple(second.state.species[0])[5:]):
        assert torch.equal(a, b)
    assert torch.equal(first.state.rng, second.state.rng)
    assert first.mover_counts() == {"electron": 0}
