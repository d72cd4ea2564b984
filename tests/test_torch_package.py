"""Package-level contracts of the port: it imports without JAX, it never
falls back from CUDA to the CPU, the kernel wrapper takes the plain path
only for CPU tensors, the interop round trip is lossless, and the sort
cadence and unported configurations behave as documented."""

import dataclasses
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import __graft_entry__ as ge

import vpic_tpu_torch
from vpic_tpu_torch.comm.facecomm import LocalComm
from vpic_tpu_torch.core.types import Grid, NEIGHBOR_ABSORB
from vpic_tpu_torch.decks import bench_deck
from vpic_tpu_torch.core.types import PackedSpecies, SpeciesState
from vpic_tpu_torch.engine.step import (StepOptions, make_advance,
                                        resolve_paths, sort_flags,
                                        step_sort_flags)
from vpic_tpu_torch.interop import state_from_numpy, state_to_numpy
from vpic_tpu_torch.particles import push, push_cuda

from tests import torch_decks  # noqa: F401  (one torch thread)

ROOT = Path(__file__).resolve().parents[1]


def test_imports_without_jax():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['vpic_tpu'] = None\n"
        "import pkgutil, importlib, vpic_tpu_torch\n"
        "for m in pkgutil.walk_packages(vpic_tpu_torch.__path__,\n"
        "                               'vpic_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "assert not any(k.split('.')[0] in ('jax', 'jaxlib', 'vpic_tpu')\n"
        "               and sys.modules[k] is not None for k in sys.modules)\n"
        "print('ok')\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "ok"


def test_no_module_imports_jax_even_in_a_function():
    """No statement of the port (nor of chip_smoke.py), at any depth,
    imports jax, jaxlib or the JAX package: a lazy import inside a
    function escapes the import test above."""
    import ast
    files = sorted((ROOT / "vpic_tpu_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py"]
    bad = []
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom)
                     and node.level == 0 else [])
            bad += [f"{path.relative_to(ROOT)}:{node.lineno} {n}"
                    for n in names
                    if n.split(".")[0] in ("jax", "jaxlib", "vpic_tpu")]
    assert len(files) > 40
    assert not bad, bad


def test_cuda_simulation_raises_without_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        vpic_tpu_torch.Simulation(seed=0, device="cuda")


@pytest.mark.parametrize("entry", [
    "Simulation", "bench_deck.build", "tools.probe_batched.main",
    "tools.vpu_layout_probe.main", "tools.drift_compare.main",
    "tools.drift_compare.compare", "tools.evidence.main",
    "tools.scaling_bench.main", "tools.scaling_bench.sweep",
    "tools.profile_step.main", "entry.entry"])
def test_the_card_is_the_default_device(monkeypatch, entry):
    """Without ``device`` the entry points run on the card, so they raise
    where there is none."""
    from vpic_tpu_torch import entry as tentry
    from vpic_tpu_torch.tools import (drift_compare, evidence, probe_batched,
                                      profile_step, scaling_bench,
                                      vpu_layout_probe)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = {
        "Simulation": lambda: vpic_tpu_torch.Simulation(),
        "bench_deck.build": lambda: bench_deck.build(nx=4, ny=4, nz=1,
                                                     npart=256),
        "tools.probe_batched.main": lambda: probe_batched.main([]),
        "tools.vpu_layout_probe.main": lambda: vpu_layout_probe.main([]),
        "tools.drift_compare.main": lambda: drift_compare.main([]),
        "tools.drift_compare.compare": lambda: drift_compare.compare(),
        "tools.evidence.main": lambda: evidence.main([]),
        "tools.scaling_bench.main": lambda: scaling_bench.main([]),
        "tools.scaling_bench.sweep": lambda: next(scaling_bench.sweep(
            [(256, 4, 4, 1)])),
        "tools.profile_step.main": lambda: profile_step.main([]),
        "entry.entry": lambda: tentry.entry()}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[entry]()


def _small_push_args(device="cpu"):
    sim = bench_deck.build(nx=4, ny=4, nz=1, npart=256, device="cpu")
    st = sim.state
    sp = st.species[0]
    if device != "cpu":
        sp = dataclasses.replace(sp, **{
            k: getattr(sp, k).to(device) for k in ("dx", "dy", "dz", "i",
                                                  "ux", "uy", "uz", "q",
                                                  "np")})
    return (sp, st.interpolator, torch.zeros((sim.grid.nv, 12)),
            st.grid_arrays.neighbor, sim.grid)


def test_wrapper_takes_plain_path_for_cpu_tensors(monkeypatch):
    calls = []
    real = push.advance_p

    def recording(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    def no_build():
        raise AssertionError("the CPU path must not build the kernel")

    monkeypatch.setattr(push, "advance_p", recording)
    monkeypatch.setattr(push_cuda, "build", no_build)
    before = dict(push_cuda.launches)
    sp, acc = push_cuda.advance_p(*_small_push_args(), n_walk=3)
    assert calls == [1]
    assert push_cuda.launches == before       # no kernel launch counted
    assert sp.dx.device.type == "cpu" and acc.shape[1] == 12


def test_wrapper_rejects_non_cuda_devices(monkeypatch):
    """A tensor on neither the CPU nor a CUDA card is refused; the plain
    version is never taken for it."""
    monkeypatch.setattr(push, "advance_p", None)
    args = _small_push_args(device="meta")
    with pytest.raises(ValueError, match="CUDA tensors"):
        push_cuda.advance_p(*args)


def test_interop_round_trip_is_lossless():
    jsim = ge._build(nx=4, ny=4, nz=1, npart=512)
    d = state_to_numpy(jsim.state)
    back = state_to_numpy(state_from_numpy(d))
    assert sorted(back) == sorted(d)
    for k, v in d.items():
        assert np.asarray(back[k]).dtype == np.asarray(v).dtype, k
        np.testing.assert_array_equal(back[k], v, err_msg=k)


def test_sort_cadence():
    """resort every 2 steps, ions every 8 (the bench deck's cadence)."""
    opts = StepOptions(resort_interval=2)
    flags = [sort_flags(s, opts, (0, 8)) for s in range(16)]
    assert [s for s, f in enumerate(flags) if f[0]] == list(range(0, 16, 2))
    assert [s for s, f in enumerate(flags) if f[1]] == [0, 8]
    assert sort_flags(3, StepOptions(resort_interval=1), (0, 8)) == (True,
                                                                     True)


def test_unported_configurations_raise():
    """Absorbing faces, the deck hooks and migration between shards are
    ported (the boundary rounds); the packed cycle refuses them, as the
    JAX package's does, and an unknown hook name raises.  A sharded grid
    takes a ShardComm per shard, and its cells must split evenly."""
    g = Grid(nx=4, ny=4, nz=1, pbc=(NEIGHBOR_ABSORB,) * 6)
    make_advance(g, LocalComm(g))
    make_advance(g, LocalComm(g), pcomm=LocalComm(g))
    with pytest.raises(ValueError, match="closed configuration"):
        make_advance(g, LocalComm(g), pcomm=LocalComm(g), packed=True)
    with pytest.raises(ValueError, match="closed configuration"):
        make_advance(g, LocalComm(g), packed=True)
    g = Grid(nx=4, ny=4, nz=1)
    make_advance(g, LocalComm(g), user_particle_injection=lambda s: s)
    with pytest.raises(ValueError, match="closed configuration"):
        make_advance(g, LocalComm(g), packed=True,
                     user_particle_collisions=lambda s: s)
    with pytest.raises(TypeError, match="unknown deck hooks"):
        make_advance(g, LocalComm(g), user_particle_push=print)
    sim = vpic_tpu_torch.Simulation(device="cpu")
    assert sim.define_absorbing_grid(0, 0, 0, 1, 1, 1, 8, 8, 1,
                                     px=2).gpx == 2
    with pytest.raises(ValueError, match="equal shards"):
        sim.define_absorbing_grid(0, 0, 0, 1, 1, 1, 8, 8, 1, px=3)
    with pytest.raises(ValueError, match="ShardComm"):
        LocalComm(Grid(nx=4, ny=4, nz=1, gpx=2))


def test_path_switches_resolve_as_the_jax_package():
    """fused_push None -> on; sorted_deposit None -> nv <= 120_000; fused
    forces sorted_deposit; merge_sort None -> off (step.py:152-170)."""
    small, big = Grid(nx=128, ny=128, nz=1), Grid(nx=400, ny=400, nz=1)
    assert resolve_paths(small, StepOptions()) == (True, True, False)
    assert resolve_paths(big, StepOptions()) == (True, True, False)
    unfused = StepOptions(fused_push=False, resort_interval=2)
    assert resolve_paths(small, unfused) == (False, True, False)
    assert resolve_paths(big, unfused) == (False, False, False)
    # unfused: every species every step with the sorted deposit, else the
    # species' own sort_interval
    assert step_sort_flags(3, small, unfused, (0, 8)) == (True, True)
    assert step_sort_flags(8, big, unfused, (0, 8)) == (False, True)
    assert step_sort_flags(4, big, unfused, (0, 8)) == (False, False)
    with pytest.raises(ValueError, match="fused push"):
        make_advance(small, LocalComm(small), unfused, packed=True)


def test_modify_runparams_switches_paths():
    """merge_sort=True runs the packed cycle (the state is unpacked when
    read); switching back unpacks it for good; unknown keys raise."""
    sim = bench_deck.build(nx=4, ny=4, nz=1, npart=256, device="cpu")
    with pytest.raises(ValueError, match="unknown run parameters"):
        sim.modify_runparams(no_such_option=1)
    sim.modify_runparams(merge_sort=True)
    sim.advance(2)
    assert all(isinstance(sp, PackedSpecies)
               for sp in sim._pstate.species)
    assert all(isinstance(sp, SpeciesState) for sp in sim.state.species)
    assert sim._pstate is not None
    sim.modify_runparams(merge_sort=False, fused_push=False)
    assert sim._pstate is None and sim._advance_packed is None
    sim.advance(2)
    assert sim.mover_counts() == {"electron": 0, "ion": 0}
    assert all(int(sp.np) == 256 for sp in sim.state.species)


def test_chip_smoke_fails_without_the_package(tmp_path):
    """chip_smoke.py alone in a directory exits non-zero and prints no
    result line."""
    shutil.copy(ROOT / "chip_smoke.py", tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
