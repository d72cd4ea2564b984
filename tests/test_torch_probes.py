"""The probe kernels' plain versions (``vpic_tpu_torch/tools/``) against
the JAX tools they replace, on the CPU.

- The five probes of ``tools/probe_batched.py``, each built as the tool
  builds it and run under ``pltpu.force_tpu_interpret_mode()``, against
  the port's plain version on the port's copy of the tool's inputs:
  bitwise.
- The plain gather3d and deposit2d on random, not one-hot, operands at
  the tool's shapes and at a second shape, against a float64 contraction
  of the bf16-rounded operands: within K * 2^-24 * sum|terms| per output,
  K the contraction depth (the worst case of a float32 sum in any order).
- The elementwise chain of ``tools/vpu_layout_probe.py`` at 1 and 16
  reps (``REPS_IN_KERNEL`` set on the tool's module), rows 1, 3 and 8 of
  a (max(rows, 8), 256) block drawn uniform on [0, 3).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

import tools.probe_batched as jax_probes
import tools.vpu_layout_probe as jax_vpu
from vpic_tpu_torch.tools import probe_batched as pb
from vpic_tpu_torch.tools import vpu_layout_probe as vp

from tests import torch_decks  # noqa: F401  (one torch thread)


def bits(a):
    return np.asarray(a, np.float32).view(np.int32)


@pytest.mark.parametrize("name", list(pb.PROBES))
def test_probe_matches_the_jax_tool_bitwise(name):
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jax_probes.PROBES[name]())
    got = pb.PROBES[name](*pb.tool_inputs(name, "cpu")).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_array_equal(bits(got), bits(want))


def test_tool_inputs_are_the_tools():
    """The one-hot window and lane positions as the tool builds them."""
    oh = pb.one_hot_window("cpu").numpy()
    want = (jnp.arange(jax_probes.W)[None, :, None]
            == jnp.arange(jax_probes.LANE)[None, None, :]
            + jnp.arange(jax_probes.R)[:, None, None]).astype(jnp.float32)
    np.testing.assert_array_equal(oh, np.asarray(want))
    loc = jnp.tile(jnp.arange(jax_probes.LANE, dtype=jnp.int32)[None, :],
                   (jax_probes.R, 1))
    np.testing.assert_array_equal(pb.tool_loc("cpu").numpy(),
                                  np.asarray(loc))


def _bf16_64(t):
    return t.to(torch.bfloat16).to(torch.float64).numpy()


CONTRACTIONS = {
    # name: (a shape, oh shape), the second a smaller, ragged shape
    "gather3d": [((32, 512), (8, 512, 128)), ((5, 48), (3, 48, 32))],
    "deposit2d": [((12, 8, 128), (8, 512, 128)), ((7, 3, 32), (3, 40, 32))],
}


@pytest.mark.parametrize("case", [0, 1], ids=["tool-shape", "second-shape"])
@pytest.mark.parametrize("name", list(CONTRACTIONS))
def test_contraction_within_the_float32_sum_bound(name, case):
    a_shape, oh_shape = CONTRACTIONS[name][case]
    rng = np.random.default_rng(10 + case)
    a = torch.as_tensor(rng.normal(size=a_shape).astype(np.float32))
    oh = torch.as_tensor(rng.normal(size=oh_shape).astype(np.float32))
    got = pb.PROBES[name](a, oh).numpy().astype(np.float64)
    a64, oh64 = _bf16_64(a), _bf16_64(oh)
    if name == "gather3d":
        exact = np.einsum("aw,rwl->arl", a64, oh64)
        mag = np.einsum("aw,rwl->arl", np.abs(a64), np.abs(oh64))
        depth = a_shape[1]
    else:
        exact = np.einsum("krl,rwl->kw", a64, oh64)
        mag = np.einsum("krl,rwl->kw", np.abs(a64), np.abs(oh64))
        depth = a_shape[1] * a_shape[2]
    assert got.shape == exact.shape
    err = np.abs(got - exact)
    assert (err <= depth * 2.0 ** -24 * mag).all(), float(
        (err / (mag * 2.0 ** -24)).max())
    assert err.max() > 0        # the operands are not one-hot


def test_stack8_masks_lanes_outside_the_window():
    win = torch.as_tensor(np.random.default_rng(3).normal(
        size=(4, 16)).astype(np.float32))
    loc = torch.tensor([[0, 15, 16, -1], [3, 3, 7, 100]], dtype=torch.int32)
    out = pb.stack8(win, loc).numpy()
    want = np.zeros((4, 2, 4), np.float32)
    for s in range(2):
        for l in range(4):
            w = int(loc[s, l])
            if 0 <= w < 16:
                want[:, s, l] = win[:, w].to(torch.bfloat16).float().numpy()
    np.testing.assert_array_equal(bits(out), bits(want))


C, ONE, TWO = np.float32(1.0000001), np.float32(1.0), np.float32(2.0)


def numpy_chain(a, reps):
    """IEEE float32, each operation rounded on its own."""
    for _ in range(reps):
        a = a * C
        a = a + ONE
        a = np.where(a > TWO, a - ONE, a)
    return a


def numpy_xla_chain(a, reps):
    """XLA's rewrite on the CPU: the taken branch is fl(a*c), not
    fl(fl(a*c) + 1) - 1."""
    for _ in range(reps):
        p = a * C
        t = p + ONE
        a = np.where(t > TWO, p, t)
    return a


def jax_chain(x, rows):
    """The tool's pallas_call (tools/vpu_layout_probe.py:36-42), built and
    run inside the interpret-mode context."""
    n = x.shape[1]
    with pltpu.force_tpu_interpret_mode():
        f = pl.pallas_call(
            functools.partial(jax_vpu._kernel, rows=rows, n=n),
            out_shape=jax.ShapeDtypeStruct(x.shape, jnp.float32),
            in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)],
            out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        )
        return np.asarray(jax.jit(f)(jnp.asarray(x)))


@pytest.mark.parametrize("rows", [1, 3, 8])
@pytest.mark.parametrize("reps", [1, 16])
def test_vpu_chain_against_the_jax_tool(monkeypatch, reps, rows):
    """The port's plain chain is bitwise the IEEE float32 chain done step
    by step, its rows past ``rows`` zeros; the JAX kernel is bitwise XLA's
    rewrite of it (the taken branch fl(a*c)), so the two differ.  Rows
    ``rows..7`` of the JAX output are never written and are not compared.
    Port against JAX: within reps * 2^-23, the largest difference measured
    (1.19e-7 at 1 rep, 1.91e-6 at 16 reps, on these inputs): one float32
    ulp of [1, 2) per rep where the rewrite skips a rounding."""
    monkeypatch.setattr(jax_vpu, "REPS_IN_KERNEL", reps)
    n = 256
    x = np.random.default_rng(rows).uniform(
        0, 3, size=(max(rows, 8), n)).astype(np.float32)
    port = vp.chain(torch.from_numpy(x), rows, reps).numpy()
    assert port.shape == x.shape
    np.testing.assert_array_equal(bits(port[:rows]),
                                  bits(numpy_chain(x[:rows], reps)))
    assert not port[rows:].any()
    got = jax_chain(x, rows)[:rows]
    np.testing.assert_array_equal(bits(got),
                                  bits(numpy_xla_chain(x[:rows], reps)))
    np.testing.assert_allclose(port[:rows], got, rtol=0,
                               atol=reps * 2.0 ** -23)



@pytest.mark.parametrize("name", list(pb.PROBES) + ["vpu_chain"])
def test_wrappers_refuse_tensors_off_cpu_and_card(name, monkeypatch):
    """A tensor on neither the CPU nor a card is refused before anything
    is built; the plain version is never taken for it."""
    from vpic_tpu_torch.particles import push_cuda

    def no_build():
        raise AssertionError("nothing may be built for a refused tensor")

    monkeypatch.setattr(push_cuda, "build", no_build)
    if name == "vpu_chain":
        call = lambda: vp.chain(torch.empty((8, 128), device="meta"), 1)
    else:
        args = [a.to("meta") for a in pb.tool_inputs(name, "cpu")]
        call = lambda: pb.PROBES[name](*args)
    with pytest.raises(ValueError, match="CUDA tensors"):
        call()
