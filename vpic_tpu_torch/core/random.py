"""The random state of the simulation and the draws made from it.

The JAX package carries a ``jax.random`` key (threefry) in its state and
splits it for each consumer.  The port cannot reproduce that stream; it
carries its own random state instead: ``SimState.rng``, an int64 tensor
``[stream, counter]`` kept on the host (a CPU tensor, whatever the
state's device), so that deriving a key never reads the card.

- :func:`split` returns the state's next random state (counter + 1) and a
  key (a Python int) for one consumer; :func:`fold` derives the key of a
  site (a round, a species, a handler) from a key.
- :func:`uniform` and :func:`normal` draw ``(n,)`` float32 values on a
  device from a ``torch.Generator`` seeded with the key: one kernel per
  draw on the card, and the same numbers for the same key on the same
  kind of device.

A state restored from a checkpoint holds the same ``rng`` and so draws
the same numbers; the streams of the CPU and of the card differ.
"""

from __future__ import annotations

import torch

M32 = 0xFFFFFFFF


def _mix(x: int) -> int:
    """A 32-bit integer hash (xor-shift and multiply rounds)."""
    x &= M32
    x ^= x >> 16
    x = (x * 0x7FEB352D) & M32
    x ^= x >> 15
    x = (x * 0x846CA68B) & M32
    return x ^ (x >> 16)


def make_key(seed: int) -> torch.Tensor:
    """The random state of a simulation built with ``seed``."""
    s = int(seed) & 0xFFFFFFFFFFFFFFFF
    return torch.tensor([_mix(s ^ _mix(s >> 32)), 0], dtype=torch.int64)


def split(rng: torch.Tensor):
    """(the next random state, a key for one consumer)."""
    if rng is None:
        raise ValueError("the state has no random state (rng is None), as "
                         "one loaded from the JAX package has: give "
                         "interop.state_from_numpy an rng (make_key(seed))")
    stream, counter = (int(v) for v in rng.tolist())
    return (torch.tensor([stream, counter + 1], dtype=torch.int64),
            _mix(stream ^ _mix(counter)) | (_mix(counter >> 32) << 32))


def fold(key: int, site: int) -> int:
    """The key of ``site`` (a small non-negative int) under ``key``."""
    return _mix(key ^ _mix(site + 0x9E3779B1)) | (
        _mix((key >> 32) ^ site) << 32)


def _generator(key: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(key)


def uniform(key: int, n: int, lo: float = 0.0, hi: float = 1.0,
            device="cpu") -> torch.Tensor:
    """(n,) float32 uniform in [lo, hi): ``lo + u * (hi - lo)``."""
    u = torch.rand(n, generator=_generator(key, device), device=device)
    return lo + u * float(hi - lo)


def normal(key: int, n: int, device="cpu") -> torch.Tensor:
    """(n,) float32 standard normal."""
    return torch.randn(n, generator=_generator(key, device), device=device)
