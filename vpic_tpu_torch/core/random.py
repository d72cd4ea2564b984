"""The random state of the simulation and the draws made from it: the JAX
package's ``jax.random`` stream (threefry2x32, with
``jax_threefry_partitionable`` on), reproduced on the device.

``SimState.rng`` is the data of the JAX package's key, the two uint32
words of ``jax.random.key_data(key)``, held as a ``(2,)`` int64 tensor
with values in [0, 2^32) on the state's device.  Every function here
derives on the key's device and reads nothing back to the host, so a draw
is a graph-safe device operation: a CUDA graph that captures it reads the
key from the key's buffer at every replay.

- :func:`make_key` is ``key_data(jax.random.key(seed))``; :func:`split`
  is ``jax.random.split`` (``prng._threefry_split_foldlike``);
  :func:`bits` is ``prng._threefry_random_bits_partitionable`` for 32-bit
  words (a key on the CPU only: no draw site takes raw bits);
  :func:`uniform` and :func:`normal` are ``jax.random.uniform``
  and ``jax.random.normal`` in float32 (``jax/_src/random.py``'s
  ``_uniform`` and ``_normal_real``).
- For a key on the CPU each function computes with its plain torch twin
  (``plain_split``, ``plain_bits``, ``plain_uniform``, ``plain_normal``:
  int64 words masked to 32 bits after each add and shift, each float32
  operation rounded on its own but for the multiply-adds that XLA
  contracts, :func:`fma`).  For a key on the card it launches the
  hand-written kernel of ``csrc/threefry.cu`` (``core/random_cuda.py``),
  which computes the same thing.  The twins run on any device, so a
  check can hold the kernel to them on the card too.

Splits, bits and uniforms are bitwise those of ``jax.random``, on the CPU
and (splits, uniforms) on the card.  One exception, with odds 2^-23 per draw: where the
uniform's 23 random bits are all 0 and ``lo`` is a subnormal float32
(the reflux handler's ``lo = 1e-38``), XLA on the CPU flushes ``lo`` to 0
and the port keeps it.  The normal's ``erf_inv`` is XLA's float32
expansion (Giles' two polynomials over ``w = -log1p(-x^2)``); ``log1p``
is the platform's, so a normal is within a few ulps of
``jax.random.normal`` (the tests state the bound).
"""

from __future__ import annotations

import math

import numpy as np
import torch

M32 = 0xFFFFFFFF
_KS_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
# jax/_src/random.py:_normal_real draws uniform(nextafter(-1, 0), 1)
NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
SQRT2 = float(np.float32(np.sqrt(2.0)))
# XLA's ErfInv32 (Giles, "Approximating the erfinv function"): the
# coefficients for w < 5 and for w >= 5, highest degree first
ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
              -4.39150654e-06, 0.00021858087, -0.00125372503,
              -0.00417768164, 0.246640727, 1.50140941)
ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
              -0.00367342844, 0.00573950773, -0.0076224613,
              0.00943887047, 1.00167406, 2.83297682)
MAX_DRAW = 2 ** 32 - 1   # the counters' high word stays 0 below 2^32


def make_key(seed, device="cpu") -> torch.Tensor:
    """``jax.random.key_data(jax.random.key(seed))`` as a (2,) int64
    tensor on ``device``, as the JAX package makes it: its import turns on
    ``jax_enable_x64`` (``vpic_tpu/__init__.py``), so a seed is a 64-bit
    integer split into its high and low words, ``[seed >> 32, seed mod
    2^32]`` of its two's complement (a Python int outside [-2^63, 2^63)
    raises).  Without 64-bit types JAX keeps only the low word; the two
    agree on seeds in [0, 2^32)."""
    if isinstance(seed, (bool, float)) or not isinstance(
            seed, (int, np.integer)):
        raise TypeError(f"PRNG key seed must be an integer; got {seed!r}")
    if isinstance(seed, int) and not -2 ** 63 <= seed < 2 ** 63:
        raise OverflowError("Python int too large to convert to C long")
    s = int(seed) & 0xFFFFFFFFFFFFFFFF
    return torch.tensor([s >> 32, s & M32], dtype=torch.int64,
                        device=device)


def threefry2x32(k1, k2, x1, x2):
    """The plain threefry2x32 hash (``jax/_src/prng.py``'s
    ``_threefry2x32_lowering``): 20 rounds, the key injected every 4.
    Every argument is an int64 tensor (or int) of uint32 values; returns
    the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ _KS_PARITY)
    x1 = (x1 + ks[0]) & M32
    x2 = (x2 + ks[1]) & M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & M32
            x2 = ((x2 << r) & M32) | (x2 >> (32 - r))
            x2 = x1 ^ x2
        x1 = (x1 + ks[(i + 1) % 3]) & M32
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & M32
    return x1, x2


def _check(key: torch.Tensor, n: int) -> int:
    if key is None:
        raise ValueError("the state has no random state (rng is None): give "
                         "interop.state_from_numpy the JAX key's data or an "
                         "rng (make_key(seed))")
    if tuple(key.shape) != (2,) or key.dtype != torch.int64:
        raise ValueError(f"a key is a (2,) int64 tensor, got "
                         f"{tuple(key.shape)} {key.dtype}")
    n = int(n)
    if not 0 <= n <= MAX_DRAW:
        raise ValueError(f"a draw takes 0 <= n < 2^32 values, got {n}")
    return n


def _hash(key: torch.Tensor, n: int):
    """The twin's threefry of counters 0..n-1 (high word 0) under ``key``."""
    i = torch.arange(n, dtype=torch.int64, device=key.device)
    return threefry2x32(key[0], key[1], torch.zeros_like(i), i)


def _cuda():
    from . import random_cuda
    return random_cuda


def plain_split(key: torch.Tensor, n: int) -> torch.Tensor:
    b1, b2 = _hash(key, n)
    return torch.stack([b1, b2], dim=1)


def plain_bits(key: torch.Tensor, n: int) -> torch.Tensor:
    b1, b2 = _hash(key, n)
    return b1 ^ b2


def split(key: torch.Tensor, n: int = 2) -> torch.Tensor:
    """``jax.random.split(key, n)``: an (n, 2) int64 tensor of keys on
    the key's device; ``rng, sub = split(key)`` unpacks two."""
    n = _check(key, n)
    if key.device.type != "cpu":
        return _cuda().split(key, n)
    return plain_split(key, n)


def bits(key: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.bits(key, (n,), uint32)``: (n,) int64 of uint32
    values, for a key on the CPU (no draw site takes raw bits: the card's
    kernel gives splits, uniforms and normals)."""
    n = _check(key, n)
    if key.device.type != "cpu":
        raise ValueError("bits are drawn on the CPU only: the threefry "
                         "kernel gives split, uniform and normal")
    return plain_bits(key, n)


def _f32(v: float) -> float:
    return float(np.float32(v))


def fma(a, b, c) -> torch.Tensor:
    """float32 ``a * b + c`` rounded once, as XLA contracts it on the CPU
    (and ``__fmaf_rn`` computes it on the card): the product of two
    float32 values is exact in float64, and so is the sum where the
    addend is within 2^7 of the product's scale, as it is at every use
    here; the float64 result then rounds to float32 once."""
    a = torch.as_tensor(a, dtype=torch.float32)
    return (a.double() * torch.as_tensor(b, dtype=torch.float64)
            + torch.as_tensor(c, dtype=torch.float64)).float()


def plain_uniform(key: torch.Tensor, n: int, lo: float = 0.0,
                  hi: float = 1.0) -> torch.Tensor:
    """``_uniform``'s float32 arithmetic on the 32-bit words: the top 23
    bits as the mantissa of a float in [1, 2), minus 1, times ``hi - lo``
    plus ``lo`` (one rounding), at least ``lo``."""
    lo32, hi32 = _f32(lo), _f32(hi)
    span = _f32(np.float32(hi32) - np.float32(lo32))
    b = plain_bits(key, n)
    f = ((b >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    return torch.clamp_min(fma(f, span, lo32), lo32)


def uniform(key: torch.Tensor, n: int, lo: float = 0.0,
            hi: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform(key, (n,), float32, lo, hi)``: (n,) float32
    in [lo, hi) on the key's device."""
    n = _check(key, n)
    if key.device.type != "cpu":
        return _cuda().uniform(key, n, _f32(lo), _f32(hi))
    return plain_uniform(key, n, lo, hi)


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ``erf_inv``: ``p(w) * x`` with ``w = -log1p(-x*x)``,
    ``p`` one of two degree-8 polynomials in ``w - 2.5`` (w < 5) or
    ``sqrt(w) - 3``, evaluated by Horner's rule with each step one fused
    multiply-add, as XLA contracts it; +-inf at |x| = 1."""
    w = -torch.log1p(-(x * x))
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)
    coef = lambda i: torch.where(lt, _f32(ERFINV_LT5[i]),
                                 _f32(ERFINV_GE5[i])).to(torch.float32)
    p = coef(0)
    for i in range(1, 9):
        p = fma(p, w, coef(i))
    return torch.where(x.abs() == 1.0, x * math.inf, p * x)


def normal(key: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.normal(key, (n,), float32)``: ``sqrt(2) *
    erf_inv(uniform(key, n, nextafter(-1, 0), 1))`` on the key's device."""
    n = _check(key, n)
    if key.device.type != "cpu":
        return _cuda().normal(key, n)
    return plain_normal(key, n)


def plain_normal(key: torch.Tensor, n: int) -> torch.Tensor:
    return SQRT2 * erf_inv(plain_uniform(key, n, NORMAL_LO, 1.0))
