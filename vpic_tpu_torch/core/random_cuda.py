"""The hand-written CUDA threefry kernel (``csrc/threefry.cu``) and its
wrappers: the card's half of ``core/random.py``.

:func:`split`, :func:`uniform` and :func:`normal` take a
(2,) int64 key on the card and give what ``core/random.py``'s plain
versions give for a key on the CPU.  The kernel is built with the
package's other kernels (``particles/push_cuda.build``); a build or launch
failure raises, and a key on the CPU is refused here (``core/random.py``
takes it to the plain version).  The kernel reads the key from its buffer
on the card, so a CUDA graph that captures a call draws from the key the
buffer holds at each replay.

``launches`` counts the kernel's launches by output (a call with n = 0
launches nothing and counts nothing).  The binding and the count are made
under ``push_cuda._lock`` (shards call from their own threads).
"""

from __future__ import annotations

import ctypes

import torch

from ..particles.push_cuda import _lock, build, check_tensor, cuda_device
from .random import MAX_DRAW

launches = {"threefry_split": 0, "threefry_uniform": 0, "threefry_normal": 0}
_MODES = {"split": 0, "uniform": 1, "normal": 2}

_bound = None


def _lib():
    global _bound
    with _lock:
        if _bound is None:
            lib = build()
            lib.vpic_threefry.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_ulonglong,
                ctypes.c_int, ctypes.c_float, ctypes.c_float,
                ctypes.c_void_p]
            lib.vpic_threefry.restype = ctypes.c_int
            _bound = lib
        return _bound


def _launch(mode: str, key: torch.Tensor, out: torch.Tensor, n: int,
            lo: float = 0.0, hi: float = 1.0) -> torch.Tensor:
    device = cuda_device(key)
    check_tensor("key", key, torch.int64, (2,), device)
    if not 0 <= n <= MAX_DRAW:
        raise ValueError(f"the threefry kernel counts in 32 bits: n = {n} "
                         "is not below 2^32")
    if mode == "split" and out.data_ptr() % 16:
        raise ValueError("a split stores 16-byte key pairs: its output "
                         "must be 16-byte aligned")
    if n == 0:
        return out
    err = _lib().vpic_threefry(
        key.data_ptr(), out.data_ptr(), n, _MODES[mode], lo, hi,
        torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"threefry {mode} kernel launch failed: "
                           f"cudaError {err}")
    with _lock:
        launches["threefry_" + mode] += 1
    return out


def split(key: torch.Tensor, n: int) -> torch.Tensor:
    """(n, 2) int64: ``jax.random.split(key, n)``'s key data."""
    out = torch.empty((n, 2), dtype=torch.int64, device=key.device)
    return _launch("split", key, out, n)


def uniform(key: torch.Tensor, n: int, lo: float, hi: float) -> torch.Tensor:
    """(n,) float32: ``jax.random.uniform(key, (n,), float32, lo, hi)``
    (``lo`` and ``hi`` already float32 values)."""
    out = torch.empty((n,), dtype=torch.float32, device=key.device)
    return _launch("uniform", key, out, n, lo, hi)


def normal(key: torch.Tensor, n: int) -> torch.Tensor:
    """(n,) float32: ``jax.random.normal(key, (n,), float32)``."""
    out = torch.empty((n,), dtype=torch.float32, device=key.device)
    return _launch("normal", key, out, n)


def reset_launch_counts() -> None:
    with _lock:
        for k in launches:
            launches[k] = 0
