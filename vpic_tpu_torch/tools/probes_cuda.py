"""The ctypes binding of the probe kernels (``csrc/probes.cu``) and what
the probe tools share: the device an entry point runs on, the launch of
one kernel, CUDA-event timing and the bound of a timed call (the
wrappers check their tensors with ``push_cuda.check_tensor``).

The kernels are built with the package's other kernels by
``particles.push_cuda.build`` (one ``nvcc`` per source, at first use);
nothing is built when this module is imported.
"""

from __future__ import annotations

import ctypes
import subprocess

import torch

from ..particles.push_cuda import _lock, build

# the H100 SXM's published peaks (dense): device memory, float32 outside
# the tensor cores, bf16 on the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
BF16_TENSOR_OPS_PER_S = 989e12

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = {
    # the shape and reps, then vpu_layout_probe.py's ChainPlan
    "vpic_probe_vpu_chain": [_P, _P] + [_I] * 10 + [_P],
    # the shape, then tools/mma_plan.py's MmaPlan.args()
    "vpic_probe_gather3d": [_P, _P, _P] + [_I] * 17 + [_P],
    "vpic_probe_deposit2d": [_P, _P, _P] + [_I] * 17 + [_P],
    # the shape, then probe_batched.py's Stack8Plan
    "vpic_probe_stack8": [_P, _P, _P] + [_I] * 9 + [_P],
    # the shape, then probe_batched.py's Onehot3dPlan
    "vpic_probe_onehot3d": [_P, _P] + [_I] * 6 + [_P],
    # the shape, then probe_batched.py's Io4dPlan
    "vpic_probe_io4d": [_P, _P, _I, _I, _I, _I, _P],
}

_bound = None


def _lib():
    global _bound
    with _lock:
        if _bound is None:
            lib = build()
            for name, argtypes in _ARGTYPES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _bound = lib
    return _bound


def resolve_device(device) -> torch.device:
    """The device of an entry point: the card unless the CPU is asked
    for; a CUDA device raises where there is none."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {str(device)!r}: no CUDA device is "
                           "available")
    return device


def card_line(device) -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    index = torch.device(device).index or 0
    try:
        r = subprocess.run(["nvidia-smi", f"--id={index}",
                            "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=60, check=True)
        return r.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return (f"{torch.cuda.get_device_name(device)}, power limit not "
                "read (nvidia-smi failed)")


def launch(fn_name: str, launches: dict, key: str, device, *args) -> None:
    """Launch ``fn_name`` with ``args`` (tensors as pointers, ints) on the
    device's current stream; raise if the launch fails, else count it.
    The kernels take 32-bit sizes and no empty tensor."""
    for a in args:
        empty, n = ((a.numel() == 0, a.numel()) if isinstance(a, torch.Tensor)
                    else (False, a))
        if empty or not 0 <= n < 2 ** 31:
            raise ValueError(f"{fn_name}: an argument of size {n}; the probe "
                             "kernels take 32-bit sizes and no empty tensor")
    lib = _lib()
    stream = torch.cuda.current_stream(device).cuda_stream
    c_args = [a.data_ptr() if isinstance(a, torch.Tensor) else int(a)
              for a in args]
    err = getattr(lib, fn_name)(*c_args, stream)
    if err != 0:
        raise RuntimeError(f"{fn_name} launch failed: cudaError {err}")
    with _lock:
        launches[key] += 1


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of fn() in ms over ``reps`` runs (CUDA events,
    after one warm-up run)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound(nbytes: float, ops: float, ops_per_s: float = FP32_OPS_PER_S):
    """(ms, "bytes" or "operations"): the least time of a call that moves
    ``nbytes`` (each input read once, each output written once) and does
    ``ops`` operations at ``ops_per_s``, at the H100's published peaks."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / ops_per_s
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")
