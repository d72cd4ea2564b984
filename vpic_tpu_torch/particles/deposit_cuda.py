"""The hand-written CUDA deposit kernel (``csrc/deposit_sorted.cu``) and its
wrappers.

:func:`deposit_sorted_into` and :func:`deposit_dense_sorted` take the
arguments and give the results of their plain versions in ``deposit.py``.
For tensors on the CPU they call the plain version; for CUDA tensors they
launch the kernel (built with the package's other kernels by
``push_cuda.build``), and a build or launch failure raises.

The kernel sums in fixed point, so its result does not depend on lane
order or thread timing: two runs are bitwise equal.  The fixed-point
scratch goes back to float32 through ``push_walk.cu``'s
``vpic_acc_unfix``, as the push kernel's does.  It agrees with the
plain float ``index_add`` to float32 roundoff.  Its second result counts
valid lanes whose voxel lies outside ``[0, nv)``: those are skipped, and
the count is 0 in any valid call.

``launches["deposit_sorted"]`` counts the kernel's launches.  The
binding and the count are made under ``push_cuda._lock`` (shards call
from their own threads).
"""

from __future__ import annotations

import ctypes

import torch

from . import deposit as plain
from .push_cuda import _lock, build, check_tensor, cuda_device

launches = {"deposit_sorted": 0}


class _DepositArgs(ctypes.Structure):
    """Mirror of ``struct DepositArgs`` in csrc/deposit_sorted.cu."""
    _fields_ = ([("c", ctypes.c_void_p * 12)]
                + [(k, ctypes.c_void_p) for k in ("vox", "valid", "fix",
                                                  "scale")]
                + [(k, ctypes.c_int) for k in ("n", "nv")])


_bound = None


def _lib():
    with _lock:
        return _bind()


def _bind():
    global _bound
    if _bound is None:
        lib = build()
        lib.vpic_deposit_args_size.argtypes = []
        lib.vpic_deposit_args_size.restype = ctypes.c_int
        lib.vpic_deposit_sorted.argtypes = [ctypes.POINTER(_DepositArgs),
                                            ctypes.c_void_p]
        lib.vpic_deposit_sorted.restype = ctypes.c_int
        if lib.vpic_deposit_args_size() != ctypes.sizeof(_DepositArgs):
            raise RuntimeError("DepositArgs layout differs between "
                               "deposit_sorted.cu and deposit_cuda.py")
        _bound = lib
    return _bound


def deposit_sorted_into(acc, vox, contrib_cols, valid, nv: int):
    """Kernel version of :func:`deposit.deposit_sorted_into`: returns
    ``(acc + contributions, out-of-range lane count)``."""
    if acc.device.type == "cpu":
        return plain.deposit_sorted_into(acc, vox, contrib_cols, valid, nv)
    device = cuda_device(acc)
    n = vox.shape[0]
    check_tensor("acc", acc, torch.float32, (nv, 12), device)
    check_tensor("vox", vox, torch.int32, (n,), device)
    check_tensor("valid", valid, torch.bool, (n,), device)
    if len(contrib_cols) != 12:
        raise ValueError(f"expected 12 contribution columns, got "
                         f"{len(contrib_cols)}")
    for k, c in enumerate(contrib_cols):
        check_tensor(f"contrib_cols[{k}]", c, torch.float32, (n,), device)
    if n >= 2 ** 31 or 12 * nv >= 2 ** 31:
        raise ValueError("the kernel indexes with 32-bit counts")

    fix = torch.empty((12 * nv + 2,), dtype=torch.int64, device=device)
    scale = torch.empty((), dtype=torch.float64, device=device)
    args = _DepositArgs((ctypes.c_void_p * 12)(*(c.data_ptr()
                                                 for c in contrib_cols)),
                        vox.data_ptr(), valid.data_ptr(), fix.data_ptr(),
                        scale.data_ptr(), n, nv)
    lib = _lib()
    stream = torch.cuda.current_stream(device).cuda_stream
    err = lib.vpic_deposit_sorted(ctypes.byref(args), stream)
    if err != 0:
        raise RuntimeError(f"deposit_sorted kernel launch failed: "
                           f"cudaError {err}")
    with _lock:
        launches["deposit_sorted"] += 1
    acc_out = torch.empty_like(acc)
    err = lib.vpic_acc_unfix(fix.data_ptr(), scale.data_ptr(),
                             acc.data_ptr(), acc_out.data_ptr(), 12 * nv,
                             stream)
    if err != 0:
        raise RuntimeError(f"acc_unfix kernel launch failed: cudaError {err}")
    return acc_out, fix[-1].to(torch.int32)


def deposit_dense_sorted(vox, contrib, nv: int):
    """Kernel version of :func:`deposit.deposit_dense_sorted`."""
    if contrib.device.type == "cpu":
        return plain.deposit_dense_sorted(vox, contrib, nv)
    acc = torch.zeros((nv, 12), dtype=torch.float32, device=contrib.device)
    valid = torch.ones(vox.shape, dtype=torch.bool, device=vox.device)
    acc, _ = deposit_sorted_into(acc, vox, contrib.t().contiguous().unbind(0),
                                 valid, nv)
    return acc


def reset_launch_counts() -> None:
    for k in launches:
        launches[k] = 0
