"""Wrapper for the hand-written CUDA triangular solve (``csrc/trisolve.cu``).

One launch solves op(R_j) x_j = y_j for all J blocks and all k columns: the
reference vmapped its single-column Pallas kernel over both. The kernel runs
one thread block per (j, 64-row block, 8 columns), ordered by tickets and
ready flags in a zeroed int32 scratch that the wrapper allocates on every
call. A CPU tensor takes the plain version (``ref.trisolve_ref``;
``ref.trisolve_blocked_plain`` spells out the kernel's blocking); a CUDA
tensor launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.trisolve.ref import TB, trisolve_ref

# kernel launches made by this process (the CPU path does not count)
launches = 0

_DTYPES = (torch.float32, torch.float64)
KT = 8  # columns per thread block in csrc/trisolve.cu


def _lib():
    lib = _build.load("trisolve")
    fn = lib.trisolve_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def trisolve(
    r: torch.Tensor,  # (J, n, n) triangular
    y: torch.Tensor,  # (J, n, k)
    lower: bool = False,
    transpose: bool = False,
) -> torch.Tensor:
    """x (J, n, k) with op(R) x = y; op(R) = Rᵀ when ``transpose`` (read in
    place, no copy). ``lower`` names the triangle of op(R)."""
    global launches
    if r.ndim != 3 or y.ndim != 3 or r.shape[1] != r.shape[2]:
        raise ValueError(f"trisolve takes R (J, n, n) and y (J, n, k); got {r.shape}, {y.shape}")
    if y.shape[:2] != r.shape[:2]:
        raise ValueError(f"trisolve: y {tuple(y.shape)} does not match R {tuple(r.shape)}")
    if r.device.type == "cpu" and y.device.type == "cpu":
        return trisolve_ref(r, y, lower, transpose)
    if r.device.type != "cuda":
        raise ValueError(f"trisolve: no kernel for device {r.device}")
    _build.check_cuda("trisolve", r.device, r=r, y=y)
    code = _build.dtype_code(r, _DTYPES, "trisolve")
    if y.dtype != r.dtype:
        raise TypeError(f"trisolve: y is {y.dtype}, R is {r.dtype}")
    J, n, k = y.shape
    x = torch.empty_like(y)
    if x.numel() == 0:
        return x
    # the ticket counter, then one ready flag per (j, row block, k-tile)
    sync = torch.zeros(1 + J * -(-n // TB) * -(-k // KT), dtype=torch.int32, device=r.device)
    rc = _lib()(
        r.data_ptr(), y.data_ptr(), x.data_ptr(), sync.data_ptr(), J, n, k, int(lower),
        int(transpose), code, _build.stream_handle(r.device),
    )
    if rc != 0:
        raise RuntimeError(f"trisolve kernel launch failed (cudaError {rc})")
    launches += 1
    return x
