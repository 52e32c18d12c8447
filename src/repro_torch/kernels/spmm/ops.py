"""Wrappers for the hand-written blocked-ELL SpMM kernels (``csrc/spmm.cu``).

``spmm`` computes ``out[j, r] = Σ_s data[j, r, s] @ x[j, indices[j, r, s]]``
and ``spmm_fused`` adds the staged transpose contributions
``data[j, r, s]ᵀ @ y[j, r]`` from the same tile reads; the caller
scatter-adds those (``repro_torch.sparse.bsr._scatter_contrib``). Both take
the stacked-shard tile view of ``repro_torch.sparse.bsr`` and return the
forward product as (J, R*bp, k) in the data dtype, as the JAX package's
``ops.spmm`` does.

A CPU tensor takes the plain version (``ref.spmm_plain`` /
``ref.spmm_fused_plain``); a CUDA tensor launches the kernel or raises.
``x`` may be broadcast over the J blocks with a zero stride
(``xb.expand(J, ...)``): the kernel takes x's block stride as given.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.spmm.ref import spmm_fused_plain, spmm_plain

# kernel launches made by this process, by kernel (the CPU path does not count)
launches = {"spmm": 0, "spmm_fused": 0}

_DTYPES = (torch.float32, torch.float64)
MAX_TILE = 128  # the kernels take tiles with each side at most this


def _fn(name: str, n_outputs_and_y: int):
    """``csrc/spmm.cu``'s ``name``: (idx, data, x, x's block stride, then
    ``n_outputs_and_y`` pointers, 7 ints, the stream)."""
    fn = getattr(_build.load("spmm"), name)
    if fn.argtypes is None:
        fn.argtypes = (
            [ctypes.c_void_p] * 3 + [ctypes.c_longlong]
            + [ctypes.c_void_p] * n_outputs_and_y
            + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
    return fn


def _check_shapes(what, indices, data, x, y=None):
    if indices.ndim != 3 or data.ndim != 5 or x.ndim != 4:
        raise ValueError(
            f"{what} takes indices (J, R, S), data (J, R, S, bp, bn) and x "
            f"(J, C, bn, k); got {tuple(indices.shape)}, {tuple(data.shape)}, "
            f"{tuple(x.shape)}"
        )
    J, R, S, bp, bn = data.shape
    if tuple(indices.shape) != (J, R, S):
        raise ValueError(f"{what}: indices {tuple(indices.shape)} do not match data {tuple(data.shape)}")
    if x.shape[0] != J or x.shape[2] != bn:
        raise ValueError(f"{what}: x {tuple(x.shape)} does not match data {tuple(data.shape)}")
    if y is not None and tuple(y.shape) != (J, R, bp, x.shape[3]):
        raise ValueError(f"{what}: y {tuple(y.shape)} is not (J, R, bp, k) = {(J, R, bp, x.shape[3])}")


def _on_cpu(*tensors) -> bool:
    return all(t.device.type == "cpu" for t in tensors)


def _launch_args(what, indices, data, x, y=None):
    """Check what the kernel reads; returns (dtype code, x's block stride)."""
    dev = data.device
    if dev.type != "cuda":
        raise ValueError(f"{what}: no kernel for device {dev}")
    _build.check_cuda(what, dev, indices=indices, data=data, y=y)
    if x.device != dev:
        raise ValueError(f"{what}: x is on {x.device}, expected {dev}")
    if indices.dtype != torch.int32:
        raise TypeError(f"{what}: indices must be int32, got {indices.dtype}")
    code = _build.dtype_code(data, _DTYPES, what)
    for key, t in (("x", x), ("y", y)):
        if t is not None and t.dtype != data.dtype:
            raise TypeError(f"{what}: {key} is {t.dtype}, data is {data.dtype}")
    bp, bn = data.shape[-2:]
    if bp > MAX_TILE or bn > MAX_TILE:
        raise ValueError(f"{what}: tile ({bp}, {bn}) has a side above {MAX_TILE}")
    # x (J, C, bn, k): each block's (C, bn, k) slab contiguous; blocks either
    # contiguous one after another or all the same slab (stride 0)
    if not x[0].is_contiguous():
        raise ValueError(f"{what}: x must be contiguous within each block")
    slab = x.shape[1] * x.shape[2] * x.shape[3]
    x_jstride = x.stride(0) if x.shape[0] > 1 else slab
    if x_jstride not in (0, slab):
        raise ValueError(f"{what}: x's block stride {x_jstride} is neither 0 nor {slab}")
    return code, x_jstride


def spmm(
    indices: torch.Tensor,  # (J, R, S) int32
    data: torch.Tensor,  # (J, R, S, bp, bn)
    x: torch.Tensor,  # (J, C, bn, k) tile view
) -> torch.Tensor:
    """Blocked-ELL SpMM: returns (J, R*bp, k) in the data dtype."""
    _check_shapes("spmm", indices, data, x)
    if _on_cpu(indices, data, x):
        return spmm_plain(indices, data, x)
    code, x_jstride = _launch_args("spmm", indices, data, x)
    J, R, S, bp, bn = data.shape
    k = x.shape[3]
    out = torch.empty((J, R * bp, k), dtype=data.dtype, device=data.device)
    if out.numel() == 0:
        return out
    rc = _fn("spmm_launch", 1)(
        indices.data_ptr(), data.data_ptr(), x.data_ptr(), x_jstride, out.data_ptr(),
        J, R, S, bp, bn, k, code, _build.stream_handle(data.device),
    )
    if rc != 0:
        raise RuntimeError(f"spmm kernel launch failed (cudaError {rc})")
    launches["spmm"] += 1
    return out


def spmm_fused(
    indices: torch.Tensor,  # (J, R, S) int32
    data: torch.Tensor,  # (J, R, S, bp, bn)
    x: torch.Tensor,  # (J, C, bn, k) tile view
    y: torch.Tensor,  # (J, R, bp, k) row-space operand
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused projection pass: (A_j x (J, R*bp, k), staged contributions
    (J, R, S, bn, k)), both in the data dtype, from one read of the tiles."""
    _check_shapes("spmm_fused", indices, data, x, y)
    if _on_cpu(indices, data, x, y):
        return spmm_fused_plain(indices, data, x, y)
    code, x_jstride = _launch_args("spmm_fused", indices, data, x, y)
    J, R, S, bp, bn = data.shape
    k = x.shape[3]
    out = torch.empty((J, R * bp, k), dtype=data.dtype, device=data.device)
    contrib = torch.empty((J, R, S, bn, k), dtype=data.dtype, device=data.device)
    if out.numel() == 0:
        return out, contrib
    rc = _fn("spmm_fused_launch", 3)(
        indices.data_ptr(), data.data_ptr(), x.data_ptr(), x_jstride, y.data_ptr(),
        out.data_ptr(), contrib.data_ptr(), J, R, S, bp, bn, k, code,
        _build.stream_handle(data.device),
    )
    if rc != 0:
        raise RuntimeError(f"spmm_fused kernel launch failed (cudaError {rc})")
    launches["spmm_fused"] += 1
    return out, contrib
