"""Wrappers for the hand-written SpMM kernels (``csrc/spmm.cu``).

``spmm_packed`` computes the forward product from the packed-nonzero form of
the shards (``pack.pack``): ``out[j, r] = Σ_s data[j, r, s] @ x[j,
indices[j, r, s]]`` with only the nonzeros stored. ``spmm(indices, data, x)``
is the same product on the blocked-ELL arrays: on a CUDA tensor it packs them
and launches the packed kernel (the matrix-free main path packs once per
operator and calls ``spmm_packed``). ``spmm_fused`` streams the ELL tiles and
adds the staged transpose contributions ``data[j, r, s]ᵀ @ y[j, r]`` from
the same tile reads; the caller scatter-adds those
(``repro_torch.sparse.bsr._scatter_contrib``). All return the forward
product as (J, R*bp, k) in the data dtype, as the JAX package's ``ops.spmm``
does.

A CPU tensor takes the plain version (``ref.spmm_plain`` /
``ref.spmm_packed_plain`` / ``ref.spmm_fused_plain``); a CUDA tensor launches
the kernel or raises. ``x`` may be broadcast over the J blocks with a zero
stride (``xb.expand(J, ...)``): the kernels take x's block stride as given.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.spmm.pack import Packed, pack
from repro_torch.kernels.spmm.ref import spmm_fused_plain, spmm_packed_plain, spmm_plain

# kernel launches made by this process, by kernel (the CPU path does not
# count): "spmm" counts the packed kernel, whichever wrapper launched it
launches = {"spmm": 0, "spmm_fused": 0}

_DTYPES = (torch.float32, torch.float64)
MAX_TILE = 128  # the wrappers take tiles with each side at most this


def _fn(name: str, argtypes):
    """``csrc/spmm.cu``'s ``name`` with its ctypes signature."""
    fn = getattr(_build.load("spmm"), name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


_PTR, _INT, _LONG = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# (row_ptr, col, val, x, x's block stride, out, rows, block rows, k, dtype, stream)
_PACKED_ARGS = [_PTR] * 4 + [_LONG, _PTR] + [_INT] * 4 + [_PTR]
# (idx, data, x, x's block stride, y, out, contrib, J, R, S, bp, bn, k, dtype, stream)
_FUSED_ARGS = [_PTR] * 3 + [_LONG] + [_PTR] * 3 + [_INT] * 7 + [_PTR]


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


def _x_jstride(what, x, dev) -> int:
    """x's stride between blocks, in elements: 0 (broadcast) or one slab."""
    if x.device != dev:
        raise ValueError(f"{what}: x is on {x.device}, expected {dev}")
    # x (J, C, bn, k): each block's (C, bn, k) slab contiguous; blocks either
    # contiguous one after another or all the same slab (stride 0)
    if not x[0].is_contiguous():
        raise ValueError(f"{what}: x must be contiguous within each block")
    slab = x.shape[1] * x.shape[2] * x.shape[3]
    x_jstride = x.stride(0) if x.shape[0] > 1 else slab
    if x_jstride not in (0, slab):
        raise ValueError(f"{what}: x's block stride {x_jstride} is neither 0 nor {slab}")
    return x_jstride


def _launch_args(what, indices, data, x, y=None):
    """Check what the kernel reads; returns (dtype code, x's block stride)."""
    dev = data.device
    if dev.type != "cuda":
        raise ValueError(f"{what}: no kernel for device {dev}")
    _build.check_cuda(what, dev, indices=indices, data=data, y=y)
    if indices.dtype != torch.int32:
        raise TypeError(f"{what}: indices must be int32, got {indices.dtype}")
    code = _build.dtype_code(data, _DTYPES, what)
    for key, t in (("x", x), ("y", y)):
        if t is not None and t.dtype != data.dtype:
            raise TypeError(f"{what}: {key} is {t.dtype}, data is {data.dtype}")
    bp, bn = data.shape[-2:]
    if bp > MAX_TILE or bn > MAX_TILE:
        raise ValueError(f"{what}: tile ({bp}, {bn}) has a side above {MAX_TILE}")
    return code, _x_jstride(what, x, dev)


def spmm(
    indices: torch.Tensor,  # (J, R, S) int32
    data: torch.Tensor,  # (J, R, S, bp, bn)
    x: torch.Tensor,  # (J, C, bn, k) tile view
) -> torch.Tensor:
    """Blocked-ELL SpMM: returns (J, R*bp, k) in the data dtype. On the card
    the shards are packed on every call, then ``spmm_packed`` runs."""
    _check_shapes("spmm", indices, data, x)
    if _on_cpu(indices, data, x):
        return spmm_plain(indices, data, x)
    _launch_args("spmm", indices, data, x)
    return spmm_packed(pack(indices, data), x)


def spmm_packed(
    packed: Packed,  # from pack(indices, data)
    x: torch.Tensor,  # (J, C, bn, k) tile view
) -> torch.Tensor:
    """The packed-nonzero SpMM: returns (J, block_rows, k) in the data dtype."""
    J, rows = packed.num_blocks, packed.block_rows
    if x.ndim != 4 or x.shape[0] != J or x.shape[2] != packed.bn:
        raise ValueError(
            f"spmm_packed: x {tuple(x.shape)} is not (J, C, bn, k) with J = {J}, "
            f"bn = {packed.bn}"
        )
    val = packed.val
    if _on_cpu(val, x):
        return spmm_packed_plain(packed, x)
    dev = val.device
    if dev.type != "cuda":
        raise ValueError(f"spmm_packed: no kernel for device {dev}")
    _build.check_cuda("spmm_packed", dev, row_ptr=packed.row_ptr, col=packed.col, val=val)
    code = _build.dtype_code(val, _DTYPES, "spmm_packed")
    if x.dtype != val.dtype:
        raise TypeError(f"spmm_packed: x is {x.dtype}, the operator is {val.dtype}")
    x_jstride = _x_jstride("spmm_packed", x, dev)
    k = x.shape[3]
    out = torch.empty((J, rows, k), dtype=val.dtype, device=dev)
    if out.numel() == 0:
        return out
    rc = _fn("spmm_packed_launch", _PACKED_ARGS)(
        packed.row_ptr.data_ptr(), packed.col.data_ptr(), val.data_ptr(), x.data_ptr(),
        x_jstride, out.data_ptr(), J * rows, rows, k, code, _build.stream_handle(dev),
    )
    if rc != 0:
        raise RuntimeError(f"spmm_packed kernel launch failed (cudaError {rc})")
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
    rc = _fn("spmm_fused_launch", _FUSED_ARGS)(
        indices.data_ptr(), data.data_ptr(), x.data_ptr(), x_jstride, y.data_ptr(),
        out.data_ptr(), contrib.data_ptr(), J, R, S, bp, bn, k, code,
        _build.stream_handle(data.device),
    )
    if rc != 0:
        raise RuntimeError(f"spmm_fused kernel launch failed (cudaError {rc})")
    launches["spmm_fused"] += 1
    return out, contrib
