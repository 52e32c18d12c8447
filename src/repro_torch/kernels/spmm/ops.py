"""Wrappers for the hand-written SpMM kernels (``csrc/spmm.cu``).

``spmm_packed`` computes the forward product from the packed-nonzero form of
the shards (``pack.pack``): ``out[j, r] = Σ_s data[j, r, s] @ x[j,
indices[j, r, s]]`` with only the nonzeros stored. ``spmm(indices, data, x)``
is the same product on the blocked-ELL arrays: on a CUDA tensor it packs them
and launches the packed kernel (the matrix-free main path packs once per
operator and calls ``spmm_packed``). ``spmm_fused_packed`` is the matrix-free
epoch's fused pass: ``A_j x`` on the forward packed form and ``A_jᵀ y_j`` on
the transposed packed form (the CSC of A_j's nonzeros) from one launch, each
output row written once, nothing staged and nothing scattered.
``spmm_fused`` keeps the staged interface of the JAX package's fused kernel:
it streams the ELL tiles and adds the per-slot transpose contributions
``data[j, r, s]ᵀ @ y[j, r]`` from the same tile reads, which the caller
scatter-adds (``repro_torch.sparse.bsr._scatter_contrib``). The ELL and
packed forward products come back as (J, R*bp, k) in the data dtype, as the
JAX package's ``ops.spmm`` does.

A CPU tensor takes the plain version (``ref.spmm_plain`` /
``ref.spmm_packed_plain`` / ``ref.spmm_fused_packed_plain`` /
``ref.spmm_fused_plain``); a CUDA tensor launches the kernel or raises. ``x``
may be broadcast over the J blocks with a zero stride (``xb.expand(J,
...)``): the kernels take x's block stride as given.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.spmm.pack import Packed, pack
from repro_torch.kernels.spmm.ref import (
    spmm_fused_packed_plain,
    spmm_fused_plain,
    spmm_packed_plain,
    spmm_plain,
)

# kernel launches made by this process, by kernel (the CPU path does not
# count): "spmm" counts the packed kernel, whichever wrapper launched it;
# "spmm_fused" the staged ELL kernel, "spmm_fused_packed" the fused packed one
launches = {"spmm": 0, "spmm_fused": 0, "spmm_fused_packed": 0}

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
# one row range of a packed product: (row_ptr, col, val, x, x's block
# stride, out, rows, block rows)
_RANGE_ARGS = [_PTR] * 4 + [_LONG, _PTR] + [_INT] * 2
# (range, k, dtype, stream)
_PACKED_ARGS = _RANGE_ARGS + [_INT] * 2 + [_PTR]
# (forward range, transposed range, k, dtype, stream)
_FUSED_PACKED_ARGS = _RANGE_ARGS * 2 + [_INT] * 2 + [_PTR]
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


def _x_jstride(what, x, dev, name="x") -> int:
    """x's stride between blocks, in elements: 0 (broadcast) or one slab."""
    if x.device != dev:
        raise ValueError(f"{what}: {name} is on {x.device}, expected {dev}")
    # x (J, C, bn, k): each block's (C, bn, k) slab contiguous; blocks either
    # contiguous one after another or all the same slab (stride 0)
    if not x[0].is_contiguous():
        raise ValueError(f"{what}: {name} must be contiguous within each block")
    slab = x.shape[1] * x.shape[2] * x.shape[3]
    x_jstride = x.stride(0) if x.shape[0] > 1 else slab
    if x_jstride not in (0, slab):
        raise ValueError(f"{what}: {name}'s block stride {x_jstride} is neither 0 nor {slab}")
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


def _check_operand(what, packed: Packed, x: torch.Tensor, name="x") -> None:
    """x must be the (J, C, bn, k) tile view the packed form gathers from."""
    J = packed.num_blocks
    if x.ndim != 4 or x.shape[0] != J or x.shape[2] != packed.bn:
        raise ValueError(
            f"{what}: {name} {tuple(x.shape)} is not (J, C, bn, k) with J = {J}, "
            f"bn = {packed.bn}"
        )


def _packed_launch_args(what, packed: Packed, x: torch.Tensor, name="x"):
    """Check what the packed kernel reads of one packed form and its operand;
    returns (dtype code, the operand's block stride)."""
    val = packed.val
    dev = val.device
    if dev.type != "cuda":
        raise ValueError(f"{what}: no kernel for device {dev}")
    _build.check_cuda(what, dev, row_ptr=packed.row_ptr, col=packed.col, val=val)
    code = _build.dtype_code(val, _DTYPES, what)
    if x.dtype != val.dtype:
        raise TypeError(f"{what}: {name} is {x.dtype}, the operator is {val.dtype}")
    return code, _x_jstride(what, x, dev, name)


def _range_args(packed: Packed, x: torch.Tensor, x_jstride: int, out: torch.Tensor):
    """One row range of a packed launch, in ``_RANGE_ARGS`` order."""
    rows = packed.block_rows
    return (packed.row_ptr.data_ptr(), packed.col.data_ptr(), packed.val.data_ptr(),
            x.data_ptr(), x_jstride, out.data_ptr(), packed.num_blocks * rows, rows)


def spmm_packed(
    packed: Packed,  # from pack(indices, data)
    x: torch.Tensor,  # (J, C, bn, k) tile view
) -> torch.Tensor:
    """The packed-nonzero SpMM: returns (J, block_rows, k) in the data dtype."""
    _check_operand("spmm_packed", packed, x)
    if _on_cpu(packed.val, x):
        return spmm_packed_plain(packed, x)
    code, x_jstride = _packed_launch_args("spmm_packed", packed, x)
    dev, k = packed.val.device, x.shape[3]
    out = torch.empty((packed.num_blocks, packed.block_rows, k), dtype=x.dtype, device=dev)
    if out.numel() == 0:
        return out
    rc = _fn("spmm_packed_launch", _PACKED_ARGS)(
        *_range_args(packed, x, x_jstride, out), k, code, _build.stream_handle(dev),
    )
    if rc != 0:
        raise RuntimeError(f"spmm_packed kernel launch failed (cudaError {rc})")
    launches["spmm"] += 1
    return out


def spmm_fused_packed(
    fwd_packed: Packed,  # the forward shards' packed form: (J, Rp*bp) rows
    tra_packed: Packed,  # the transposed shards' packed form: (J, Rn*bn) rows
    xb: torch.Tensor,  # (J, C, bn, k) column-space tile view (stride 0: broadcast)
    yb: torch.Tensor,  # (J, Rp, bp, k) row-space tile view, internal row order
) -> tuple[torch.Tensor, torch.Tensor]:
    """The matrix-free epoch's fused pass: (A_j x (J, Rp*bp, k), A_jᵀ y_j
    (J, Rn*bn, k)) in the data dtype, from one launch that writes each output
    row once: no staged contributions, no scatter."""
    what = "spmm_fused_packed"
    _check_operand(what, fwd_packed, xb, "x")
    _check_operand(what, tra_packed, yb, "y")
    if tra_packed.num_blocks != fwd_packed.num_blocks or xb.shape[3] != yb.shape[3]:
        raise ValueError(
            f"{what}: x {tuple(xb.shape)} and y {tuple(yb.shape)} differ in J or k"
        )
    dtype = fwd_packed.val.dtype
    for name, t in (("the transposed form", tra_packed.val), ("x", xb), ("y", yb)):
        if t.dtype != dtype:
            raise TypeError(f"{what}: {name} is {t.dtype}, the forward form is {dtype}")
    if _on_cpu(fwd_packed.val, tra_packed.val, xb, yb):
        return spmm_fused_packed_plain(fwd_packed, tra_packed, xb, yb)
    code, x_jstride = _packed_launch_args(what, fwd_packed, xb, "x")
    if tra_packed.val.device != fwd_packed.val.device:
        raise ValueError(
            f"{what}: the transposed form is on {tra_packed.val.device}, the forward "
            f"form on {fwd_packed.val.device}"
        )
    _, y_jstride = _packed_launch_args(what, tra_packed, yb, "y")
    J, k = fwd_packed.num_blocks, xb.shape[3]
    dev = fwd_packed.val.device
    fwd = torch.empty((J, fwd_packed.block_rows, k), dtype=xb.dtype, device=dev)
    tra = torch.empty((J, tra_packed.block_rows, k), dtype=xb.dtype, device=dev)
    if fwd.numel() == 0 and tra.numel() == 0:
        return fwd, tra
    rc = _fn("spmm_fused_packed_launch", _FUSED_PACKED_ARGS)(
        *_range_args(fwd_packed, xb, x_jstride, fwd),
        *_range_args(tra_packed, yb, y_jstride, tra),
        k, code, _build.stream_handle(dev),
    )
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed (cudaError {rc})")
    launches["spmm_fused_packed"] += 1
    return fwd, tra


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
