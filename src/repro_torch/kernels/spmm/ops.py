"""Wrappers for the hand-written SpMM kernels (``csrc/spmm.cu``), which take
the packed-nonzero form of the shards (``pack.pack``) and nothing else.

``spmm_packed`` computes the product ``out[j, r] = Σ_s data[j, r, s] @ x[j,
indices[j, r, s]]`` from the packed form, with only the nonzeros stored; it
comes back as (J, R*bp, k) in the data dtype, as the JAX package's
``ops.spmm`` does. ``spmm_fused_packed`` is the matrix-free epoch's fused
pass: ``A_j x`` on the forward packed form and ``A_jᵀ y_j`` on the
transposed packed form (the CSC of A_j's nonzeros) from one launch, each
output row written once, nothing staged and nothing scattered. Which route
a product takes, and whether an operator carries its packed forms, is
``repro_torch.sparse.bsr.PartitionedBSR``'s to decide.

A CPU tensor takes the plain version (``ref.spmm_packed_plain`` /
``ref.spmm_fused_packed_plain``); a CUDA tensor launches the kernel or
raises. ``x`` may be broadcast over the J blocks with a zero stride
(``xb.expand(J, ...)``): the kernels take x's block stride as given.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.spmm.pack import Packed
from repro_torch.kernels.spmm.ref import spmm_fused_packed_plain, spmm_packed_plain

# kernel launches made by this process, by kernel (the CPU path does not
# count): "spmm" counts the packed kernel, "spmm_fused_packed" the fused pass
launches = {"spmm": 0, "spmm_fused_packed": 0}

_DTYPES = (torch.float32, torch.float64)


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
