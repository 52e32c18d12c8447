"""Wrapper for the hand-written CUDA residual (``csrc/residual.cu``).

``residual_sq(A, b, x̄)`` computes the consensus loop's ‖A x̄ − b‖² for
blocks A (J, p, n), b (J, p[, k]) and x̄ (n[, k]): the products on the tensor
cores at float32 accuracy (3xTF32 wgmma), and the subtraction, the squares
and the sums in the same kernel, so the residual never reaches device
memory. A first, small launch splits x̄ into the TF32 tiles that every block
reads. The reference computes the residual with plain jnp, so the kernels
replace no Pallas kernel. A CPU tensor takes the plain version
(``ref.residual_sq_ref``).

``plan`` picks the kernel's tile from the shapes and the dtype alone, and
keeps the library's product (``ref.residual_sq_ref`` on the card: cuBLAS's
product, then ATen's sums) where that measured faster: up to ``PLAIN_K``
columns, and in float64. The kernels' sums run in a fixed order, so
repeated calls give the same bits. Another dtype raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.residual.ref import residual_sq_ref

# calls that launched the kernels (the CPU path and the library's product do
# not count)
launches = 0

# for each config of csrc/residual.cu's residual_launch, kept in step with
# it: the columns of k of a block's tile (KT), the columns of n a stage reads
# (BK) and the tile's rows (BM, 64 a warpgroup)
CONFIGS = ((32, 64, 64), (64, 32, 128))
DTYPES = (torch.float32, torch.float64)
# up to this many columns the library's product is kept: at s5 and one
# column cuBLAS's gemv took 0.132 ms where a tile of 8 columns took 0.146.
# Float64 keeps it too: at t1's A, k = 32, cuBLAS's float64 product plus
# ATen took 0.096 ms, a CUDA-core float64 kernel 0.285
PLAIN_K = 8


def plan(J: int, p: int, n: int, k: int, dtype: torch.dtype = torch.float32) -> int | None:
    """The config of a (J, p, n) × (n, k) call, a function of the shapes and
    the dtype only; None keeps the library's product (k ≤ ``PLAIN_K``, or
    float64). Up to 32 columns the call is bound by A's bytes: one
    warpgroup a tile, so that at s5 every tile is resident at once. Past 32
    it is bound by the products: 64 columns, two warpgroups sharing each x̄
    tile."""
    if k <= PLAIN_K or dtype != torch.float32:
        return None
    return 0 if k <= 32 else 1


def _lib():
    lib = _build.load("residual")
    fn = lib.residual_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _launch(blocks, bvecs, xbar, config: int, per_block: bool = True):
    """(residual_sq (k,), block_sq (J, k), or None without ``per_block``) for
    batched float32 (J, p, k) b and (n, k) x̄."""
    global launches
    dev = blocks.device
    _build.check_cuda("residual_sq", dev, blocks=blocks, bvecs=bvecs, xbar=xbar)
    for name, t in (("A", blocks), ("b", bvecs), ("x̄", xbar)):
        _build.dtype_code(t, (torch.float32,), f"residual_sq {name}")
    J, p, n = blocks.shape
    k = xbar.shape[1]
    total = torch.empty(k, dtype=torch.float32, device=dev)
    block = torch.empty(J, k, dtype=torch.float32, device=dev) if per_block else None
    if k == 0 or p == 0:
        return total.zero_(), None if block is None else block.zero_()
    if blocks.data_ptr() % 16:
        raise ValueError("residual_sq: A must be 16-byte aligned")
    kt, bk, bm = CONFIGS[config]
    kgroups = -(-k // kt)
    # x̄ split into its TF32 hi and lo tiles, the tiles' column sums, the
    # per-block sums where the caller does not keep them, and the tickets
    # (int32, zeroed by the launch)
    sizes = [kgroups * -(-n // bk) * 2 * bk * kt, J * -(-p // bm) * k,
             0 if per_block else J * k, J * kgroups + 1]
    xs, tile_sq, kept, tickets = torch.empty(
        sum(sizes), dtype=torch.float32, device=dev).split(sizes)
    rc = _lib()(
        blocks.data_ptr(), bvecs.data_ptr(), xbar.data_ptr(), xs.data_ptr(), tile_sq.data_ptr(),
        tickets.data_ptr(), (kept if block is None else block).data_ptr(), total.data_ptr(),
        J, p, n, k, config, _build.stream_handle(dev),
    )
    if rc != 0:
        raise RuntimeError(f"residual kernel launch failed (cudaError {rc})")
    launches += 1
    return total, block


def residual_sq(
    blocks: torch.Tensor,  # (J, p, n)
    bvecs: torch.Tensor,  # (J, p) or (J, p, k)
    xbar: torch.Tensor,  # (n,) or (n, k)
    per_block: bool = False,
):
    """‖A x̄ − b‖² block-wise: a scalar for x̄ (n,), a (k,) vector for x̄
    (n, k); with ``per_block`` the pair (that, the per-block sums (J[, k])).
    An unbatched b (J, p) against a batched x̄ is the same b for every
    column, as in ``core.consensus.block_residual_sq``."""
    if blocks.ndim != 3 or xbar.ndim not in (1, 2) or bvecs.ndim not in (2, xbar.ndim + 1):
        raise ValueError(
            "residual_sq takes A (J, p, n), b (J, p[, k]) and x̄ (n[, k]); "
            f"got {tuple(blocks.shape)}, {tuple(bvecs.shape)}, {tuple(xbar.shape)}"
        )
    J, p, n = blocks.shape
    if (xbar.shape[0] != n or bvecs.shape[:2] != (J, p)
            or (bvecs.ndim == 3 and bvecs.shape[2] != xbar.shape[1])):
        raise ValueError(
            f"residual_sq: b {tuple(bvecs.shape)} and x̄ {tuple(xbar.shape)} do not match "
            f"A {tuple(blocks.shape)}"
        )
    if all(t.device.type == "cpu" for t in (blocks, bvecs, xbar)):
        return residual_sq_ref(blocks, bvecs, xbar, per_block)
    if blocks.device.type != "cuda":
        raise ValueError(f"residual_sq: no kernel for device {blocks.device}")
    _build.dtype_code(blocks, DTYPES, "residual_sq A")
    for name, t in (("b", bvecs), ("x̄", xbar)):
        _build.dtype_code(t, (blocks.dtype,), f"residual_sq {name}")
    config = plan(J, p, n, xbar.shape[1] if xbar.ndim == 2 else 1, blocks.dtype)
    if config is None:
        return residual_sq_ref(blocks, bvecs, xbar, per_block)
    if bvecs.ndim == 2:
        bvecs = bvecs[..., None].expand(J, p, xbar.shape[1]).contiguous()
    total, block = _launch(blocks, bvecs, xbar, config, per_block)
    return (total, block) if per_block else total
