"""Wrapper for the hand-written CUDA consensus update (``csrc/project.cu``).

``consensus_update(W, x, x̄, γ)`` computes x + γ(I − WᵀW)(x̄ − x) for W
(J, p, n) and x, x̄ (J, n, k) in one launch pair, where the reference vmapped
its single-column Pallas kernel over the J blocks and k columns. A CPU
tensor takes the plain version (``ref.consensus_update_ref``); a CUDA
tensor launches the kernel or raises.

The kernel runs its f32 products on the tensor cores as three TF32 products
(3xTF32) and splits each pass's reduction over several thread blocks;
``split_plan`` picks the split from the shapes alone and sizes the scratch.

Differentiable: the backward is the closed implicit-projection formula in
plain PyTorch (P is symmetric idempotent), as the reference's ``custom_vjp``
backward is plain jnp — the dense P is never built in either direction.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.project.ref import _block_gamma, consensus_update_ref

# kernel launch pairs made by this process (the CPU path does not count)
launches = 0

_DTYPES = (torch.float32, torch.bfloat16, torch.float64)

# tiling of csrc/project.cu, kept in step with it: a thread block computes a
# TILE-row output tile for up to 64 columns of k, reducing in DEPTH-deep steps
TILE, DEPTH = 64, 32
# each pass is split until it has about this many thread blocks of 32
# columns (two blocks fit an SM: four waves on the H100's 132 SMs; a 64-column
# block does twice the work, so half as many), keeping at least MIN_STEPS
# reduction steps a block
TARGET_BLOCKS = 528
MIN_STEPS = 4


class SplitPlan(NamedTuple):
    """How one call is cut: ``kt`` columns per block in ``kgroups`` column
    groups, pass 1 (u = W v, over n) in ``splits1`` ranges and pass 2
    (Wᵀ u, over p) in ``splits2``; the float32 scratch (padded u, then each
    pass's partial tiles) and the int32 tickets, one per output tile of a
    pass that splits."""
    kt: int
    kgroups: int
    splits1: int
    splits2: int
    u_floats: int
    part1_floats: int
    part2_floats: int
    tickets: int


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _splits(tiles: int, depth: int, target: int) -> int:
    """Ranges the reduction of ``depth`` is cut into for ``tiles`` output
    tiles: enough for ``target`` blocks, each at least MIN_STEPS steps, and
    no range empty."""
    steps = _cdiv(depth, DEPTH)
    want = max(1, min(_cdiv(target, max(tiles, 1)), steps // MIN_STEPS))
    return _cdiv(steps, _cdiv(steps, want)) if steps else 1


def split_plan(J: int, p: int, n: int, k: int) -> SplitPlan:
    """The kernel's cut of a (J, p, n) × (J, n, k) call: a function of the
    shapes only."""
    kt = 32 if k <= 32 else 64
    kgroups = _cdiv(k, kt)
    ptiles, ntiles = _cdiv(p, TILE), _cdiv(n, TILE)
    target = TARGET_BLOCKS * 32 // kt
    s1 = _splits(J * ptiles * kgroups, n, target)
    s2 = _splits(J * ntiles * kgroups, p, target)
    tile = TILE * kt
    return SplitPlan(
        kt=kt, kgroups=kgroups, splits1=s1, splits2=s2,
        u_floats=J * ptiles * TILE * kgroups * kt,
        part1_floats=J * ptiles * kgroups * s1 * tile if s1 > 1 else 0,
        part2_floats=J * ntiles * kgroups * s2 * tile if s2 > 1 else 0,
        tickets=J * kgroups * (ptiles * (s1 > 1) + ntiles * (s2 > 1)),
    )


def _lib():
    lib = _build.load("project")
    fn = lib.consensus_update_launch
    if fn.argtypes is None:
        fn.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_float] + [ctypes.c_void_p] * 5
            + [ctypes.c_int] * 9 + [ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
    return fn


def _launch(w, x, xbar, gamma):
    global launches
    dev = w.device
    _build.check_cuda("consensus_update", dev, w=w, x=x, xbar=xbar)
    w_code = _build.dtype_code(w, _DTYPES, "consensus_update W")
    x_code = _build.dtype_code(xbar, _DTYPES, "consensus_update x̄")
    if x is not None and x.dtype != xbar.dtype:
        raise TypeError(f"consensus_update: x is {x.dtype}, x̄ is {xbar.dtype}")
    J, p, n = w.shape
    k = xbar.shape[2]
    out = torch.empty_like(xbar)
    if out.numel() == 0:
        return out
    gvec, gscalar = None, 1.0
    if isinstance(gamma, torch.Tensor) and gamma.ndim >= 1:
        if gamma.shape != (J,):
            raise ValueError(f"consensus_update: γ must be scalar or ({J},), got {tuple(gamma.shape)}")
        gvec = gamma.to(device=dev, dtype=torch.float32).contiguous()
    else:
        gscalar = float(gamma)
    plan = split_plan(J, p, n, k)
    scratch = torch.empty(plan.u_floats + plan.part1_floats + plan.part2_floats,
                          dtype=torch.float32, device=dev)
    u, part1, part2 = scratch.split([plan.u_floats, plan.part1_floats, plan.part2_floats])
    tickets = torch.zeros(plan.tickets, dtype=torch.int32, device=dev) if plan.tickets else None
    rc = _lib()(
        w.data_ptr(), None if x is None else x.data_ptr(), xbar.data_ptr(),
        None if gvec is None else gvec.data_ptr(), gscalar,
        u.data_ptr(), part1.data_ptr(), part2.data_ptr(),
        None if tickets is None else tickets.data_ptr(), out.data_ptr(),
        J, p, n, k, plan.kt, plan.splits1, plan.splits2, w_code, x_code,
        _build.stream_handle(dev),
    )
    if rc != 0:
        raise RuntimeError(f"consensus_update kernel launch failed (cudaError {rc})")
    launches += 1
    return out


class _ConsensusUpdate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w, x, xbar, gamma):
        ctx.save_for_backward(w, x, xbar)
        ctx.gamma = gamma
        if w.device.type == "cpu" and xbar.device.type == "cpu":
            return consensus_update_ref(
                w, torch.zeros_like(xbar) if x is None else x, xbar, gamma
            )
        if w.device.type != "cuda":
            raise ValueError(f"consensus_update: no kernel for device {w.device}")
        return _launch(w, x, xbar, gamma)

    @staticmethod
    def backward(ctx, g):
        w, x, xbar = ctx.saved_tensors
        gam = _block_gamma(ctx.gamma, 3)
        f32 = torch.float32
        v = xbar.to(f32) if x is None else xbar.to(f32) - x.to(f32)
        w_dtype = w.dtype
        w, g = w.to(f32), g.to(f32)
        wg = w @ g
        Pg = g - w.mT @ wg  # P is symmetric: the vjp of P v wrt v is P g
        u = w @ v
        # d(Wᵀ(W v))/dW contribution: u gᵀ + (W g) vᵀ, summed over columns
        dw = -gam * (u @ g.mT + wg @ v.mT)
        dx = None if x is None else (g - gam * Pg).to(x.dtype)
        dxbar = (gam * Pg).to(xbar.dtype)
        return dw.to(w_dtype), dx, dxbar, None


def _check_shapes(w, x, xbar):
    if w.ndim != 3 or xbar.ndim != 3:
        raise ValueError(
            f"consensus_update takes W (J, p, n) and x̄ (J, n, k); got {w.shape}, {xbar.shape}"
        )
    if xbar.shape[:2] != (w.shape[0], w.shape[2]):
        raise ValueError(f"consensus_update: x̄ {tuple(xbar.shape)} does not match W {tuple(w.shape)}")
    if x is not None and x.shape != xbar.shape:
        raise ValueError(f"consensus_update: x {tuple(x.shape)} differs from x̄ {tuple(xbar.shape)}")


def consensus_update(
    w: torch.Tensor,  # (J, p, n)
    x: torch.Tensor | None,  # (J, n, k); None means 0
    xbar: torch.Tensor,  # (J, n, k)
    gamma=1.0,  # scalar or (J,) tensor
) -> torch.Tensor:
    """x + γ(I − WᵀW)(x̄ − x) — fused, P never materialized."""
    _check_shapes(w, x, xbar)
    return _ConsensusUpdate.apply(w, x, xbar, gamma)


def project(w: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(I − WᵀW) v via the fused kernel (x = 0, γ = 1)."""
    return consensus_update(w, None, v, 1.0)
