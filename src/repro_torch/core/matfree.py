"""Matrix-free prepared solver: block projections via SpMV + inner Gram solves.

At 99%+ sparsity the dense path's factors (W_j, R_j) cost O(J·p·n) no
matter how sparse A is. Azizan-Ruhi et al. (arXiv:1708.01413) define the
block projection directly as

    P_j x = x − A_jᵀ (A_j A_jᵀ)⁻¹ A_j x

which needs only sparse products with A_j / A_jᵀ plus an inner solve of the
(p, p) Gram system. This module runs exactly that on blocked-ELL shards
(``repro_torch.sparse.bsr``). Two inner solvers share the epoch:

  * ``gram_solver="direct"`` — a per-block pseudo-inverse of the (p, p)
    Gram, precomputed once at prepare time (host float64) and applied as
    one batched matrix product per epoch;
  * ``gram_solver="pcg"`` — the Jacobi-preconditioned CG on the sparse
    blocked-ELL Gram shards, batched across all J blocks and k columns;
    one iteration is one small (p, p) SpMM.

``"auto"`` (the default) picks "direct" while the stacked inverses stay
under ``DIRECT_GRAM_BYTES`` and "pcg" beyond.

One outer epoch is a single fused pass of tile products plus the inner
Gram solve: the probe ``z_j = A_j x̄`` is carried across epochs, doubles as
the residual metric and the projection input, and is rebuilt each epoch
from x̄⁺ = KNOWN − (ηγ/J)·Σ_j A_jᵀy_j, where KNOWN needs no transpose
product — so ``PartitionedBSR.fused_project`` computes both tile products
of an epoch at once: with the kernels on the card, one launch of the fused
packed SpMM kernel over the forward and transposed packed forms (no staged
contributions, no scatter); otherwise one read of the forward ELL tiles.
The inexact PCG path also carries ``w_j = A_j x_j``, updated for free from
the CG residual.

A port of the JAX package's ``core/matfree.py``. Its ``lax.scan`` is a
Python loop that only queues device work and writes into preallocated
``(E, …)`` histories; the ``tol`` freeze is a ``torch.where`` mask (the
reference's all-frozen ``lax.cond`` shortcut gives the same numbers as the
masked update). The one host read it adds is the PCG stopping test: the
reference's ``while_loop`` stops when no active column's worst-block
residual is above ``inner_tol``, so every CG iteration reads that flag
(``host_syncs`` counts the reads). The direct Gram solver reads nothing.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.core import spectra as spectra_mod
from repro_torch.core.prepared import SolveOptions, SolveResult, _to_numpy
from repro_torch.device import resolve_device, synchronize
from repro_torch.sparse.bsr import DEFAULT_BLOCK_SHAPE, PartitionedBSR, _tensor
from repro_torch.sparse.matrix import COOMatrix

# matfree applies the SAME projection for classical and decomposed APC (the
# two differ only in how the DENSE path factorizes it)
MATFREE_METHODS = ("apc", "dapc")

GRAM_SOLVERS = ("auto", "direct", "pcg")
# auto goes direct while the stacked (J, p_pad, p_pad) Gram inverses fit
DIRECT_GRAM_BYTES = 64 * 1024 * 1024

# device-to-host reads made by the PCG stopping test in this process
host_syncs = 0


def _coldot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """⟨a, b⟩ over the row axis, kept broadcastable: (J, p, k) -> (J, 1, k)."""
    return torch.sum(a * b, dim=1, keepdim=True)


def _pcg_gram(
    op: PartitionedBSR,
    rhs: torch.Tensor,  # (J, p_pad, k)
    diag_inv: torch.Tensor,  # (J, p_pad, 1) Jacobi weights (0 on padded rows)
    iters: int,
    tol: float,
    use_kernels: bool,
    warm: torch.Tensor | None = None,  # previous epoch's solution, same shape
    active: torch.Tensor | None = None,  # (k,) bool: columns that still count
):
    """Solve (A_j A_jᵀ) Y = rhs per block and column.

    One iteration is one SMALL SpMM with the stored sparse Gram shards
    (``op.gram_mv``). The loop exits as soon as every ACTIVE column's
    worst-block relative residual drops below ``tol`` (``iters`` is the
    hard cap); that test is read on the host once per iteration, so the
    port stops at the iteration the reference stops at. ``warm`` seeds the
    iteration; ``active`` masks converged outer columns out of the test.

    Returns (Y, iters_used (k,) int32, final residual rhs − G·Y).
    """
    global host_syncs
    rhs_sq = torch.clamp(_coldot(rhs, rhs), min=1e-30)

    def not_done(r):  # (k,): columns still above tolerance (and active)
        rel = torch.amax(_coldot(r, r) / rhs_sq, dim=0)[0]
        live = rel > tol * tol
        return live if active is None else live & active

    if warm is None:
        y = torch.zeros_like(rhs)
        r = rhs
    else:
        y = warm
        r = rhs - op.gram_mv(warm, use_kernels)
    z = diag_inv * r
    p = z
    rz = _coldot(r, z)
    counts = torch.zeros(rhs.shape[-1], dtype=torch.int32, device=rhs.device)
    it = 0
    live = not_done(r)
    while it < iters:
        host_syncs += 1
        if not bool(live.any()):
            break
        ap = op.gram_mv(p, use_kernels)
        alpha = rz / torch.clamp(_coldot(p, ap), min=1e-30)
        y = y + alpha * p
        r = r - alpha * ap
        z = diag_inv * r
        rz_new = _coldot(r, z)
        beta = rz_new / torch.clamp(rz, min=1e-30)
        p = z + beta * p
        rz = rz_new
        it += 1
        live = not_done(r)
        counts += live.to(torch.int32)
    # the depth at which each column's worst block first converged; a
    # column that never entered the loop reports a true 0
    used = torch.clamp(counts + min(it, 1), max=iters)
    return y, used, r


def _gram_pinv(op: PartitionedBSR, dtype) -> torch.Tensor:
    """Per-block dense pseudo-inverse of the Gram shards, (J, p_pad, p_pad),
    on the operator's device in ``dtype``.

    Built host-side in float64 from the (near-diagonal) sparse Gram and
    restricted to the nonsingular sub-block (padding rows — and any exactly
    dependent rows — are annihilated by the pseudo-inverse). The rank
    cutoff is pinned to the TILE dtype's noise floor, not pinv's 1e-15
    default, so a rank-deficient block's float32 noise is never inverted.
    """
    J, Rp, Sg = op.gram_indices.shape
    bp = op.gram_data.shape[-2]
    idx = op.gram_indices.cpu().numpy()
    tiles = op.gram_data.cpu().numpy()
    data = tiles.astype(np.float64)
    rcond = float(np.finfo(tiles.dtype).eps) * op.p_pad
    out = np.zeros((J, op.p_pad, op.p_pad), np.float64)
    for j in range(J):
        G = np.zeros((Rp, Rp, bp, bp))
        # padding slots target block 0 with zero data: += keeps them inert
        np.add.at(G, (np.repeat(np.arange(Rp), Sg), idx[j].ravel()),
                  data[j].reshape(Rp * Sg, bp, bp))
        G = G.transpose(0, 2, 1, 3).reshape(op.p_pad, op.p_pad)
        live = np.flatnonzero(np.diag(G) > 0)
        if live.size:
            sub = np.linalg.pinv(
                G[np.ix_(live, live)], rcond=rcond, hermitian=True
            )
            out[j][np.ix_(live, live)] = sub
    return torch.from_numpy(out).to(device=op.device, dtype=dtype)


def _local_block_mean(a: torch.Tensor) -> torch.Tensor:
    """(J, n, k) block stack -> (n, k) mean; on one device J is ALL blocks."""
    return torch.mean(a, dim=0)


def _identity(a):
    return a


def consensus_epochs(
    op: PartitionedBSR,
    diag_inv: torch.Tensor,
    gram_inv: torch.Tensor | None,
    bvecs: torch.Tensor,  # (J, p_pad, k)
    gamma,  # 0-d tensor, or (J,) per-block
    eta,  # 0-d tensor, or the per-block pair ((J,), 0-d η̄)
    ref,  # (n,) | (n, k) | None
    *,
    direct: bool,
    inner_iters: int,
    inner_tol: float,
    use_kernels: bool,
    warm_start: bool,
    tol2: float | None,
    num_epochs: int,
    block_mean=_local_block_mean,
    reduce_sum=_identity,
    iters_reduce=_identity,
    mark_epoch=None,
    x0=None,  # (n, k) predicted solution, or masked pair ((n, k), (k,))
    block_history: bool = False,  # per-block residual diagnostics
):
    """The fused-projection consensus iteration over the blocks ``op`` holds:
    all J on one device, or one shard's J_loc blocks on a rank of a mesh
    (``repro_torch.core.matfree_sharded``). Three hooks are the only places
    global information enters:

      * ``block_mean`` — (J_loc, n, k) -> the GLOBAL block mean (n, k), the
        consensus average of eqs. (5)/(7); a sharded caller passes the local
        mean then one n·k all-reduce, the one collective of an epoch;
      * ``reduce_sum`` — the per-shard residual partial sums -> global (k,);
        a sharded caller without ``tol`` passes the identity and collapses
        the emitted partials after the loop instead;
      * ``iters_reduce`` — the per-shard inner-CG depths -> global (k,),
        called by the PCG path only (the direct depth is the constant 1).

    Each defaults to the single-device operation. ``mark_epoch(t)``, when
    given, is called at the start of epoch t and with ``None`` after the
    loop (the collective audit's epoch marker).

    ``gamma`` may be a ``(J,)`` vector and ``eta`` the pair ``(eta_vec (J,),
    eta_bar)``: eq. (7) becomes the η_j-weighted mean x̄⁺ = mean_j(η_j xs_j⁺)
    + (1−η̄)x̄ and the carried ``q`` holds the weighted mean. Scalar inputs
    keep the global program.

    ``block_history=True`` also emits ``history["block_residual_sq"]``
    each epoch, read off the same carried probe ``z`` (no extra tile pass).

    Returns ``(x̄ (n, k), history)`` with the history contract that
    ``MatrixFreePreparedSolver.solve`` documents.
    """
    k = bvecs.shape[-1]
    dev = bvecs.device
    ones = torch.ones(k, dtype=torch.int32, device=dev)

    per_block = isinstance(eta, tuple) or getattr(gamma, "ndim", 0) >= 1
    eta_col = eta_bar = None
    if per_block:
        eta_vec, eta_bar = eta if isinstance(eta, tuple) else (eta, eta)
        eta_col = (
            eta_vec[:, None, None]
            if getattr(eta_vec, "ndim", 0) >= 1 else eta_vec
        )
        gam = gamma[:, None, None] if getattr(gamma, "ndim", 0) >= 1 else gamma
    else:
        gam = gamma

    def mse(xbar):
        d = xbar - (ref[..., None] if ref.ndim == 1 else ref)
        return torch.mean(d * d, dim=0)

    # eqs. (2-3) matfree: min-norm x_j(0) = A_jᵀ (A_jA_jᵀ)⁻¹ b_j — or, with
    # an ``x0`` warm start, the projection of the prediction onto each
    # block's solution set: x_j(0) = x0 + A_jᵀ(A_jA_jᵀ)⁻¹(b_j − A_j x0). The
    # masked pair zeroes cold columns' shift; A_j x_j(0) = b_j − r0 holds
    # for any shift, so w0 below is unchanged.
    if x0 is not None:
        xq, mk = x0 if isinstance(x0, tuple) else (x0, None)
        if mk is not None:
            xq = torch.where(mk, xq, torch.zeros((), dtype=xq.dtype, device=dev))
        u0 = bvecs - op.matvec(xq, use_kernels)
    else:
        xq, u0 = None, bvecs
    if direct:
        y0 = torch.bmm(gram_inv, u0)
        setup_iters, r0 = ones, torch.zeros_like(bvecs)
    else:
        y0, setup_iters, r0 = _pcg_gram(
            op, u0, diag_inv, inner_iters, inner_tol, use_kernels,
        )
        setup_iters = iters_reduce(setup_iters)
    x0s = op.rmatvec(y0, use_kernels)
    if xq is not None:
        x0s = x0s + xq
    # the CG residual hands back w0 = A_j x_j(0) = G y0 (+ A_j x0) for free
    w0 = bvecs - r0
    xbar0 = block_mean(x0s)  # eq. (5)
    z0 = op.matvec(xbar0, use_kernels)  # probe of x̄_0

    def step(xs, xbar, q, w, z, ywarm, active):
        u = z - w  # A_j (x̄ − x_j)
        if direct:
            y = torch.bmm(gram_inv, u)
            used, r = ones, None
        else:
            y, used, r = _pcg_gram(
                op, u, diag_inv, inner_iters, inner_tol, use_kernels,
                warm=ywarm if warm_start else None, active=active,
            )
            used = iters_reduce(used)
        # x̄⁺ = KNOWN − (ηγ/J)·Σ_j A_jᵀy_j in exact arithmetic, and KNOWN
        # needs no transpose product — so the epoch's two tile products run
        # in ONE fused pass. The trajectory stays float-canonical: KNOWN is
        # only the fused forward operand, and the probe is patched with the
        # exact float difference x̄⁺ − KNOWN. q is the carried mean of xs.
        if per_block:
            known = q + (1.0 - eta_bar) * xbar
        else:
            known = eta * q + eta * gamma * (xbar - q) + (1.0 - eta) * xbar
        f, g = op.fused_project(known, y, use_kernels)
        xs_new = xs + gam * (xbar[None] - xs - g)  # eq. (6)
        if per_block:
            q_new = block_mean(eta_col * xs_new)
            xbar_new = q_new + (1.0 - eta_bar) * xbar  # eq. (7), weighted
        else:
            q_new = block_mean(xs_new)
            xbar_new = eta * q_new + (1.0 - eta) * xbar  # eq. (7)
        z_new = f + op.matvec(xbar_new - known, use_kernels)
        # the exact inner solve keeps the paper's A_j x_j = b_j invariant,
        # so w stays put; inexact CG drifts it by r
        w_new = w if direct else w + gam * r
        if active is not None:  # frozen columns carry through unchanged
            xs_new = torch.where(active, xs_new, xs)
            w_new = torch.where(active, w_new, w)
            z_new = torch.where(active, z_new, z)
            xbar_new = torch.where(active, xbar_new, xbar)
            q_new = torch.where(active, q_new, q)
            used = torch.where(active, used, torch.zeros_like(used))
        return (xs_new, xbar_new, q_new, w_new, z_new, y), used

    hist = {
        "residual_sq": torch.empty((num_epochs, k), dtype=bvecs.dtype, device=dev),
        "inner_iters": torch.empty((num_epochs, k), dtype=torch.int32, device=dev),
    }
    if block_history:
        hist["block_residual_sq"] = torch.empty(
            (num_epochs, bvecs.shape[0], k), dtype=bvecs.dtype, device=dev
        )
    if ref is not None:
        hist["mse"] = torch.empty((num_epochs, k), dtype=bvecs.dtype, device=dev)

    q_init = block_mean(eta_col * x0s) if per_block else xbar0
    carry = (x0s, xbar0, q_init, w0, z0, torch.zeros_like(y0))
    for t in range(num_epochs):
        if mark_epoch is not None:
            mark_epoch(t)
        # residual of the CURRENT x̄, read off the carried probe
        r_sq = (carry[4] - bvecs) ** 2
        resid = reduce_sum(torch.sum(r_sq, dim=(0, 1)))
        active = None if tol2 is None else resid > tol2
        carry, used = step(*carry, active)
        hist["residual_sq"][t] = resid
        hist["inner_iters"][t] = used
        if block_history:
            hist["block_residual_sq"][t] = torch.sum(r_sq, dim=1)
        if ref is not None:
            hist["mse"][t] = mse(carry[1])
    if mark_epoch is not None:
        mark_epoch(None)
    xbar = carry[1]
    # the probe is computed at epoch START, so emitted entry t is the
    # residual of x̄_t: entry 0 is the "initial" metric and the final x̄
    # gets one fresh probe after the loop
    rfin = op.matvec(xbar, use_kernels) - bvecs
    resid_fin = reduce_sum(torch.sum(rfin * rfin, dim=(0, 1)))
    emitted = hist["residual_sq"]
    hist["residual_sq"] = torch.cat([emitted[1:], resid_fin[None]])
    initial = {"residual_sq": emitted[0], "inner_iters": setup_iters}
    if block_history:  # same one-epoch shift as the scalar residual
        emitted_b = hist["block_residual_sq"]
        hist["block_residual_sq"] = torch.cat(
            [emitted_b[1:], torch.sum(rfin * rfin, dim=1)[None]]
        )
        initial["block_residual_sq"] = emitted_b[0]
    if ref is not None:
        initial["mse"] = mse(xbar0)
    hist["initial"] = initial
    return xbar, hist


def _np_dtype(dtype) -> np.dtype:
    """A numpy dtype from None (float32), a torch dtype, or a numpy one."""
    if dtype is None:
        return np.dtype(np.float32)
    if isinstance(dtype, torch.dtype):
        return torch.empty(0, dtype=dtype).numpy().dtype
    return np.dtype(dtype)


@dataclasses.dataclass
class MatrixFreePreparedSolver:
    """Sparse-operator counterpart of ``PreparedSolver``.

    Produced by ``prepare(A, mode="matfree")`` (or mode="auto" past the
    memory threshold); reusable across any number of ``solve`` calls, with
    the dense solver's ``solve`` contract and ``SolveResult``.
    """

    op: PartitionedBSR
    method: str
    gamma: float
    eta: float
    inner_iters: int
    inner_tol: float
    use_kernels: bool
    setup_seconds: float
    diag_inv: torch.Tensor = dataclasses.field(repr=False, default=None)
    gram_solver: str = "direct"  # resolved: "direct" | "pcg"
    gram_inv: torch.Tensor | None = dataclasses.field(repr=False, default=None)
    warm_start: bool = False
    partition: str = "uniform"  # "uniform" | "cost_aware"
    dynamics: str = "global"  # default solve dynamics: "global" | "per_block"
    plan: object | None = dataclasses.field(repr=False, default=None)
    block_gamma_weights: np.ndarray | None = dataclasses.field(repr=False, default=None)
    block_eta_weights: np.ndarray | None = dataclasses.field(repr=False, default=None)
    block_spectra: dict | None = dataclasses.field(repr=False, default=None)
    num_solves: int = 0

    path = "matfree"

    @property
    def mode(self) -> str:
        return "matfree"

    @property
    def device(self) -> torch.device:
        return self.op.device

    @property
    def num_blocks(self) -> int:
        return self.op.num_blocks

    @property
    def num_cols(self) -> int:
        return self.op.num_cols

    @property
    def block_rows(self) -> int:
        return self.op.p_pad

    @property
    def memory_bytes(self) -> int:
        """Device-resident operator bytes (the matfree 'factors')."""
        total = self.op.nbytes
        for t in (self.diag_inv, self.gram_inv):
            if t is not None:
                total += t.numel() * t.element_size()
        return int(total)

    @property
    def dense_memory_bytes(self) -> int:
        """What the dense path's (J, p, n) blocks alone would cost."""
        return self.op.dense_bytes

    def block_rhs(self, b) -> torch.Tensor:
        """RHS (m,) or (m, k) -> (J, p_pad, k) on the device, plan-aware.

        With a cost-aware ``plan`` the original-order rows scatter to their
        plan slots; without one this is exactly ``op.block_rhs``.
        """
        if self.plan is None:
            return self.op.block_rhs(b)
        b = np.asarray(b)
        if b.ndim == 1:
            b = b[:, None]
        m = self.op.shape[0]
        if b.shape[0] != m:
            raise ValueError(f"expected {m} rows, got {b.shape[0]}")
        return self.op._scatter_rhs(b, self.plan.flat_slots(self.op.p_pad))

    def _resolve_dynamics(self, dynamics: str | None) -> bool:
        """Map a solve-time ``dynamics`` override to the per-block flag."""
        dyn = self.dynamics if dynamics is None else dynamics
        if dyn not in ("global", "per_block"):
            raise ValueError(f"dynamics must be 'global'|'per_block', got {dyn!r}")
        if dyn == "per_block" and self.block_eta_weights is None:
            raise ValueError(
                "per-block dynamics need spectral weights: prepare with "
                "dynamics='per_block'"
            )
        return dyn == "per_block"

    def _dynamics_operands(self, gamma, eta, per_block: bool):
        """(γ, η) loop operands: 0-d tensors, or per-block vectors scaled by
        the prepared spectral weights (η as the (vector, mean) pair)."""
        dt, dev = self.op.fwd_data.dtype, self.device

        def tensor(v):
            return torch.as_tensor(v, dtype=dt, device=dev)

        if not per_block:
            return tensor(float(gamma)), tensor(float(eta))
        gv = np.asarray(self.block_gamma_weights, np.float64) * float(gamma)
        ev = np.asarray(self.block_eta_weights, np.float64) * float(eta)
        return tensor(gv), (tensor(ev), tensor(ev.mean()))

    def _warm_operand(self, x0, batched: bool):
        """An ``x0`` warm start in the internal batched-k shape ((n, k) even
        for a single RHS, matching ``block_rhs``), on the device."""
        if x0 is None:
            return None
        dt, dev = self.op.fwd_data.dtype, self.device
        if isinstance(x0, tuple):
            arr, mask = x0
            return (
                torch.as_tensor(np.asarray(arr), device=dev).to(dt),
                torch.as_tensor(np.asarray(mask, bool), device=dev),
            )
        arr = np.asarray(x0)
        if not batched and arr.ndim == 1:
            arr = arr[:, None]
        return torch.as_tensor(arr, device=dev).to(dt)

    def _epochs(self, bvecs, gamma_op, eta_op, ref, warm, *, tol, num_epochs,
                inner_iters, block_history, **hooks):
        """The consensus loop over this solver's blocks: ``(x̄, history)``
        on the device. ``hooks`` are ``consensus_epochs``' reduction hooks
        (a sharded solver passes its collectives)."""
        return consensus_epochs(
            self.op, self.diag_inv, self.gram_inv, bvecs, gamma_op, eta_op, ref,
            direct=self.gram_solver == "direct",
            inner_iters=inner_iters,
            inner_tol=self.inner_tol,
            use_kernels=self.use_kernels,
            warm_start=self.warm_start,
            tol2=None if tol is None else float(tol) ** 2,
            num_epochs=num_epochs,
            x0=warm,
            block_history=block_history,
            **hooks,
        )

    def solve(
        self,
        b: np.ndarray,  # (m,) single RHS or (m, k) column batch
        num_epochs: int = 100,
        gamma: float | None = None,
        eta: float | None = None,
        x_ref: np.ndarray | None = None,
        inner_iters: int | None = None,
        tol: float | None = None,
        x0: np.ndarray | tuple | None = None,
        block_history: bool = False,
        dynamics: str | None = None,
    ) -> SolveResult:
        """Consensus solve against the cached sparse operator.

        Matches the dense ``PreparedSolver.solve`` contract (batched RHS,
        per-epoch ``residual_sq``/``mse`` history, ``per_column``) and also
        records the per-column inner solve depth each epoch in
        ``history["inner_iters"]`` (the direct solver reports 1). ``tol``
        freezes a column once ``residual_sq <= tol²``; ``x0`` warm-starts
        at a predicted solution (``(n,)``/``(n, k)`` or the masked ``(x0,
        mask)`` pair); ``block_history=True`` records
        ``history["block_residual_sq"]``; ``dynamics`` overrides the
        prepared default per call. ``num_epochs`` may be a
        ``SolveOptions``. The result's ``x`` and ``history`` are numpy;
        ``wall_seconds`` is read after the device has finished.
        """
        if isinstance(num_epochs, SolveOptions):
            return self.solve(b, **num_epochs.kwargs())
        gamma = self.gamma if gamma is None else gamma
        eta = self.eta if eta is None else eta
        inner_iters = self.inner_iters if inner_iters is None else inner_iters
        per_block = self._resolve_dynamics(dynamics)
        b = np.asarray(b)
        batched = b.ndim == 2
        bvecs = self.block_rhs(b)  # (J, p_pad, k) — k=1 for a single RHS
        dt, dev = self.op.fwd_data.dtype, self.device
        ref = None if x_ref is None else torch.as_tensor(np.asarray(x_ref), device=dev).to(dt)
        warm = self._warm_operand(x0, batched)

        t0 = time.perf_counter()
        gamma_op, eta_op = self._dynamics_operands(gamma, eta, per_block)
        x, hist = self._epochs(
            bvecs, gamma_op, eta_op, ref, warm, tol=tol, num_epochs=num_epochs,
            inner_iters=int(inner_iters), block_history=bool(block_history),
        )
        synchronize(dev)
        wall = time.perf_counter() - t0
        self.num_solves += 1

        x = x.detach().cpu().numpy()
        hist = _to_numpy(hist)
        if not batched:  # collapse the internal k=1 axis like the dense path
            x = x[:, 0]
            hist = _collapse_k(hist)
        return SolveResult(
            x=x,
            method=self.method,
            mode="matfree",
            num_blocks=self.num_blocks,
            num_epochs=num_epochs,
            history=hist,
            wall_seconds=wall,
            gamma=gamma,
            eta=eta,
            num_rhs=b.shape[1] if batched else 1,
        )

    def open_session(self, **kwargs):
        """A streaming prediction-correction ``Session`` over this solver
        (``repro_torch.core.session``): each update warm-starts the
        matrix-free consensus at the stream's predicted solution."""
        from repro_torch.core.session import Session

        return Session(self, **kwargs)

    # -- checkpoint serialization -------------------------------------------

    def to_state(self) -> tuple[dict, dict]:
        """``(arrays, meta)`` in the JAX package's format: the partitioned
        ELL operator (tiles, balance permutation, Gram shards), the Jacobi
        weights, the direct path's Gram pseudo-inverses and the dynamics
        state — the whole setup cost, so ``from_state`` is a warm restore."""
        arrays, op_meta = self.op.to_arrays()
        arrays["diag_inv"] = self.diag_inv.detach().cpu().numpy()
        if self.gram_inv is not None:
            arrays["gram_inv"] = self.gram_inv.detach().cpu().numpy()
        arrays.update(spectra_mod.dynamics_arrays(self))
        meta = {
            "path": "matfree",
            "method": self.method,
            "gamma": float(self.gamma),
            "eta": float(self.eta),
            "inner_iters": int(self.inner_iters),
            "inner_tol": float(self.inner_tol),
            "use_kernels": bool(self.use_kernels),
            "setup_seconds": float(self.setup_seconds),
            "gram_solver": self.gram_solver,
            "warm_start": bool(self.warm_start),
            "op": op_meta,
            **spectra_mod.dynamics_meta(self),
        }
        return arrays, meta

    @classmethod
    def from_state(cls, arrays, meta: dict, device=None) -> "MatrixFreePreparedSolver":
        """Rebuild on ``device`` from ``to_state`` output — this package's or
        the JAX package's (same format, same operator bytes)."""
        dev = resolve_device(device)
        op = PartitionedBSR.from_arrays(arrays, meta["op"], device=dev,
                                        packed=_packs(meta["use_kernels"], dev))
        return cls._restore(op, arrays, meta, dev)

    @classmethod
    def _restore(cls, op, arrays, meta: dict, dev, blocks=slice(None), **placement):
        """The solver over ``op`` with the rest of the state from ``arrays``;
        ``blocks`` selects the per-block arrays' rows the operator holds."""

        def tensor(key):
            return _tensor(np.asarray(arrays[key])[blocks], dev)

        return cls(
            op=op,
            method=meta["method"],
            gamma=meta["gamma"],
            eta=meta["eta"],
            inner_iters=int(meta["inner_iters"]),
            inner_tol=float(meta["inner_tol"]),
            use_kernels=meta["use_kernels"],
            setup_seconds=meta["setup_seconds"],
            diag_inv=tensor("diag_inv"),
            gram_solver=meta["gram_solver"],
            gram_inv=tensor("gram_inv") if "gram_inv" in arrays else None,
            warm_start=meta["warm_start"],
            **spectra_mod.dynamics_state(arrays, meta),
            **placement,
        )


def _packs(use_kernels: bool, dev: torch.device) -> bool:
    """Whether the operator carries the packed forms: on the card, with the
    kernels (on the CPU the wrappers take the ELL plain versions)."""
    return bool(use_kernels) and dev.type == "cuda"


def _collapse_k(tree):
    """Drop a trailing k=1 axis from every history array (one RHS)."""
    if isinstance(tree, dict):
        return {key: _collapse_k(v) for key, v in tree.items()}
    return tree[..., 0] if tree.ndim and tree.shape[-1] == 1 else tree


def prepare_matfree(
    A,
    method: str = "dapc",
    num_blocks: int = 8,
    dtype=None,
    gamma: float = 1.0,
    eta: float = 0.9,
    block_shape: tuple[int, int] = DEFAULT_BLOCK_SHAPE,
    inner_iters: int | None = None,
    inner_tol: float = 1e-6,
    use_kernels: bool = False,
    balance: bool = True,
    gram_solver: str = "auto",
    warm_start: bool = False,
    mesh=None,
    block_axes: tuple[str, ...] = ("data",),
    partition: str = "uniform",
    dynamics: str = "global",
    plan=None,
    device=None,
) -> MatrixFreePreparedSolver:
    """Matfree setup: COO -> partitioned blocked-ELL + inner Gram solver, on
    ``device`` (``None`` = the card).

    ``A`` may be a ``COOMatrix`` (never densified) or a dense array.
    ``gram_solver="auto"`` precomputes the per-block Gram pseudo-inverses
    while they fit ``DIRECT_GRAM_BYTES`` and takes the Jacobi-PCG on the
    sparse Gram shards beyond; "direct"/"pcg" force a path.
    ``inner_iters=None`` resolves to min(p_pad, 32), the PCG cap.
    ``balance`` stores the ELL tiles in the slot-minimizing row order;
    ``warm_start`` seeds each epoch's inner CG with the previous epoch's
    Gram solution (PCG only). ``use_kernels`` routes every tile product
    through the hand-written SpMM kernels and stores the A_jᵀ shards they
    stream; on the card it also packs every shard stack's nonzeros once
    (``PartitionedBSR.with_packed``), which every kernel product then
    streams, the epoch's fused pass included.

    ``partition="cost_aware"`` assigns rows to blocks with
    ``PartitionPlan.cost_aware``; ``dynamics="per_block"`` estimates
    per-block Gram spectra at prepare time and defaults ``solve`` to the
    per-block (γ_j, η_j) consensus; ``plan`` injects a prebuilt plan.

    ``mesh`` (a ``DeviceMesh`` over the ranks of a process group, every rank
    calling this) returns a ``ShardedMatrixFreeSolver``: the operator is
    built in host memory and each rank keeps its contiguous J/D blocks on
    its device (``PartitionedBSR.place``); ``num_blocks`` must divide evenly
    over the devices of ``block_axes``. ``device=None`` is then the mesh's
    device on this rank.
    """
    if method not in MATFREE_METHODS:
        raise ValueError(
            f"matfree path supports the consensus methods {MATFREE_METHODS}; "
            f"got {method!r} (use the dense path for it)"
        )
    if gram_solver not in GRAM_SOLVERS:
        raise ValueError(f"gram_solver must be one of {GRAM_SOLVERS}")
    if partition not in ("uniform", "cost_aware"):
        raise ValueError(
            f"partition must be 'uniform'|'cost_aware', got {partition!r}"
        )
    if dynamics not in ("global", "per_block"):
        raise ValueError(
            f"dynamics must be 'global'|'per_block', got {dynamics!r}"
        )
    if mesh is not None:
        from repro_torch.core import matfree_sharded

        block_axes = tuple(block_axes)
        num_devices = matfree_sharded.mesh_block_devices(mesh, block_axes)
        if num_blocks % num_devices:
            raise ValueError(
                f"num_blocks={num_blocks} not divisible over the "
                f"{num_devices} devices of mesh axes {block_axes}"
            )
        dev = matfree_sharded.mesh_device(mesh, device)
    else:
        dev = resolve_device(device)
    t0 = time.perf_counter()
    coo = A if isinstance(A, COOMatrix) else COOMatrix.from_dense(np.asarray(A))
    dtype = _np_dtype(dtype)
    if plan is None and partition == "cost_aware":
        from repro_torch.core.partition import PartitionPlan

        plan = PartitionPlan.cost_aware(coo, num_blocks)
    elif plan is not None:
        partition = "uniform" if plan.kind == "uniform" else "cost_aware"
    if plan is not None and plan.kind == "uniform":
        plan = None  # uniform plans take the historical path exactly
    op = PartitionedBSR.from_coo(
        coo, num_blocks, block_shape, dtype,
        with_transpose=use_kernels,  # only the kernel path streams A_jᵀ tiles
        with_gram=True,  # the inner-solve operator (near-diagonal, few % extra)
        balance=balance,
        plan=plan,
        # a mesh's operator is built in host memory; each rank keeps its own
        device="cpu" if mesh is not None else dev,
    )
    whole = op
    if mesh is not None:
        op = op.place(mesh, block_axes, device=dev)
    if _packs(use_kernels, dev):
        op = op.with_packed()
    # relative-epsilon Jacobi clamp: padded rows stay 0, near-zero Gram
    # diagonals are bounded instead of exploding (see jacobi_weights)
    diag_inv = op.jacobi_weights()
    block_gamma_w = block_eta_w = spectra = None
    if dynamics == "per_block":
        # every rank estimates the same spectra of the whole host operator
        spectra = spectra_mod.block_spectra_matfree(whole)
        block_gamma_w, block_eta_w = spectra_mod.derive_dynamics(spectra)
    if gram_solver == "auto":
        inv_bytes = num_blocks * op.p_pad * op.p_pad * dtype.itemsize
        gram_solver = "direct" if inv_bytes <= DIRECT_GRAM_BYTES else "pcg"
    gram_inv = _gram_pinv(op, op.fwd_data.dtype) if gram_solver == "direct" else None
    if inner_iters is None:
        inner_iters = min(op.p_pad, 32)
    synchronize(dev)
    setup_seconds = time.perf_counter() - t0

    cls, placement_kw = MatrixFreePreparedSolver, {}
    if mesh is not None:
        cls = matfree_sharded.ShardedMatrixFreeSolver
        placement_kw = {"mesh": mesh, "block_axes": block_axes}
    return cls(
        op=op,
        method=method,
        gamma=gamma,
        eta=eta,
        inner_iters=int(inner_iters),
        inner_tol=float(inner_tol),
        use_kernels=use_kernels,
        setup_seconds=setup_seconds,
        diag_inv=diag_inv,
        gram_solver=gram_solver,
        gram_inv=gram_inv,
        warm_start=warm_start,
        partition=partition,
        dynamics=dynamics,
        plan=plan,
        block_gamma_weights=block_gamma_w,
        block_eta_weights=block_eta_w,
        block_spectra=spectra,
        **placement_kw,
    )
