"""Two-phase solver API: ``prepare(A) -> PreparedSolver``, then
``prepared.solve(b | B)`` — setup amortized across right-hand sides.

``prepare`` runs Algorithm 1 step 1 (partition) and the b-independent half
of 2–3 (the QR factors W_j, R_j — or pseudoinverse + dense projector for
classical APC) exactly once; every subsequent ``solve(b)`` performs only the
O(n²) substitution plus the consensus iteration.

``solve`` accepts one RHS ``(m,)`` or a column batch ``(m, k)``; the batched
form iterates all k systems at once — the projector application becomes
(J, p, n) × (J, n, k) products.

The port covers every method of the reference: the consensus methods (apc,
dapc) on the dense path and on the matrix-free path
(``repro_torch.core.matfree``, picked by ``mode``), and the dgd/cgnr
baselines on the dense path. ``mesh=`` shards the matrix-free path over the
ranks of a ``torch.distributed`` mesh (``repro_torch.core.matfree_sharded``);
dense mesh solves are ``repro_torch.core.distributed.solve_sharded``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any

import numpy as np
import torch

from repro_torch.core import apc, cg, consensus, dapc, dgd, projections
from repro_torch.core import spectra as spectra_mod
from repro_torch.core.partition import (
    BlockMode,
    Partition,
    PartitionPlan,
    block_rhs,
    partition_matrix,
)
from repro_torch.device import resolve_device, synchronize
from repro_torch.kernels.residual import ops as residual_ops
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.sparse.matrix import COOMatrix, PlanMixer, RowMixer

METHODS = ("apc", "dapc", "dgd", "cgnr")

# ``prepare(..., mode=...)`` accepts the dense block modes (tall/wide/auto)
# plus the execution-path selectors: "dense" forces the densified path,
# "matfree" the sparse-operator path, and "auto" picks from the nnz/memory
# estimate below.
MATFREE_AUTO_DENSITY = 0.01  # auto never goes matfree below 99% sparsity
MATFREE_AUTO_BYTES = 64 * 1024 * 1024  # ... or when dense blocks fit easily

@dataclasses.dataclass(frozen=True)
class PrepareConfig:
    """The single source of truth for ``prepare()``'s keyword surface.

    ``prepare(A, PrepareConfig(...))`` and ``prepare(A, method=..., ...)``
    are equivalent; the one-shot ``solve()`` derives its prepare/solve kwarg
    split from these fields. Fields mirror the reference's, plus ``device``.
    """

    method: str = "dapc"
    num_blocks: int = 8
    mode: str = "auto"  # BlockMode | "dense" | "matfree"
    dtype: Any = None
    gamma: float = 1.0
    eta: float = 0.9
    materialize_p: bool = True
    use_kernels: bool = False
    block_shape: tuple[int, int] | None = None
    inner_iters: int | None = None
    inner_tol: float = 1e-6
    matfree_threshold_bytes: int | None = None
    balance: bool = True
    gram_solver: str = "auto"
    warm_start: bool = False
    mesh: Any = None
    block_axes: tuple[str, ...] = ("data",)
    partition: str = "uniform"  # "uniform" | "cost_aware" row->block plan
    dynamics: str = "global"  # "global" | "per_block" (γ_j, η_j) dynamics
    device: Any = None  # None = "cuda"

    def kwargs(self) -> dict:
        """The equivalent ``prepare(A, **kwargs)`` keyword dict."""
        return {f.name: getattr(self, f.name) for f in dataclasses.fields(self)}

    @classmethod
    def field_names(cls) -> tuple[str, ...]:
        """Every keyword ``prepare`` consumes (the derived split's base)."""
        return tuple(f.name for f in dataclasses.fields(cls))


@dataclasses.dataclass(frozen=True)
class SolveOptions:
    """The single source of truth for ``solve()``'s keyword surface.

    ``prep.solve(b, SolveOptions(...))`` and ``prep.solve(b, num_epochs=...,
    ...)`` are equivalent (the options object is accepted positionally where
    ``num_epochs`` sits). ``None`` means "unset — use the solver's default";
    only set fields are forwarded. ``method_kwargs`` carries method-specific
    extras (``avg_every``/``compress``/``xbar0``) verbatim.
    """

    num_epochs: int = 100
    tol: float | None = None
    gamma: float | None = None
    eta: float | None = None
    x0: Any = None  # (n,) | (n, k) | (x0, mask) warm start (consensus only)
    x_ref: Any = None
    inner_iters: int | None = None  # matfree paths only
    block_history: bool | None = None  # per-block residual diagnostics
    dynamics: str | None = None  # "global" | "per_block" override (consensus)
    method_kwargs: dict = dataclasses.field(default_factory=dict)

    def kwargs(self) -> dict:
        """The equivalent ``solve(b, **kwargs)`` keyword dict (set fields
        only; ``num_epochs`` always — it is the positional slot)."""
        out: dict = {}
        for f in dataclasses.fields(self):
            if f.name == "method_kwargs":
                continue
            value = getattr(self, f.name)
            if f.name == "num_epochs" or value is not None:
                out[f.name] = value
        out.update(self.method_kwargs)
        return out

    @classmethod
    def field_names(cls) -> tuple[str, ...]:
        """Every keyword ``solve`` consumes (excludes ``method_kwargs``)."""
        return tuple(
            f.name for f in dataclasses.fields(cls) if f.name != "method_kwargs"
        )


def _density(A) -> float:
    if isinstance(A, COOMatrix):
        m, n = A.shape
        return A.nnz / float(m * n)
    A = np.asarray(A)
    return np.count_nonzero(A) / float(A.size)


def resolve_path(
    A,
    num_blocks: int,
    mode: str,
    matfree_threshold_bytes: int | None = None,
) -> str:
    """Pick "dense" vs "matfree" from the mode plus an nnz/memory estimate.

    mode="auto" goes matfree only when BOTH hold: density <= 1% and the
    dense path's resident arrays (blocks + factors, ~2 copies of (J, p, n))
    would exceed the threshold (default 64 MiB).
    """
    if mode in ("tall", "wide", "dense"):
        return "dense"
    if mode == "matfree":
        return "matfree"
    if mode != "auto":
        raise ValueError(
            f"mode must be tall/wide/auto/dense/matfree, got {mode!r}"
        )
    threshold = (
        MATFREE_AUTO_BYTES if matfree_threshold_bytes is None
        else matfree_threshold_bytes
    )
    m, n = A.shape
    p = -(-m // num_blocks)
    dense_bytes = 2 * num_blocks * p * n * 4  # blocks + factors, f32
    if _density(A) <= MATFREE_AUTO_DENSITY and dense_bytes > threshold:
        return "matfree"
    return "dense"


@dataclasses.dataclass(frozen=True)
class ColumnResult:
    """Per-column view of a batched solve."""

    index: int  # column position in the (m, k) batch
    x: np.ndarray  # (n,)
    residual_sq: float  # final ||A x − b_i||²
    iterations: int  # epochs until residual_sq <= tol² (num_epochs if never)
    converged: bool  # True iff tolerance reached within the epoch budget


@dataclasses.dataclass(frozen=True)
class SolveResult:
    """A solve's result on the host: ``x`` and ``history`` are numpy."""

    x: np.ndarray  # (n,) — or (n, k) for a batched solve
    method: str
    mode: str
    num_blocks: int
    num_epochs: int
    history: dict[str, Any]  # per-epoch metrics (mse / residual_sq)
    wall_seconds: float
    gamma: float | None = None
    eta: float | None = None
    num_rhs: int = 1

    def _last(self, h):
        v = np.asarray(h[-1])
        return float(v) if v.ndim == 0 else v

    @property
    def final_mse(self):
        h = self.history.get("mse")
        return self._last(h) if h is not None else None

    @property
    def final_residual(self):
        return self._last(self.history["residual_sq"])

    def _residual_trace(self) -> np.ndarray:
        """Per-epoch residual_sq as (num_epochs, k) — k=1 for a single RHS."""
        h = self.history.get("residual_sq")
        if h is None:
            raise ValueError(f"method {self.method!r} recorded no residual history")
        trace = np.asarray(h)
        return trace[:, None] if trace.ndim == 1 else trace

    def iterations_to_tol(self, tol: float) -> np.ndarray:
        """Per-column epochs needed to reach ``residual_sq <= tol²``;
        columns that never reach it report ``num_epochs``."""
        trace = self._residual_trace()  # (E, k)
        reached = trace <= float(tol) ** 2
        return np.where(
            reached.any(axis=0), reached.argmax(axis=0) + 1, self.num_epochs
        ).astype(np.int64)

    def per_column(self, tol: float | None = None) -> list[ColumnResult]:
        """Scatter a (possibly batched) result into per-column records.

        ``tol=None`` skips the tolerance sweep: every column reports the
        full ``num_epochs`` with ``converged`` judged against the final
        residual being finite.
        """
        x = self.x if self.x.ndim == 2 else self.x[:, None]
        trace = self._residual_trace()
        final = trace[-1]
        if tol is None:
            iters = np.full(x.shape[1], self.num_epochs, dtype=np.int64)
            conv = np.isfinite(final)
        else:
            iters = self.iterations_to_tol(tol)
            conv = iters < self.num_epochs
            conv |= final <= float(tol) ** 2  # converged exactly at the budget
        return [
            ColumnResult(
                index=i,
                x=np.asarray(x[:, i]),
                residual_sq=float(final[i]),
                iterations=int(iters[i]),
                converged=bool(conv[i]),
            )
            for i in range(x.shape[1])
        ]

    def assess_health(self, tol: float | None = None, watchdog=None):
        """Per-column NaN/stall verdict (``repro_torch.core.guard``).

        Host-side only: reads the residual history this result already
        carries, so guarded and unguarded solves are bit-identical.
        """
        from repro_torch.core.guard import assess

        return assess(self, tol=tol, watchdog=watchdog)


def _to_numpy(tree):
    """Tensors of a (nested) history dict -> numpy arrays."""
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    return tree.detach().cpu().numpy()


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in _leaves(v)]
    return [tree]


# the solver's counters: bumped once per solve, on the host, after the fetch
SOLVER_COUNTERS = {
    "solver_solves_total": "PreparedSolver.solve calls completed",
    "solver_epochs_total":
        "epochs run: a tol solve ends at the poll that finds every column frozen, else at the cap",
    "solver_column_epochs_total": "epochs run x columns, bucket padding included",
    "solver_active_column_epochs_total":
        "column-epochs not frozen by tol: the run_consensus mask, from the fetched history",
    "solver_early_stops_total": "solves that ended before the cap: every column frozen by tol",
    "solver_host_syncs_total":
        "calls that block the host on the device: each blocking copy in or out, the "
        "synchronize (not the tol polls, nor the waits that cap the host's lead: "
        "solver_lead_waits_total)",
    "solver_copy_bytes_total":
        "bytes copied between host and device, by direction (the tol polls' flags included)",
    "solver_lead_waits_total":
        "waits on a tol poll whose copy had not landed, to keep the host within "
        "consensus.MAX_LEAD epochs of the card (not in solver_host_syncs_total)",
    "solver_overrun_epochs_total":
        "epochs a tol solve ran after its last column froze (0 at the cap or without tol)",
}


def active_epochs(history: dict, num_epochs: int, k: int, tol) -> np.ndarray:
    """Per column, the epochs the ``tol`` mask let run: column c is active
    in epoch t iff the residual it started t from (epoch t − 1's, or the
    initial one) is above tol², compared in the history's dtype as
    ``run_consensus`` compares it. Without ``tol`` every one is. A frozen
    column stays frozen, so this is also the epoch it froze at: the first
    whose residual is at or below tol² (``num_epochs`` where none is)."""
    if tol is None:
        return np.full(k, num_epochs)
    r = np.asarray(history["residual_sq"]).reshape(num_epochs, -1)
    r0 = np.asarray(history["initial"]["residual_sq"]).reshape(1, -1)
    start = np.concatenate([r0, r[:-1]], axis=0)
    return np.count_nonzero(start > start.dtype.type(float(tol) * float(tol)), axis=0)


def count_solve(*, epochs: int, cap: int, k: int, active: np.ndarray, moved_in, moved_out,
                poll_bytes: int = 0, lead_waits: int = 0) -> None:
    """Bump the solver's counters in ``repro_torch.obs.metrics.REGISTRY``
    for one solve that ran ``epochs`` of its ``cap``, let column c run
    ``active[c]`` of them (``active_epochs``), copied the tensors
    ``moved_in`` to the device and ``moved_out`` back, each in one blocking
    call, synchronized once, copied ``poll_bytes`` of ``tol`` polls back
    without blocking and waited ``lead_waits`` times for one to land.
    Counted from the shapes: on a CPU device the same blocking calls are
    counted, although they cross nothing (its polls read the flag in place
    and copy nothing)."""
    registry = obs_metrics.REGISTRY
    c = {name: registry.counter(name, help) for name, help in SOLVER_COUNTERS.items()}
    c["solver_solves_total"].inc()
    c["solver_epochs_total"].inc(epochs)
    c["solver_column_epochs_total"].inc(epochs * k)
    c["solver_active_column_epochs_total"].inc(int(np.sum(active)))
    c["solver_early_stops_total"].inc(int(epochs < cap))
    # the last column's freeze epoch is the most epochs any column ran; a
    # solve that reached the cap has a column that never froze, or no tol
    c["solver_overrun_epochs_total"].inc(epochs - int(np.max(active)) if epochs < cap else 0)
    c["solver_lead_waits_total"].inc(lead_waits)
    c["solver_host_syncs_total"].inc(len(moved_in) + 1 + len(moved_out))
    copies = c["solver_copy_bytes_total"]
    copies.labels(direction="h2d").inc(sum(t.numel() * t.element_size() for t in moved_in))
    copies.labels(direction="d2h").inc(
        sum(t.numel() * t.element_size() for t in moved_out) + poll_bytes)


@dataclasses.dataclass
class PreparedSolver:
    """Partition + per-block factors + projector, cached on one device.

    Produced by ``prepare``; reusable (and read-only) across any number of
    ``solve`` calls. ``num_solves`` counts them. ``tracer`` (a
    ``repro_torch.obs.Tracer``, or None) records each solve's phases; the
    solver's counters go to ``repro_torch.obs.metrics.REGISTRY``.
    """

    blocks: torch.Tensor  # (J, p, n)
    mode: str
    mixer: Any  # RowMixer: blocks new b's with the same padding rows as A
    method: str
    gamma: float
    eta: float
    materialize_p: bool
    use_kernels: bool
    factors: tuple  # method-specific cached setup (see prepare())
    projector: tuple  # ("dense"|"implicit"|"kernels", operand tensor) or ()
    setup_seconds: float
    partition: str = "uniform"
    dynamics: str = "global"
    plan: Any = dataclasses.field(default=None, repr=False)  # PartitionPlan
    block_gamma_weights: Any = dataclasses.field(default=None, repr=False)
    block_eta_weights: Any = dataclasses.field(default=None, repr=False)
    block_spectra: Any = dataclasses.field(default=None, repr=False)
    num_solves: int = 0
    tracer: Any = dataclasses.field(default=None, repr=False, compare=False)

    path = "dense"

    @property
    def device(self) -> torch.device:
        return self.blocks.device

    @property
    def num_blocks(self) -> int:
        return self.blocks.shape[0]

    @property
    def num_cols(self) -> int:
        return self.blocks.shape[2]

    @property
    def memory_bytes(self) -> int:
        """Device-resident bytes of the cached state (blocks + factors +
        projector), deduplicated by storage address."""
        tensors = [self.blocks, *self.factors]
        if self.projector:
            tensors.append(self.projector[1])
        seen: set[int] = set()
        total = 0
        for t in tensors:
            if isinstance(t, torch.Tensor) and t.data_ptr() not in seen:
                seen.add(t.data_ptr())
                total += t.numel() * t.element_size()
        return total

    def _resolve_dynamics(self, dynamics: str | None) -> bool:
        """Resolve a solve-time ``dynamics`` override against the prepared
        state; returns True when the solve runs per-block (γ_j, η_j)."""
        mode = self.dynamics if dynamics is None else dynamics
        if mode not in ("global", "per_block"):
            raise ValueError(
                f"dynamics must be 'global' or 'per_block', got {mode!r}"
            )
        if mode == "global":
            return False
        if self.block_eta_weights is None:
            raise ValueError(
                "dynamics='per_block' needs per-block spectra — prepare "
                "with dynamics='per_block' to estimate them"
            )
        return True

    def _dynamics_operands(self, gamma, eta, per_block: bool):
        """(γ, η) device operands: 0-d tensors, or mean-preserving per-block
        vectors scaled by the prepared spectral weights."""
        dt, dev = self.blocks.dtype, self.device
        if not per_block:
            return (
                torch.tensor(float(gamma), dtype=dt, device=dev),
                torch.tensor(float(eta), dtype=dt, device=dev),
            )
        gv = np.asarray(self.block_gamma_weights, np.float64) * float(gamma)
        ev = np.asarray(self.block_eta_weights, np.float64) * float(eta)
        return (
            torch.as_tensor(gv, dtype=dt, device=dev),
            torch.as_tensor(ev, dtype=dt, device=dev),
        )

    def _solve_phase(self, bvecs, gamma, eta, num_epochs, ref, xbar0, x0, kwargs,
                     phase=obs_trace.untraced, stats=None):
        """Substitution + consensus for the apc/dapc methods.

        ``x0`` warm start: the per-block initial solutions become the
        projection of the prediction onto each block's solution set,
        x_j(0) = x0 + A_j⁺(b_j − A_j x0) — the substitution is linear in its
        RHS, so this reuses the cached factors on the shifted residual. The
        masked form (x0, mask) zeroes cold columns' shift. ``phase`` records
        the substitution (``solver.init``) and the loop (``solver.epochs``);
        ``stats`` receives the loop's epochs run, poll bytes and lead waits.
        """
        with phase("solver.init"):
            if x0 is not None:
                xq, mk = x0 if isinstance(x0, tuple) else (x0, None)
                if mk is not None:
                    xq = torch.where(mk, xq, torch.zeros((), dtype=xq.dtype, device=xq.device))
                bv_eff = bvecs - self.blocks @ xq
            else:
                xq, bv_eff = None, bvecs
            if self.method == "dapc":
                Ws, Rs = self.factors
                x0s = dapc.initial_from_factors(Ws, Rs, bv_eff, self.mode, self.use_kernels)
            else:
                x0s = apc.initial_from_pinv(self.factors[0], bv_eff)
            if xq is not None:
                x0s = x0s + xq
        kind, operand = self.projector
        if kind == "dense":
            apply_fn = apc.make_apply(operand)
        else:
            apply_fn = dapc.make_apply(operand, False, use_kernels=kind == "kernels")
        residual_fn = residual_ops.residual_sq if self.use_kernels else consensus.block_residual_sq
        k = bvecs.shape[2] if bvecs.ndim == 3 else 1
        with phase("solver.epochs", epochs=num_epochs, k=k, tol=kwargs.get("tol")):
            return consensus.run_consensus(
                x0s, apply_fn, gamma, eta, num_epochs,
                x_ref=ref, blocks=self.blocks, bvecs=bvecs, xbar0=xbar0, **kwargs,
                stats=stats, residual_fn=residual_fn,
            )

    def _operand(self, arr):
        """A host array (or tensor) as a tensor in the solver's dtype/device."""
        return torch.as_tensor(np.asarray(arr)).to(device=self.device, dtype=self.blocks.dtype)

    def solve(
        self,
        b: np.ndarray,  # (m,) single RHS or (m, k) column batch
        num_epochs: int = 100,
        gamma: float | None = None,
        eta: float | None = None,
        x_ref: np.ndarray | None = None,
        x0: np.ndarray | tuple | None = None,
        dynamics: str | None = None,
        **kwargs,
    ) -> SolveResult:
        """Solve A x = b against the cached factors (Algorithm 1 steps 5–8
        plus the per-b substitution); never re-partitions or re-factorizes.

        ``x0`` (consensus methods only) warm-starts the whole consensus
        state at a predicted solution (``(n,)`` / ``(n, k)``, or the masked
        pair ``(x0, mask)``). kwargs are forwarded to the method:
        ``avg_every``/``compress``/``xbar0``/``tol``/``block_history`` to
        ``run_consensus``, ``tol`` to cgnr (which does not read it, as in
        the reference), ``lr`` to dgd. ``dynamics`` overrides the prepared
        default per solve. ``num_epochs`` may be a ``SolveOptions``.

        The right-hand side moves to the device once per solve. The result's
        ``x`` and ``history`` are numpy; ``wall_seconds`` is read after the
        device has finished.

        With a tracer attached, or while ``torch.profiler`` records, the
        solve records ``solver.solve`` and its phases ``solver.rhs`` (host
        mixing, the copies in), ``solver.init`` (the substitution),
        ``solver.epochs`` (the loop, queued without a host sync; under
        ``tol`` it ends once a poll finds every column frozen, and waits
        for a poll only to keep within ``consensus.MAX_LEAD`` epochs),
        ``solver.wait`` and ``solver.fetch`` (the copies out). After the
        fetch it bumps the ``SOLVER_COUNTERS`` once, on the host.
        """
        if isinstance(num_epochs, SolveOptions):
            return self.solve(b, **num_epochs.kwargs())
        b = np.asarray(b)
        k = b.shape[1] if b.ndim == 2 else 1
        phase = obs_trace.recorder(self.tracer)  # decided once per solve
        with phase("solver.solve", method=self.method, k=k, epochs=num_epochs):
            gamma = self.gamma if gamma is None else gamma
            eta = self.eta if eta is None else eta
            per_block = self._resolve_dynamics(dynamics)
            dev, dt = self.device, self.blocks.dtype
            consensus_method = self.method in ("apc", "dapc")
            if x0 is not None and not consensus_method:
                raise ValueError(
                    f"x0 warm start needs a consensus method (apc/dapc); "
                    f"this solver runs {self.method!r}"
                )
            tol = kwargs.get("tol")
            with phase("solver.rhs"):
                bvecs = block_rhs(self.mixer, b, dt, dev)
                ref = None if x_ref is None else self._operand(x_ref)
                moved_in = [bvecs] + ([] if ref is None else [ref])
                t0 = time.perf_counter()
                if consensus_method:
                    xbar0 = kwargs.pop("xbar0", None)
                    if xbar0 is not None:
                        xbar0 = self._operand(xbar0)
                        moved_in.append(xbar0)
                    warm = None
                    if isinstance(x0, tuple):
                        arr, mask = x0
                        warm = (self._operand(arr),
                                torch.as_tensor(np.asarray(mask, bool), device=dev))
                        moved_in += list(warm)
                    elif x0 is not None:
                        warm = self._operand(x0)
                        moved_in.append(warm)
                    gamma_op, eta_op = self._dynamics_operands(gamma, eta, per_block)
                    moved_in += [gamma_op, eta_op]
            stats = {"epochs": num_epochs, "poll_bytes": 0, "lead_waits": 0}
            if consensus_method:
                x, hist = self._solve_phase(
                    bvecs, gamma_op, eta_op, num_epochs, ref, xbar0, warm, kwargs, phase,
                    stats,
                )
            else:
                with phase("solver.epochs", epochs=num_epochs, k=k, tol=tol):
                    part = Partition(self.blocks, bvecs, self.mode)
                    if self.method == "cgnr":
                        x, hist = cg.solve_cgnr(part, num_epochs=num_epochs, x_ref=ref, **kwargs)
                    else:  # dgd
                        kwargs.setdefault("lr", self.factors[0])
                        x, hist = dgd.solve_dgd(part, num_epochs=num_epochs, x_ref=ref, **kwargs)
            with phase("solver.wait"):
                synchronize(dev)
            wall = time.perf_counter() - t0
            self.num_solves += 1
            with phase("solver.fetch"):
                x_host = x.detach().cpu().numpy()
                history = _to_numpy(hist)
            count_solve(
                epochs=stats["epochs"], cap=num_epochs, k=k,
                active=active_epochs(
                    history, num_epochs, k, tol if consensus_method else None),
                moved_in=moved_in, moved_out=[x] + _leaves(hist),
                poll_bytes=stats["poll_bytes"], lead_waits=stats["lead_waits"],
            )
            return SolveResult(
                x=x_host,
                method=self.method,
                mode=self.mode,
                num_blocks=self.num_blocks,
                num_epochs=num_epochs,
                history=history,
                wall_seconds=wall,
                gamma=gamma if consensus_method else None,
                eta=eta if consensus_method else None,
                num_rhs=k,
            )

    def open_session(self, **kwargs):
        """Open a streaming prediction-correction ``Session`` over this
        solver: each ``session.update(b_t)`` predicts the drifted solution
        from the stream history and corrects with a warm-started consensus
        solve (``repro_torch.core.session``). Consensus methods only."""
        from repro_torch.core.session import Session

        return Session(self, **kwargs)

    # -- checkpoint serialization -------------------------------------------

    def to_state(self) -> tuple[dict, dict]:
        """Everything needed to rebuild this solver without re-factorizing:
        ``(arrays, meta)`` with plain numpy arrays and JSON-able metadata, in
        the reference package's format. When the projector operand aliases
        a factor (implicit/kernels dapc, classical apc) only the reference
        is recorded, never a second copy."""
        arrays: dict = {"blocks": self.blocks.detach().cpu().numpy()}
        factors_meta: list[dict] = []
        for i, f in enumerate(self.factors):
            if isinstance(f, torch.Tensor):
                arrays[f"factor_{i}"] = f.detach().cpu().numpy()
                factors_meta.append({"kind": "array", "key": f"factor_{i}"})
            else:  # dgd's step size
                factors_meta.append({"kind": "scalar", "value": float(f)})
        projector_meta = None
        if self.projector:
            kind, operand = self.projector
            ref = next(
                (i for i, f in enumerate(self.factors) if f is operand), None
            )
            if ref is None:
                arrays["projector"] = operand.detach().cpu().numpy()
                projector_meta = {"kind": kind, "key": "projector"}
            else:
                projector_meta = {"kind": kind, "factor": ref}
        if self.mixer.g is not None:
            arrays["mixer_g"] = np.asarray(self.mixer.g)
        mixer_meta = {
            "m": int(self.mixer.m),
            "num_blocks": int(self.mixer.num_blocks),
            "p": int(self.mixer.p),
            "kind": "uniform",
        }
        if isinstance(self.mixer, PlanMixer):
            mixer_meta["kind"] = "plan"
            arrays["mixer_gather"] = np.asarray(self.mixer.gather)
        arrays.update(spectra_mod.dynamics_arrays(self))
        meta = {
            "path": "dense",
            "method": self.method,
            "mode": self.mode,
            "gamma": float(self.gamma),
            "eta": float(self.eta),
            "materialize_p": bool(self.materialize_p),
            "use_kernels": bool(self.use_kernels),
            "setup_seconds": float(self.setup_seconds),
            "mixer": mixer_meta,
            "factors": factors_meta,
            "projector": projector_meta,
            **spectra_mod.dynamics_meta(self),
        }
        return arrays, meta

    @classmethod
    def from_state(cls, arrays, meta: dict, device=None) -> "PreparedSolver":
        """Rebuild a solver on ``device`` from ``to_state`` output — this
        package's or the JAX reference's (same format). Arrays keep their
        dtype; a projector that aliases a factor stays one tensor."""
        dev = resolve_device(device)
        if meta.get("path", "dense") != "dense":
            raise ValueError(
                f"this state is of a {meta['path']!r} (matrix-free) solver: "
                "restore it with MatrixFreePreparedSolver.from_state "
                "(repro_torch.core.matfree)"
            )
        def tensor(key):  # a read-only or strided array is copied first
            return torch.from_numpy(np.require(arrays[key], requirements="CW")).to(dev)

        factors = tuple(
            tensor(spec["key"]) if spec["kind"] == "array" else spec["value"]
            for spec in meta["factors"]
        )
        projector: tuple = ()
        spec = meta["projector"]
        if spec is not None:
            operand = (
                factors[spec["factor"]] if "factor" in spec else tensor(spec["key"])
            )
            projector = (spec["kind"], operand)
        mx = meta["mixer"]
        g = np.asarray(arrays["mixer_g"]) if "mixer_g" in arrays else None
        if mx.get("kind", "uniform") == "plan":
            mixer: Any = PlanMixer(
                m=int(mx["m"]), num_blocks=int(mx["num_blocks"]),
                p=int(mx["p"]), gather=np.asarray(arrays["mixer_gather"]),
                g=g,
            )
        else:
            mixer = RowMixer(
                m=int(mx["m"]), num_blocks=int(mx["num_blocks"]),
                p=int(mx["p"]), g=g,
            )
        return cls(
            blocks=tensor("blocks"),
            mode=meta["mode"],
            mixer=mixer,
            method=meta["method"],
            gamma=meta["gamma"],
            eta=meta["eta"],
            materialize_p=meta["materialize_p"],
            use_kernels=meta["use_kernels"],
            factors=factors,
            projector=projector,
            setup_seconds=meta["setup_seconds"],
            **spectra_mod.dynamics_state(arrays, meta),
        )


def prepare(
    A,  # dense (m, n) array or host COOMatrix
    method: str | PrepareConfig = "dapc",
    num_blocks: int = 8,
    mode: str = "auto",  # BlockMode | "dense" | "matfree"
    dtype=None,
    gamma: float = 1.0,
    eta: float = 0.9,
    materialize_p: bool = True,
    use_kernels: bool = False,
    block_shape: tuple[int, int] | None = None,
    inner_iters: int | None = None,
    inner_tol: float = 1e-6,
    matfree_threshold_bytes: int | None = None,
    balance: bool = True,
    gram_solver: str = "auto",
    warm_start: bool = False,
    mesh=None,
    block_axes: tuple[str, ...] = ("data",),
    partition: str = "uniform",
    dynamics: str = "global",
    device=None,
    tracer=None,
) -> PreparedSolver:  # | repro_torch.core.matfree.MatrixFreePreparedSolver
    """Algorithm 1 steps 1–4, b-independent: partition A, factorize every
    block, build the projector. Returns the reusable solver on ``device``
    (``None`` = the card; ``"cpu"`` must be asked for).

    ``method`` may be a ``PrepareConfig``. ``dtype=None`` gives float32
    blocks and factors, as the x64-off reference does; an explicit dtype is
    honoured.

    ``mode`` selects the execution path on top of the block regime:
    tall/wide/auto keep their dense-path meaning; ``"dense"`` forces the
    densified path; ``"matfree"`` returns a ``MatrixFreePreparedSolver``
    (blocked-ELL operator + fused projection epochs, never densifying a
    block); ``"auto"`` also picks matfree when ``resolve_path`` says the
    dense blocks would not pay off, except for dgd/cgnr, which stay dense.
    ``block_shape``/``inner_iters``/``inner_tol``/``balance``/
    ``gram_solver``/``warm_start`` apply to the matrix-free path only (see
    ``repro_torch.core.matfree.prepare_matfree``).

    Cached per method (dense path):
      * dapc — (W_j, R_j) reduced-QR factors (paper eqs. 1/4);
      * apc  — (A_j⁺, P_j) pseudoinverse + dense projector;
      * dgd  — the 1/λ_max(AᵀA) step size (power iteration), a float;
      * cgnr — nothing beyond the partition (zero-setup baseline).
    ``mesh=`` (a ``DeviceMesh``; every rank of it calls ``prepare``) returns
    the sharded matrix-free solver and requires the matrix-free path: a
    prepare that resolves the dense path raises ``ValueError``.

    ``tracer`` (a ``repro_torch.obs.Tracer``) records the dense prepare's
    phases under ``solver.prepare`` — ``solver.partition`` (host mixing and
    the copy in), ``solver.qr``, ``solver.projector`` (a materialized P
    only), ``solver.spectra`` (per-block dynamics only), ``solver.prepare_wait``
    — and stays on the solver for its solves, whose counters go to
    ``repro_torch.obs.metrics.REGISTRY``. The matrix-free path records
    neither.
    """
    if isinstance(method, PrepareConfig):
        return prepare(A, **method.kwargs(), tracer=tracer)
    if method not in METHODS:
        raise ValueError(f"method must be one of {METHODS}")
    path = resolve_path(A, num_blocks, mode, matfree_threshold_bytes)
    if path == "matfree" and method not in ("apc", "dapc"):
        if mode != "auto":
            raise ValueError(
                f"mode='matfree' supports the consensus methods "
                f"('apc', 'dapc'); got method={method!r} — use one of "
                "those, or mode='dense'/'auto' for this method"
            )
        path = "dense"  # auto must not turn a dgd/cgnr solve into an error
    if partition not in ("uniform", "cost_aware"):
        raise ValueError(
            f"partition must be 'uniform' or 'cost_aware', got {partition!r}"
        )
    if dynamics not in ("global", "per_block"):
        raise ValueError(
            f"dynamics must be 'global' or 'per_block', got {dynamics!r}"
        )
    if mesh is not None and path != "matfree":
        raise ValueError(
            "mesh= shards the matrix-free path; this prepare resolved "
            f"path={path!r} (use mode='matfree', or solve_sharded for "
            "dense mesh solves)"
        )
    # a mesh's ranks each compute on the mesh's device (prepare_matfree)
    dev = device if mesh is not None else resolve_device(device)
    plan = (
        PartitionPlan.cost_aware(A, num_blocks)
        if partition == "cost_aware" else None
    )
    if path == "matfree":
        from repro_torch.core import matfree  # deferred: matfree imports SolveResult

        kw = {} if block_shape is None else {"block_shape": tuple(block_shape)}
        return matfree.prepare_matfree(
            A, method=method, num_blocks=num_blocks, dtype=dtype,
            gamma=gamma, eta=eta, inner_iters=inner_iters,
            inner_tol=inner_tol, use_kernels=use_kernels, balance=balance,
            gram_solver=gram_solver, warm_start=warm_start,
            mesh=mesh, block_axes=block_axes,
            partition=partition, dynamics=dynamics, plan=plan,
            device=dev, **kw,
        )
    if isinstance(A, COOMatrix):
        A = A.to_dense()  # the dense path's per-block decompress, up front
    block_mode: BlockMode = mode if mode in ("tall", "wide") else "auto"
    phase = obs_trace.recorder(tracer)  # decided once per prepare
    t0 = time.perf_counter()
    with phase("solver.prepare", method=method, num_blocks=num_blocks):
        with phase("solver.partition"):
            blocks, resolved, mixer = partition_matrix(
                A, num_blocks, block_mode, dtype, plan=plan, device=dev
            )

        factors: tuple = ()
        projector: tuple = ()
        if method == "dapc":
            with phase("solver.qr"):
                Ws, Rs = dapc.qr_blocks(blocks, resolved)
            factors = (Ws, Rs)
            if materialize_p:
                # paper-faithful dense P_j, built ONCE here (not per solve)
                with phase("solver.projector"):
                    projector = ("dense", projections.materialize(Ws))
            elif use_kernels:
                projector = ("kernels", Ws)
            else:
                projector = ("implicit", Ws)
        elif method == "apc":
            pinvs, Ps = apc.classical_factors(blocks, resolved)
            factors = (pinvs, Ps)
            projector = ("dense", Ps)
        elif method == "dgd":
            factors = (float(dgd.estimate_lipschitz(blocks)) ** -1,)
        block_gamma_w = block_eta_w = spectra_d = None
        if dynamics == "per_block":
            with phase("solver.spectra"):
                spectra_d = spectra_mod.block_spectra_dense(
                    blocks.detach().cpu().numpy(), plan=plan
                )
                block_gamma_w, block_eta_w = spectra_mod.derive_dynamics(spectra_d)
        with phase("solver.prepare_wait"):
            synchronize(dev)
    setup_seconds = time.perf_counter() - t0

    return PreparedSolver(
        blocks=blocks,
        mode=resolved,
        mixer=mixer,
        method=method,
        gamma=gamma,
        eta=eta,
        materialize_p=materialize_p,
        use_kernels=use_kernels,
        factors=factors,
        projector=projector,
        setup_seconds=setup_seconds,
        partition=partition,
        dynamics=dynamics,
        plan=plan,
        block_gamma_weights=block_gamma_w,
        block_eta_weights=block_eta_w,
        block_spectra=spectra_d,
        tracer=tracer,
    )
