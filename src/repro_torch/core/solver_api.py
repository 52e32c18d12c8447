"""Unified public solver API: ``prepare(A).solve(b)`` and ``solve(A, b)``.

``solve`` is a thin one-shot wrapper over the two-phase prepare/solve split
(``repro_torch.core.prepared``); callers that solve the same system for
many right-hand sides should hold the ``PreparedSolver`` and skip the
per-call setup entirely.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.prepared import (  # noqa: F401  (re-exported API)
    METHODS,
    ColumnResult,
    PartitionPlan,
    PrepareConfig,
    PreparedSolver,
    SolveOptions,
    SolveResult,
    prepare,
    resolve_path,
)

# parameters ``solve`` itself names and forwards to prepare explicitly
_SHARED_KWARGS = ("method", "num_blocks", "mode", "dtype", "gamma", "eta", "device")

# kwargs consumed at prepare() time; everything else forwards to the method.
# Derived from PrepareConfig, the single source of truth for prepare's
# keyword surface.
_PREPARE_KWARGS = tuple(
    name for name in PrepareConfig.field_names() if name not in _SHARED_KWARGS
)


def solve(
    A,
    b,
    method: str = "dapc",
    num_blocks: int = 8,
    num_epochs: int = 100,
    gamma: float = 1.0,
    eta: float = 0.9,
    mode: str = "auto",  # BlockMode | "dense" | "matfree"
    x_ref=None,
    dtype=None,
    device=None,
    **kwargs,
) -> SolveResult:
    """Solve the (consistent, overdetermined) system A x = b distributively.

    One-shot wrapper: runs ``prepare`` (Algorithm 1 steps 1–4) and a single
    ``solve`` (steps 5–8) back to back, so its wall_seconds includes the
    setup that the prepare/solve split amortizes away. ``b`` may be one RHS
    (m,) or a column batch (m, k). ``device=None`` runs on the card.

    ``A`` may be a host ``COOMatrix``; ``mode="matfree"`` (or ``"auto"``
    past the nnz/memory threshold) takes the matrix-free path.

    kwargs are forwarded to prepare when they name one of its fields
    (``materialize_p=False`` / ``use_kernels=True`` / ``gram_solver=`` /
    ``inner_iters=`` ...) and to the solve otherwise (``tol=``,
    ``block_history=``, ``lr=`` for dgd ...).
    """
    prep_kw = {k: kwargs.pop(k) for k in _PREPARE_KWARGS if k in kwargs}
    prep = prepare(
        A, method=method, num_blocks=num_blocks, mode=mode, dtype=dtype,
        gamma=gamma, eta=eta, device=device, **prep_kw,
    )
    res = prep.solve(b, num_epochs=num_epochs, x_ref=x_ref, **kwargs)
    # the one-shot wall time covers setup too
    return dataclasses.replace(
        res, wall_seconds=res.wall_seconds + prep.setup_seconds
    )
