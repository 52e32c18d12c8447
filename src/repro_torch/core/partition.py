"""Row-partitioning of the global system into per-worker blocks.

The paper's Algorithm 1 step 1: "Decompress J submatrices from A and J
subvectors from b on worker nodes". For SPMD we use uniform block sizes
(remainder rows re-mixed into consistent padding equations — see
``repro_torch.sparse.matrix.block_rows``).

``block_mode`` semantics:
  * ``"tall"`` — blocks with p >= n rows (the paper's stated regime).
  * ``"wide"`` — blocks with p < n rows (classical-APC regime; non-degenerate
    consensus). Chosen automatically from (m, n, J) when mode="auto".

The plan and the mixing are host-side numpy, exactly as in the JAX
package; the blocks land on ``device`` as tensors. ``dtype=None`` follows
the reference's x64-off default: float64 input becomes float32.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Literal

import numpy as np
import torch

from repro_torch.device import resolve_device

BlockMode = Literal["tall", "wide", "auto"]


@dataclasses.dataclass(frozen=True, eq=False)
class PartitionPlan:
    """Row→block assignment shared by the dense and blocked-ELL paths.

    A plan generalizes the uniform contiguous split to an arbitrary (possibly
    ragged) assignment of original rows to blocks. Compiled shapes stay
    static: both consumers pad every block up to ``max_rows`` — the dense
    path with consistent mixing equations (``PlanMixer``), the ELL path with
    zero rows — so a ragged plan costs padding, never a retrace per shape.

    ``assignment[i]`` is the block of original row ``i``; within a block,
    rows keep their original relative order (``slots`` is the stable rank).
    """

    m: int
    num_blocks: int
    assignment: np.ndarray  # (m,) int32 row -> block
    kind: str = "uniform"  # "uniform" | "cost_aware"

    def __post_init__(self) -> None:
        a = np.asarray(self.assignment, dtype=np.int32)
        object.__setattr__(self, "assignment", a)
        if a.shape != (self.m,):
            raise ValueError(f"assignment must be ({self.m},), got {a.shape}")
        if self.m < self.num_blocks:
            raise ValueError(
                f"need at least one row per block: m={self.m} < J={self.num_blocks}"
            )
        if a.size and (a.min() < 0 or a.max() >= self.num_blocks):
            raise ValueError("assignment out of range")
        if np.bincount(a, minlength=self.num_blocks).min() == 0:
            raise ValueError("every block needs at least one row")

    # -- derived geometry ---------------------------------------------------

    @functools.cached_property
    def counts(self) -> np.ndarray:
        """(J,) real (unpadded) row count per block."""
        return np.bincount(self.assignment, minlength=self.num_blocks)

    @property
    def max_rows(self) -> int:
        return int(self.counts.max())

    @property
    def min_rows(self) -> int:
        return int(self.counts.min())

    @property
    def imbalance(self) -> float:
        """max/min block row count — 1.0 for a perfectly even plan."""
        return self.max_rows / max(self.min_rows, 1)

    @functools.cached_property
    def slots(self) -> np.ndarray:
        """(m,) position of each row inside its block (original-order stable)."""
        starts = np.zeros(self.num_blocks, np.int64)
        starts[1:] = np.cumsum(self.counts)[:-1]
        order = np.argsort(self.assignment, kind="stable")
        s = np.empty(self.m, np.int64)
        s[order] = np.arange(self.m) - starts[self.assignment[order]]
        return s

    def flat_slots(self, p_pad: int) -> np.ndarray:
        """(m,) destination of each original row in a (J*p_pad,) flat layout."""
        return self.assignment.astype(np.int64) * int(p_pad) + self.slots

    def block_rows(self, j: int) -> np.ndarray:
        """Original row indices of block ``j`` (increasing order)."""
        return np.flatnonzero(self.assignment == j)

    def describe_block(self, j: int) -> str:
        """Human label mapping block ``j`` back to original row ranges."""
        rows = self.block_rows(j)
        lo, hi = int(rows[0]), int(rows[-1])
        span = f"rows {lo}..{hi}" if hi > lo else f"row {lo}"
        if rows.size == hi - lo + 1:  # contiguous
            return f"block {j} ({span}, {rows.size} rows)"
        return f"block {j} ({span} scattered, {rows.size} rows)"

    # -- constructors -------------------------------------------------------

    @classmethod
    def uniform(cls, m: int, num_blocks: int) -> "PartitionPlan":
        """The paper's contiguous split: row i -> block i // ceil(m/J)."""
        p = -(-m // num_blocks)
        return cls(
            m=m, num_blocks=num_blocks,
            assignment=np.arange(m, dtype=np.int64) // p,
            kind="uniform",
        )

    @classmethod
    def cost_aware(
        cls, A, num_blocks: int, max_sweeps: int = 8
    ) -> "PartitionPlan":
        """Heterogeneity-aware assignment balancing nnz load and a block
        condition proxy.

        Two phases, both deterministic host-side numpy:

        1. Rows are ordered by a spectral key (log row energy, nnz
           tie-break) and cut into J contiguous segments of balanced
           cumulative nnz. The ordering groups rows of similar magnitude
           and fill into the same block — spectrally homogeneous blocks
           keep the per-block Gram factors well conditioned (the condition
           proxy), while the nnz-balanced cuts equalize SpMV work per
           worker.
        2. Bounded steepest-descent local search over single-row boundary
           moves between adjacent segments, minimizing the sum of squared
           block loads — the whole-block generalization of the
           ``balance=True`` within-block ELL-slot descent in
           matrix-free path's blocked-ELL shards.

        ``A`` may be a ``COOMatrix`` or a dense array.
        """
        from repro_torch.sparse.matrix import COOMatrix

        coo = A if isinstance(A, COOMatrix) else COOMatrix.from_dense(
            np.asarray(A)
        )
        m = coo.shape[0]
        if m < num_blocks:
            raise ValueError(f"m={m} < num_blocks={num_blocks}")
        nnz_r = np.bincount(coo.rows, minlength=m).astype(np.int64)
        energy = np.bincount(
            coo.rows, weights=np.asarray(coo.vals, np.float64) ** 2, minlength=m
        )
        cost = np.maximum(nnz_r, 1).astype(np.float64)  # empty row = 1 slot
        key = np.log(energy + 1e-300)

        # phase 1: spectral-key order, contiguous nnz-balanced cuts
        order = np.lexsort((np.arange(m), nnz_r, key))
        csort = cost[order]
        csum = np.cumsum(csort)
        total = csum[-1]
        cuts = np.empty(num_blocks + 1, np.int64)
        cuts[0], cuts[num_blocks] = 0, m
        pos = np.searchsorted(csum, total / num_blocks * np.arange(1, num_blocks))
        for t in range(1, num_blocks):
            lo = cuts[t - 1] + 1  # ≥1 row per segment...
            hi = m - (num_blocks - t)  # ...and room for the segments after
            cuts[t] = min(max(int(pos[t - 1]) + 1, lo), hi)

        # phase 2: steepest-descent boundary moves on sum of squared loads
        loads = np.array(
            [csort[cuts[t]:cuts[t + 1]].sum() for t in range(num_blocks)]
        )
        for _ in range(max_sweeps * max(num_blocks - 1, 1)):
            best_t, best_step, best_gain = -1, 0, 0.0
            for t in range(1, num_blocks):
                c = cuts[t]
                if cuts[t + 1] - c > 1:  # row c: segment t -> t-1
                    w = csort[c]
                    gain = -2.0 * w * (loads[t - 1] - loads[t] + w)
                    if gain > best_gain:
                        best_t, best_step, best_gain = t, +1, gain
                if c - cuts[t - 1] > 1:  # row c-1: segment t-1 -> t
                    w = csort[c - 1]
                    gain = -2.0 * w * (loads[t] - loads[t - 1] + w)
                    if gain > best_gain:
                        best_t, best_step, best_gain = t, -1, gain
            if best_t < 0:
                break
            c = cuts[best_t]
            w = csort[c] if best_step > 0 else csort[c - 1]
            loads[best_t - 1] += best_step * w
            loads[best_t] -= best_step * w
            cuts[best_t] += best_step

        assignment = np.empty(m, np.int32)
        for t in range(num_blocks):
            assignment[order[cuts[t]:cuts[t + 1]]] = t
        return cls(
            m=m, num_blocks=num_blocks, assignment=assignment, kind="cost_aware"
        )


@dataclasses.dataclass(frozen=True)
class Partition:
    """Uniform row partition of a dense (or densified) system.

    ``bvecs`` holds one RHS (J, p) or a multi-RHS batch (J, p, k)."""

    blocks: torch.Tensor  # (J, p, n)
    bvecs: torch.Tensor  # (J, p) or (J, p, k)
    mode: str  # "tall" | "wide"

    @property
    def num_blocks(self) -> int:
        return self.blocks.shape[0]

    @property
    def block_rows(self) -> int:
        return self.blocks.shape[1]

    @property
    def num_cols(self) -> int:
        return self.blocks.shape[2]


def torch_dtype(dtype) -> torch.dtype:
    """A torch dtype from a torch dtype, numpy dtype/type or name."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.empty(0, np.dtype(dtype))).dtype


def to_tensor(arr: np.ndarray, dtype=None, device=None) -> torch.Tensor:
    """Host array -> tensor on ``device``. ``dtype=None`` keeps the array's
    type except float64, which becomes float32 as the x64-off reference's
    ``jnp.asarray`` does; an explicit dtype is honoured."""
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if dtype is None:
        dtype = torch.float32 if t.dtype == torch.float64 else t.dtype
    return t.to(device=resolve_device(device), dtype=torch_dtype(dtype))


def resolve_mode(
    m: int,
    n: int,
    num_blocks: int,
    mode: BlockMode,
    padded_rows: int | None = None,
) -> str:
    """Resolve/validate the tall-vs-wide block regime.

    With a ragged ``PartitionPlan`` the classification must use the
    PADDED block height (``padded_rows`` = the plan's ``max_rows``), not
    the uniform ``ceil(m/J)``: the ``PlanMixer`` pads every block up to
    the max height with consistent mixing equations drawn from ALL
    original rows, so each padded block generically has rank
    ``min(padded_rows, n)`` — a skewed plan whose tallest block exceeds n
    puts EVERY dense block in the tall (full-column-rank) regime even
    though ``ceil(m/J) < n``. Classifying by the uniform height (the old
    behavior) mislabels such plans as wide and breaks the QR shapes.
    ``padded_rows=None`` keeps the uniform-split semantics, where the
    padded height is exactly ``ceil(m/J)`` after remainder mixing.
    """
    p = -(-m // num_blocks) if padded_rows is None else int(padded_rows)
    if mode == "auto":
        return "tall" if p >= n else "wide"
    if mode == "tall" and p < n:
        raise ValueError(
            f"tall mode needs m/J >= n (paper: (m+n)/J >= n); got p={p} < n={n}"
        )
    if mode == "wide" and p >= n:
        raise ValueError(f"wide mode needs m/J < n; got p={p} >= n={n}")
    return mode


def partition_matrix(
    A: np.ndarray,
    num_blocks: int,
    mode: BlockMode = "auto",
    dtype=None,
    plan: PartitionPlan | None = None,
    device=None,
):
    """Split A alone into J row blocks; returns (blocks, mode, mixer).

    The b-independent half of Algorithm 1 step 1 — the prepare/solve API
    partitions A once here and re-applies the returned mixer to every
    incoming right-hand side (``mixer.apply(b)``) so repeated solves never
    touch A again.

    ``plan=None`` (or a uniform-kind plan) is the paper's uniform
    contiguous split. A cost-aware plan reorders rows into its blocks and
    pads each ragged block up to the plan's max height with consistent
    mixing equations. The mixing runs in numpy on the host; the blocks are
    returned as a tensor on ``device``.
    """
    from repro_torch.sparse.matrix import make_plan_mixer, make_row_mixer

    A = np.asarray(A)
    m, n = A.shape
    if plan is None or plan.kind == "uniform":
        resolved = resolve_mode(m, n, num_blocks, mode)
        mixer = make_row_mixer(m, num_blocks)
    else:
        if plan.m != m or plan.num_blocks != num_blocks:
            raise ValueError(
                f"plan is for (m={plan.m}, J={plan.num_blocks}), "
                f"got (m={m}, J={num_blocks})"
            )
        resolved = resolve_mode(
            m, n, num_blocks, mode, padded_rows=plan.max_rows
        )
        mixer = make_plan_mixer(plan)
    return to_tensor(mixer.apply(A), dtype, device), resolved, mixer


def block_rhs(mixer, b: np.ndarray, dtype=None, device=None) -> torch.Tensor:
    """Block a RHS (m,) or multi-RHS batch (m, k) with a cached mixer."""
    return to_tensor(mixer.apply(np.asarray(b)), dtype, device)


def partition_system(
    A: np.ndarray,
    b: np.ndarray,
    num_blocks: int,
    mode: BlockMode = "auto",
    dtype=None,
    device=None,
) -> Partition:
    """Split (A, b) into J uniform dense row blocks on ``device``.

    ``b`` may be one RHS (m,) or a batch (m, k) — the same mixing rows pad
    both A and every column of b, keeping each system consistent.
    """
    blocks, resolved, mixer = partition_matrix(
        A, num_blocks, mode, dtype, device=device
    )
    return Partition(blocks, block_rhs(mixer, b, dtype, device), resolved)
