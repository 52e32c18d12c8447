"""Sparse-matrix substrate (host-side numpy; a copy of the JAX package's
``sparse/matrix.py`` so the port never imports it).

``COOMatrix`` is the host-side ingest/generation/statistics format. The
**dense** path densifies each row block before QR (``row_block``, mirroring
the paper's own ``.toarray()`` in its Dask implementation). The
matrix-free blocked-ELL path is not ported yet (ROADMAP Queue 1, item 4).
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class COOMatrix:
    """Minimal COO sparse matrix (numpy-side; ingest only, never on device)."""

    rows: np.ndarray  # (nnz,) int32
    cols: np.ndarray  # (nnz,) int32
    vals: np.ndarray  # (nnz,) float
    shape: tuple[int, int]

    def __post_init__(self) -> None:
        if self.rows.shape != self.cols.shape or self.rows.shape != self.vals.shape:
            raise ValueError("rows/cols/vals must have identical shapes")
        m, n = self.shape
        if self.rows.size and (self.rows.max() >= m or self.cols.max() >= n):
            raise ValueError("index out of bounds for declared shape")
        if self.rows.size and (self.rows.min() < 0 or self.cols.min() < 0):
            # negative indices would silently scatter from the end in
            # to_dense/row_block — reject them at construction
            raise ValueError("negative indices not allowed")

    @property
    def nnz(self) -> int:
        return int(self.vals.size)

    @property
    def sparsity(self) -> float:
        m, n = self.shape
        return 100.0 * (1.0 - self.nnz / float(m * n))

    def to_dense(self) -> np.ndarray:
        out = np.zeros(self.shape, dtype=self.vals.dtype)
        out[self.rows, self.cols] = self.vals
        return out

    def row_block(self, start: int, stop: int) -> np.ndarray:
        """Densify rows [start, stop) — the dense path's per-worker decompress
        step)."""
        mask = (self.rows >= start) & (self.rows < stop)
        out = np.zeros((stop - start, self.shape[1]), dtype=self.vals.dtype)
        out[self.rows[mask] - start, self.cols[mask]] = self.vals[mask]
        return out

    def matvec(self, x: np.ndarray) -> np.ndarray:
        out = np.zeros(self.shape[0], dtype=np.result_type(self.vals, x))
        np.add.at(out, self.rows, self.vals * x[self.cols])
        return out

    @staticmethod
    def from_dense(a: np.ndarray) -> "COOMatrix":
        rows, cols = np.nonzero(a)
        return COOMatrix(
            rows.astype(np.int32), cols.astype(np.int32), a[rows, cols], a.shape
        )


@dataclasses.dataclass(frozen=True)
class RowMixer:
    """The deterministic row-padding map of ``block_rows``, reified.

    Splitting it out lets the prepare/solve API block NEW right-hand sides
    against an already-partitioned matrix: the same mixing rows ``g`` that
    padded A must pad every b (paper eq. 8 consistency), so the mixer is
    cached alongside the QR factors.
    """

    m: int  # original row count
    num_blocks: int
    p: int  # uniform block height (ceil(m / J))
    g: np.ndarray | None  # (pad, m) mixing rows; None when m divides evenly

    def apply(self, v: np.ndarray) -> np.ndarray:
        """Pad + reshape rows of ``v`` (m, ...) into blocks (J, p, ...)."""
        v = np.asarray(v)
        if v.shape[0] != self.m:
            raise ValueError(f"expected {self.m} rows, got {v.shape[0]}")
        if self.g is not None:
            v = np.concatenate([v, self.g.astype(v.dtype) @ v], axis=0)
        return v.reshape(self.num_blocks, self.p, *v.shape[1:])


def make_row_mixer(m: int, num_blocks: int) -> RowMixer:
    """Mixer for an m-row system split J ways (seeded: identical every call)."""
    p = -(-m // num_blocks)  # ceil
    pad = p * num_blocks - m
    g = None
    if pad:
        rng = np.random.default_rng(0)
        g = rng.standard_normal((pad, m)) / np.sqrt(m)
    return RowMixer(m=m, num_blocks=num_blocks, p=p, g=g)


@dataclasses.dataclass(frozen=True)
class PlanMixer:
    """Plan-aware sibling of ``RowMixer`` for ragged ``PartitionPlan``s.

    Every block is padded up to the plan's max row count with consistent
    mixing equations (random combinations of ALL original rows, the paper's
    eq. 8 augmentation — the same trick ``RowMixer`` uses for the remainder
    rows), so dense block shapes stay static and per-block QR never sees a
    rank-deficient zero row. ``gather`` scatters [original rows ; mixing
    rows] into the (J, p, ...) block layout.
    """

    m: int  # original row count
    num_blocks: int
    p: int  # padded block height (plan max_rows)
    gather: np.ndarray  # (J*p,) indices into [rows ; mixing rows]
    g: np.ndarray | None  # (pad, m) mixing rows; None when the plan is even

    def apply(self, v: np.ndarray) -> np.ndarray:
        """Permute + pad rows of ``v`` (m, ...) into blocks (J, p, ...)."""
        v = np.asarray(v)
        if v.shape[0] != self.m:
            raise ValueError(f"expected {self.m} rows, got {v.shape[0]}")
        if self.g is not None:
            v = np.concatenate([v, self.g.astype(v.dtype) @ v], axis=0)
        return v[self.gather].reshape(self.num_blocks, self.p, *v.shape[1:])


def make_plan_mixer(plan) -> PlanMixer:
    """Mixer realizing a ``repro_torch.core.partition.PartitionPlan`` (seeded:
    identical every call for the same plan)."""
    m, num_blocks = plan.m, plan.num_blocks
    p = plan.max_rows
    pad = p * num_blocks - m
    g = None
    if pad:
        rng = np.random.default_rng(0)
        g = rng.standard_normal((pad, m)) / np.sqrt(m)
    gather = np.empty(num_blocks * p, np.int64)
    # real rows at their plan slots, mixing rows filling each block's tail
    gather[plan.flat_slots(p)] = np.arange(m)
    pad_next = m
    counts = plan.counts
    for j in range(num_blocks):
        lo = j * p + int(counts[j])
        hi = (j + 1) * p
        gather[lo:hi] = np.arange(pad_next, pad_next + (hi - lo))
        pad_next += hi - lo
    return PlanMixer(m=m, num_blocks=num_blocks, p=p, gather=gather, g=g)


def block_rows(a: COOMatrix | np.ndarray, b: np.ndarray, num_blocks: int):
    """Uniform row partition into ``num_blocks`` dense blocks (J, p, n) + (J, p).

    The paper's reference implementation folds the remainder rows into the last
    block; for SPMD we need uniform blocks, so the remainder rows are re-mixed
    into extra *consistent* rows (random combinations of existing equations,
    exactly the paper's eq. 8 augmentation) to pad the final block.

    ``b`` may be a single RHS (m,) or a multi-RHS batch (m, k).
    """
    dense = a.to_dense() if isinstance(a, COOMatrix) else np.asarray(a)
    mixer = make_row_mixer(dense.shape[0], num_blocks)
    return mixer.apply(dense), mixer.apply(b)


def matrix_stats(a: COOMatrix) -> dict:
    vals = a.vals
    return {
        "shape": a.shape,
        "nnz": a.nnz,
        "sparsity_pct": a.sparsity,
        "mean": float(vals.mean()) if vals.size else 0.0,
        "std": float(vals.std()) if vals.size else 0.0,
    }
