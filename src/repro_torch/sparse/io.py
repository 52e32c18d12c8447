"""Problem generation + IO.

The paper evaluates on Schenk_IBMNA matrices (SuiteSparse ``c-*`` family:
square, symmetric-patterned, ~99.85% sparse, values with small mean and large
std). Those datasets are not available offline, so ``generate_schenk_like``
synthesizes matrices with matching shape/sparsity/value statistics, and
``augment_system`` implements the paper's eq. (8): augmenting a square system
``A x = b`` with rows that are linear combinations of existing equations, so
the augmented overdetermined system stays consistent with the same ``x``.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.sparse.matrix import COOMatrix


@dataclasses.dataclass(frozen=True)
class Problem:
    """A consistent (possibly augmented) least-squares problem."""

    A: np.ndarray  # (m, n) dense
    b: np.ndarray  # (m,)
    x_true: np.ndarray  # (n,)
    coo: COOMatrix  # sparse view of the square core

    @property
    def shape(self) -> tuple[int, int]:
        return self.A.shape


def generate_schenk_like(
    n: int,
    sparsity: float = 0.9985,
    mean: float = 0.013,
    std: float = 24.31,
    seed: int = 0,
    cond_boost: float = 1.0,
) -> COOMatrix:
    """Square full-rank sparse matrix with Schenk_IBMNA-like statistics.

    A diagonal ridge guarantees full rank (the paper requires each partition
    full-rank); off-diagonal entries are sampled to match the target
    mean/std/sparsity.
    """
    rng = np.random.default_rng(seed)
    nnz_target = int(round((1.0 - sparsity) * n * n))
    nnz_off = max(nnz_target - n, 0)
    rows = rng.integers(0, n, size=nnz_off).astype(np.int32)
    cols = rng.integers(0, n, size=nnz_off).astype(np.int32)
    vals = rng.normal(mean, std, size=nnz_off)
    # diagonal ridge for guaranteed invertibility (scaled to the value std)
    drows = np.arange(n, dtype=np.int32)
    dvals = (std * cond_boost) * (1.0 + rng.random(n))
    dvals *= rng.choice([-1.0, 1.0], size=n)
    rows = np.concatenate([rows, drows])
    cols = np.concatenate([cols, drows])
    vals = np.concatenate([vals, dvals])
    # dedupe (rng may hit the diagonal); later entries win via lexsort keep-last
    order = np.lexsort((cols, rows))
    rows, cols, vals = rows[order], cols[order], vals[order]
    key = rows.astype(np.int64) * n + cols
    keep = np.ones(key.size, dtype=bool)
    keep[:-1] = key[1:] != key[:-1]
    return COOMatrix(rows[keep], cols[keep], vals[keep], (n, n))


def augment_system(
    A: np.ndarray, b: np.ndarray, m_total: int, seed: int = 1
) -> tuple[np.ndarray, np.ndarray]:
    """Paper eq. (8): stack [A; D_A] x = [b; D_b] with D_A = G A, D_b = G b."""
    n = A.shape[0]
    extra = m_total - n
    if extra < 0:
        raise ValueError("m_total must be >= n")
    rng = np.random.default_rng(seed)
    G = rng.standard_normal((extra, n)) / np.sqrt(n)
    return np.concatenate([A, G @ A]), np.concatenate([b, G @ b])


def make_problem(
    n: int,
    m: int | None = None,
    sparsity: float = 0.9985,
    seed: int = 0,
    dtype=np.float64,
) -> Problem:
    """Full pipeline: sparse square core -> true solution -> augmented system."""
    coo = generate_schenk_like(n, sparsity=sparsity, seed=seed)
    A_sq = coo.to_dense().astype(dtype)
    rng = np.random.default_rng(seed + 7)
    x_true = rng.standard_normal(n).astype(dtype)
    b_sq = A_sq @ x_true
    if m is None or m == n:
        return Problem(A_sq, b_sq, x_true, coo)
    A, b = augment_system(A_sq, b_sq, m, seed=seed + 13)
    return Problem(A.astype(dtype), b.astype(dtype), x_true, coo)


def save_matrix_market(path: str, a: COOMatrix) -> None:
    """MatrixMarket coordinate writer (no scipy dependency in the hot path)."""
    m, n = a.shape
    with open(path, "w") as f:
        f.write("%%MatrixMarket matrix coordinate real general\n")
        f.write(f"{m} {n} {a.nnz}\n")
        for r, c, v in zip(a.rows, a.cols, a.vals):
            # float(): numpy 2's repr of a scalar is "np.float64(...)"
            f.write(f"{r + 1} {c + 1} {float(v)!r}\n")


def load_matrix_market(path: str) -> COOMatrix:
    with open(path) as f:
        header = f.readline()
        if "coordinate" not in header:
            raise ValueError("only coordinate MatrixMarket supported")
        line = f.readline()
        while line.startswith("%"):
            line = f.readline()
        m, n, nnz = (int(t) for t in line.split())
        rows = np.empty(nnz, dtype=np.int32)
        cols = np.empty(nnz, dtype=np.int32)
        vals = np.empty(nnz, dtype=np.float64)
        for i in range(nnz):
            r, c, v = f.readline().split()
            rows[i], cols[i], vals[i] = int(r) - 1, int(c) - 1, float(v)
    return COOMatrix(rows, cols, vals, (m, n))
