"""The benchmark's input generator: a frozen copy of the port's
``generate_schenk_like`` + ``augment_system`` (paper eq. 8), made from
``--seed`` alone.

The square core follows the paper's Schenk_IBMNA ``c-*`` statistics (99.85%
sparse, value mean 0.013 and std 24.31, a diagonal ridge for full rank); its
few ten thousand entries are drawn on the host exactly as the port's
generator draws them. Everything dense is made on the device: the mixing
rows G (m − n, n) come from a ``torch.Generator`` on the card, the product
G·A is taken there in float64, and every right-hand side is B = A·X with X
drawn on the card, so each system is consistent with the float32 A that both
the program and the reference are handed.

A configuration's ``problem`` may name its ``form``: ``"dense"`` (the
default) is the augmented system above; ``"coo"`` is the square core alone,
held as host coordinates and never densified, for the program's matrix-free
path. Eq. 8's G·A rows are dense, so the ``"coo"`` form takes m = n.

A ``"coo"`` problem names its matrix: its core is drawn from the
configuration's ``matrix_seed`` and not from the run's seed. A deployment
prepares one matrix and solves many right-hand sides against it, and the
matrix-free solver's device memory (ELL width, packed forms, Gram shards)
follows the sparsity pattern, so the pattern belongs to the configuration
and only the right-hand sides to the run. At ``matrix_seed`` S the core is
the dense form's core at run seed S. The dense form's memory follows its
shapes alone; it draws its matrix from the run's seed and takes no
``matrix_seed``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


def sub_seed(seed: int, purpose: int) -> int:
    """A 63-bit seed for one purpose, derived from the run's ``--seed``
    (any non-negative whole number, also beyond 32 bits)."""
    state = np.random.SeedSequence([int(seed), int(purpose)]).generate_state(2, np.uint32)
    return (int(state[0]) << 31) ^ int(state[1])


def schenk_core(n: int, sparsity: float, mean: float, std: float, seed: int,
                cond_boost: float = 1.0):
    """(rows, cols, vals) of the square core: ``generate_schenk_like``'s
    draws, order and de-duplication, unchanged."""
    rng = np.random.default_rng(seed)
    nnz_target = int(round((1.0 - sparsity) * n * n))
    nnz_off = max(nnz_target - n, 0)
    rows = rng.integers(0, n, size=nnz_off).astype(np.int32)
    cols = rng.integers(0, n, size=nnz_off).astype(np.int32)
    vals = rng.normal(mean, std, size=nnz_off)
    drows = np.arange(n, dtype=np.int32)
    dvals = (std * cond_boost) * (1.0 + rng.random(n))
    dvals *= rng.choice([-1.0, 1.0], size=n)
    rows = np.concatenate([rows, drows])
    cols = np.concatenate([cols, drows])
    vals = np.concatenate([vals, dvals])
    order = np.lexsort((cols, rows))
    rows, cols, vals = rows[order], cols[order], vals[order]
    key = rows.astype(np.int64) * n + cols
    keep = np.ones(key.size, dtype=bool)
    keep[:-1] = key[1:] != key[:-1]
    return rows[keep], cols[keep], vals[keep]


def dense_core(rows, cols, vals, n: int, device) -> torch.Tensor:
    """The core as a dense float64 (n, n) tensor on ``device``."""
    a = torch.zeros((n, n), dtype=torch.float64, device=device)
    a[torch.as_tensor(rows, device=device).long(),
      torch.as_tensor(cols, device=device).long()] = torch.as_tensor(vals, device=device)
    return a


def augment(a_sq: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Paper eq. (8): [A; G·A], in the precision of the operands."""
    return torch.cat([a_sq, g @ a_sq])


FORMS = ("dense", "coo")


@dataclasses.dataclass(frozen=True)
class Coords:
    """A sparse matrix as plain host coordinates, sorted by row and then
    column, without duplicates: the ``"coo"`` form's A."""

    rows: np.ndarray  # (nnz,) int32
    cols: np.ndarray  # (nnz,) int32
    vals: np.ndarray  # (nnz,) float32
    shape: tuple[int, int]

    def sparse64(self, device) -> torch.Tensor:
        """The matrix as a float64 sparse COO tensor on ``device``."""
        idx = torch.as_tensor(np.stack([self.rows, self.cols]), device=device).long()
        vals = torch.as_tensor(self.vals, device=device).double()
        return torch.sparse_coo_tensor(idx, vals, self.shape, check_invariants=True).coalesce()


@dataclasses.dataclass
class System:
    """One seed's system: A as handed to both sides, and a generator of
    consistent right-hand sides on the card."""

    A: torch.Tensor | Coords  # dense: (m, n) float32 on the device; coo: host coordinates
    seed: int
    device: torch.device

    def rhs(self, k: int, purpose: int) -> torch.Tensor:
        """B = A·X (m, k), float32, for X (n, k) drawn on the device from
        the run's seed and ``purpose``; the product is taken in float64,
        a sparse one for the ``"coo"`` form."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(sub_seed(self.seed, 1000 + purpose))
        x = torch.randn((self.A.shape[1], k), generator=gen, device=self.device,
                        dtype=torch.float64)
        if isinstance(self.A, Coords):
            return torch.sparse.mm(self.A.sparse64(self.device), x).float()
        return (self.A.double() @ x).float()

    def host(self):
        """A on the host: the (m, n) float32 array, or the coordinates."""
        return self.A if isinstance(self.A, Coords) else self.A.cpu().numpy()


def _matrix_seed(problem: dict, form: str, seed: int) -> int:
    """The seed of the core: a ``"coo"`` problem's ``matrix_seed``, the
    run's ``seed`` for the dense form."""
    if form == "dense":
        if "matrix_seed" in problem:
            raise ValueError("a dense problem takes no 'matrix_seed': its matrix is drawn "
                             "from the run's seed")
        return int(seed)
    value = problem.get("matrix_seed")
    if isinstance(value, bool) or not isinstance(value, int) or value < 0:
        raise ValueError(f"a coo problem names its matrix: 'matrix_seed' must be a "
                         f"non-negative integer, got {value!r}")
    return value


def make_system(problem: dict, seed: int, device) -> System:
    """The configuration's system for ``seed``: ``problem`` holds m, n,
    sparsity, value_mean and value_std, and optionally ``form``; a
    ``"coo"`` problem also its ``matrix_seed``. The right-hand sides follow
    ``seed`` in both forms."""
    n, m = int(problem["n"]), int(problem["m"])
    form = problem.get("form", "dense")
    if form not in FORMS:
        raise ValueError(f"problem form must be one of {FORMS}, got {form!r}")
    if form == "coo" and m != n:
        raise ValueError(f"the coo form is the square core alone (eq. 8's rows are dense): "
                         f"m = n, got m={m}, n={n}")
    core_seed = _matrix_seed(problem, form, seed)
    device = torch.device(device)
    rows, cols, vals = schenk_core(
        n, float(problem["sparsity"]), float(problem["value_mean"]),
        float(problem["value_std"]), sub_seed(core_seed, 0),
    )
    if form == "coo":
        return System(A=Coords(rows, cols, vals.astype(np.float32), (n, n)), seed=int(seed),
                      device=device)
    a_sq = dense_core(rows, cols, vals, n, device)
    gen = torch.Generator(device=device)
    gen.manual_seed(sub_seed(seed, 1))
    g = torch.randn((m - n, n), generator=gen, device=device, dtype=torch.float64)
    g /= np.sqrt(n)
    a = augment(a_sq, g).float()
    del a_sq, g
    return System(A=a, seed=int(seed), device=device)
