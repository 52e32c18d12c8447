"""The yardstick: the card's published peaks and the operations and bytes of
the steps of a dense DAPC solve, from their shapes alone.

A step's least time is the larger of its operations at the peak rate and
its bytes at the HBM rate. Each input byte is read once per step and each
output byte written once, whatever an implementation reads again. A float32
product that keeps float32 accuracy runs at most at a third of the TF32
tensor-core rate (three TF32 products per float32 product), the highest rate
at which that accuracy is kept on the card, so no implementation of a
counted step can beat its least time.

Peaks: NVIDIA H100 SXM data sheet, dense rates, at the 700 W limit.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
TF32_FLOPS = 495e12
F32_ACCURATE_FLOPS = TF32_FLOPS / 3
F32 = 4  # bytes


def least_seconds(flops: float, nbytes: float) -> float:
    """A step's least time on the card."""
    return max(flops / F32_ACCURATE_FLOPS, nbytes / HBM_BYTES_PER_S)


def consensus_update_call(J: int, p: int, n: int, k: int) -> tuple[float, float]:
    """(flops, bytes) of one launch pair of the consensus-update kernels as
    the solver calls them: (I − WᵀW) v for W (J, p, n) and v (J, n, k), that
    is u = W v, then v − Wᵀu. Reads W and v, writes the (J, n, k) result."""
    flops = 4.0 * J * p * n * k + J * n * k
    nbytes = F32 * (J * p * n + 2.0 * J * n * k)
    return flops, nbytes


def trisolve_call(J: int, p: int, k: int) -> tuple[float, float]:
    """(flops, bytes) of one triangular solve with R_jᵀ (J, p, p) against
    (J, p, k): p² operations a column (p(p − 1)/2 multiply-adds and p
    divisions). Reads the triangle and the right-hand sides, writes the
    solution."""
    flops = float(J) * k * p * p
    nbytes = F32 * (J * p * (p + 1) / 2.0 + 2.0 * J * p * k)
    return flops, nbytes


def epoch(J: int, p: int, n: int, k: int) -> tuple[float, float]:
    """(flops, bytes) of one epoch, counted as one step:
    eq. 6, x_j + γ(I − W_jᵀW_j)(x̄ − x_j) for every block; eq. 7, x̄ =
    η·mean_j x_j + (1 − η)·x̄; and the residual ‖A x̄ − b‖² of the history,
    over the padded blocks. Reads W and the blocks (J, p, n), x (J, n, k),
    x̄ (n, k) and b (J, p, k); writes x, x̄ and k sums."""
    flops = (4.0 * J * p * n * k + 4.0 * J * n * k  # eq. 6
             + (J + 3.0) * n * k  # eq. 7
             + 2.0 * J * p * n * k + 3.0 * J * p * k)  # residual
    nbytes = F32 * (2.0 * J * p * n + 2.0 * J * n * k + 2.0 * n * k + J * p * k + k)
    return flops, nbytes


def start(J: int, p: int, n: int, k: int) -> tuple[float, float]:
    """(flops, bytes) of a solve's start, counted as one step: the
    substitution z_j = R_j⁻ᵀ b_j and x_j(0) = W_jᵀ z_j. Reads the triangles,
    b (J, p, k) and W; writes x (J, n, k)."""
    flops = float(J) * k * p * p + 2.0 * J * p * n * k
    nbytes = F32 * (J * p * (p + 1) / 2.0 + J * p * k + J * p * n + J * n * k)
    return flops, nbytes


def solve_least_seconds(J: int, p: int, n: int, k: int, epochs: int) -> float:
    """Least seconds of a whole solve of k right-hand sides that needs
    ``epochs`` epochs."""
    return epochs * least_seconds(*epoch(J, p, n, k)) + least_seconds(*start(J, p, n, k))
