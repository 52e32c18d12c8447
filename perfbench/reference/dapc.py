"""Plain PyTorch reference of dense decomposed APC (arXiv:2306.10328,
Algorithm 1) with wide row blocks, as the benchmark judges the program by.

From the A and B handed to both sides it works everything out again: the
row padding (the same seeded mixing equations a J-way split of m rows
uses), the blocks, each block's reduced QR (A_jᵀ = Q_j R_j, W_j = Q_jᵀ),
the initial solutions by forward substitution on R_jᵀ (x_j(0) = Q_j R_j⁻ᵀ
b_j), and the consensus iteration (eq. 6: x_j ← x_j + γ(I − W_jᵀW_j)(x̄ −
x_j); eq. 7: x̄ ← η·mean_j x_j + (1 − η)·x̄) with the global residual
‖A x̄ − b‖² of every epoch. It imports nothing of the program and takes
nothing the program made.

``precision="float64"`` is the reference. ``precision="tf32"`` is the
control of the benchmark's comparison: the same steps in float32 storage
with every matrix product's operands rounded to TF32 (10-bit mantissa) and
accumulated in float32, which is what TF32 tensor-core products do; on a
CUDA device the products run on the TF32 path itself.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

PRECISIONS = ("float64", "tf32")


def row_mixer(m: int, num_blocks: int):
    """(p, g): the block height ceil(m / J) and the (pad, m) mixing rows that
    complete the last block (None when J divides m)."""
    p = -(-m // num_blocks)
    pad = p * num_blocks - m
    if not pad:
        return p, None
    return p, np.random.default_rng(0).standard_normal((pad, m)) / np.sqrt(m)


def tf32_round(t: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to TF32's 10-bit mantissa (nearest, ties to
    even)."""
    bits = t.contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    rounded = (bits + 0xFFF + lsb) & ~0x1FFF
    return rounded.view(torch.float32)


@contextlib.contextmanager
def _cuda_tf32(enabled: bool):
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = enabled
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


class DapcReference:
    """The factors of one system, reusable over many right-hand sides."""

    def __init__(self, A, num_blocks: int, gamma: float, eta: float,
                 precision: str = "float64", device=None):
        if precision not in PRECISIONS:
            raise ValueError(f"precision must be one of {PRECISIONS}")
        self.precision = precision
        self.dtype = torch.float64 if precision == "float64" else torch.float32
        self.device = torch.device(device) if device is not None else torch.device("cpu")
        A = torch.as_tensor(np.asarray(A) if not isinstance(A, torch.Tensor) else A)
        self.m, self.n = A.shape
        self.J = int(num_blocks)
        self.gamma, self.eta = float(gamma), float(eta)
        self.p, g = row_mixer(self.m, self.J)
        if self.p >= self.n:
            raise ValueError("the reference covers wide blocks (ceil(m/J) < n)")
        self.g = None if g is None else torch.as_tensor(g, dtype=torch.float64,
                                                        device=self.device)
        self.blocks = self.block(A)  # (J, p, n)
        q, r = torch.linalg.qr(self.blocks.mT, mode="reduced")  # (J, n, p), (J, p, p)
        self.Q, self.R = q, r

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.precision == "float64":
            return a @ b
        if self.device.type == "cuda":
            with _cuda_tf32(True):
                return a @ b
        return tf32_round(a) @ tf32_round(b)

    def block(self, v) -> torch.Tensor:
        """Rows of ``v`` (m, ...) padded with the mixing rows and cut into
        (J, p, ...) blocks, in the reference's precision."""
        v = torch.as_tensor(v).to(device=self.device, dtype=torch.float64)
        if self.g is not None:
            v = torch.cat([v, self.g @ v])
        return v.reshape(self.J, self.p, *v.shape[1:]).to(self.dtype)

    def residual_sq(self, bvecs: torch.Tensor, xbar: torch.Tensor) -> torch.Tensor:
        """‖A x̄ − b‖² per column, over every row of the padded blocks."""
        k = xbar.shape[-1]
        r = self.mm(self.blocks.reshape(-1, self.n), xbar) - bvecs.reshape(-1, k)
        return (r * r).sum(dim=0)

    def run(self, B, epochs: int, capture=None):
        """Consensus over the columns of B (m, k) for ``epochs`` epochs.

        Returns ``(history, xbars)``: history (epochs + 1, k) holds the
        residual ‖A x̄ − b‖² of x̄(0) and of every epoch, in float64; xbars
        (n, k) holds, for column c, x̄ after epoch ``capture[c]`` (after the
        last epoch when ``capture`` is None).
        """
        B = torch.as_tensor(B)
        if B.ndim == 1:
            B = B[:, None]
        k = B.shape[1]
        bvecs = self.block(B)  # (J, p, k)
        z = torch.linalg.solve_triangular(self.R.mT, bvecs, upper=False)
        xs = self.mm(self.Q, z)  # (J, n, k)
        xbar = xs.mean(dim=0)
        cap = torch.full((k,), epochs, dtype=torch.long) if capture is None else (
            torch.as_tensor(np.asarray(capture), dtype=torch.long))
        if cap.shape != (k,) or int(cap.min()) < 0 or int(cap.max()) > epochs:
            raise ValueError("capture needs one epoch in [0, epochs] per column")
        hist = torch.empty((epochs + 1, k), dtype=torch.float64, device=self.device)
        hist[0] = self.residual_sq(bvecs, xbar).double()
        out = torch.empty((self.n, k), dtype=torch.float64, device=self.device)
        cap_dev = cap.to(self.device)
        out[:, cap_dev == 0] = xbar[:, cap_dev == 0].double()
        for t in range(1, epochs + 1):
            v = xbar - xs
            xs = xs + self.gamma * (v - self.mm(self.Q, self.mm(self.Q.mT, v)))
            xbar = self.eta * xs.mean(dim=0) + (1.0 - self.eta) * xbar
            hist[t] = self.residual_sq(bvecs, xbar).double()
            hit = cap_dev == t
            if bool(hit.any()):
                out[:, hit] = xbar[:, hit].double()
        return hist, out


def iterations_to_tol(history: np.ndarray, tol: float) -> np.ndarray:
    """Per column, the first epoch e ≥ 1 whose residual is ≤ tol² (the
    number of epochs the column ran before it froze), else the cap; from a
    (epochs + 1, k) history whose row 0 is x̄(0)'s."""
    trace = np.asarray(history)[1:]
    reached = trace <= float(tol) ** 2
    return np.where(reached.any(axis=0), reached.argmax(axis=0) + 1,
                    trace.shape[0]).astype(np.int64)


def build(A, config: dict, precision: str, device) -> DapcReference:
    """The reference for a configuration file's system (its ``prepare``
    keys: num_blocks, gamma, eta)."""
    kw = config["prepare"]
    return DapcReference(A, int(kw["num_blocks"]), float(kw.get("gamma", 1.0)),
                         float(kw.get("eta", 0.9)), precision=precision, device=device)
