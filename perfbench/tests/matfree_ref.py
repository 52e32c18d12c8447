"""A plain float64 reference of the matrix-free DAPC iterates, for the tests
of the harness's ``"coo"`` form (a configuration of the program's
``prepare(A, mode="matfree")``). It imports nothing of the program.

The row partition is the matrix-free solver's: block j of J holds rows
[j·p, (j + 1)·p) with p = ceil(m / J), the last block what is left (an
empty block keeps x_j(0) = 0 and projects nothing, as the solver's); the
solver's zero padding rows (0·x = 0) change no projection and add nothing to
a residual, so they are left out here. Each block is densified, which is
fine at a test's size, and factored as A_jᵀ = Q_j R_j (reduced QR). Then
x_j(0) = Q_j R_j⁻ᵀ b_j = A_jᵀ(A_j A_jᵀ)⁻¹ b_j; the consensus iteration is
eq. 6, x_j ← x_j + γ(I − Q_j Q_jᵀ)(x̄ − x_j), and eq. 7, x̄ ← η·mean_j x_j +
(1 − η)·x̄; every epoch records the residual ‖A x̄ − b‖².
"""
from __future__ import annotations

import numpy as np
import torch


class MatfreeReference:
    """The factors of one sparse system, reusable over many right-hand
    sides; ``coords`` has ``rows``, ``cols``, ``vals`` and ``shape``."""

    def __init__(self, coords, num_blocks: int, gamma: float, eta: float, device=None):
        self.device = torch.device(device) if device is not None else torch.device("cpu")
        self.m, self.n = (int(s) for s in coords.shape)
        self.A = torch.zeros((self.m, self.n), dtype=torch.float64, device=self.device)
        self.A[torch.as_tensor(np.asarray(coords.rows), device=self.device).long(),
               torch.as_tensor(np.asarray(coords.cols), device=self.device).long()] = \
            torch.as_tensor(np.asarray(coords.vals), device=self.device).double()
        self.gamma, self.eta = float(gamma), float(eta)
        p = -(-self.m // int(num_blocks))
        self.bounds = [(min(j * p, self.m), min((j + 1) * p, self.m))
                       for j in range(int(num_blocks))]
        self.Q, self.R = [], []
        for lo, hi in self.bounds:
            q, r = torch.linalg.qr(self.A[lo:hi].T, mode="reduced")
            self.Q.append(q)
            self.R.append(r)

    def run(self, B, epochs: int, capture=None):
        """Consensus over the columns of B (m, k) for ``epochs`` epochs:
        ``(history (epochs + 1, k), x̄ (n, k))`` in float64, with column c of
        x̄ taken after epoch ``capture[c]`` (the last when None)."""
        B = torch.as_tensor(np.asarray(B), device=self.device).double()
        B = B[:, None] if B.ndim == 1 else B
        k = B.shape[1]
        xs = torch.stack([
            q @ torch.linalg.solve_triangular(r.T, B[lo:hi], upper=False)
            for q, r, (lo, hi) in zip(self.Q, self.R, self.bounds)])
        xbar = xs.mean(dim=0)
        cap = torch.full((k,), epochs, dtype=torch.long) if capture is None else (
            torch.as_tensor(np.asarray(capture), dtype=torch.long))
        if cap.shape != (k,) or int(cap.min()) < 0 or int(cap.max()) > epochs:
            raise ValueError("capture needs one epoch in [0, epochs] per column")
        cap = cap.to(self.device)
        hist = torch.empty((epochs + 1, k), dtype=torch.float64, device=self.device)
        out = torch.empty((self.n, k), dtype=torch.float64, device=self.device)

        def record(t):
            r = self.A @ xbar - B
            hist[t] = (r * r).sum(dim=0)
            hit = cap == t
            out[:, hit] = xbar[:, hit]

        record(0)
        for t in range(1, epochs + 1):
            v = xbar - xs
            proj = torch.stack([q @ (q.T @ v[j]) for j, q in enumerate(self.Q)])
            xs = xs + self.gamma * (v - proj)
            xbar = self.eta * xs.mean(dim=0) + (1.0 - self.eta) * xbar
            record(t)
        return hist, out


def build(coords, config: dict, precision: str, device) -> MatfreeReference:
    """The reference for a ``"coo"`` configuration (its ``prepare`` keys:
    num_blocks, gamma, eta); float64 only."""
    if precision != "float64":
        raise ValueError("the test reference runs in float64 only")
    kw = config["prepare"]
    return MatfreeReference(coords, int(kw["num_blocks"]), float(kw.get("gamma", 1.0)),
                            float(kw.get("eta", 0.9)), device=device)
