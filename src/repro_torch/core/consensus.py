"""The APC consensus iteration (paper eqs. 6–7) as a Python loop over epochs.

Shared by classical APC and decomposed APC — the two differ only in how the
per-block initial solutions and projectors are produced (Algorithm 1 steps
2–3), not in the iteration itself (steps 5–8).

Every function here is shape-polymorphic over a trailing RHS axis: state is
``(J, n)`` for one right-hand side or ``(J, n, k)`` for a k-system batch.
The reference's ``lax.scan`` becomes a loop that queues device work only:
no host sync (the ``tol`` freeze stays on the device as a ``torch.where``
mask; the host learns that every column has frozen from a poll it reads
once the copy has landed, and waits for one only to keep its lead over the
card within ``MAX_LEAD`` epochs), histories are written into preallocated
``(E, …)`` tensors, and the ``avg_every`` schedule is a Python bool per
epoch.
"""
from __future__ import annotations

import collections
import threading
from typing import Callable

import torch

# Under ``tol``, the epochs between two polls of the freeze mask. A poll is
# one reduction and a one-byte copy to the host.
POLL_EVERY = 4
# Under ``tol`` on a CUDA device, how far the poll the host must have read
# may lie behind the poll it queues: before it queues the poll of epoch t it
# reads the poll of epoch t − MAX_LEAD, waiting for it if it has not landed.
# So the host leads the card by at most MAX_LEAD + POLL_EVERY epochs, and
# the loop ends at most MAX_LEAD epochs after the poll that first reads
# every column frozen. When a wait returns, the card still holds the
# MAX_LEAD epochs queued after that poll, and the host queues the next
# POLL_EVERY in a fraction of their time.
MAX_LEAD = 8
_POLL_SLOTS = MAX_LEAD // POLL_EVERY  # polls in flight at most
_poll_buffers = threading.local()


def _match_rhs(bvecs: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Broadcast unbatched (J, p) bvecs against batched (…, k) state."""
    if x.ndim > bvecs.ndim - 1:
        return bvecs[..., None]
    return bvecs


def block_residual_sq(blocks: torch.Tensor, bvecs: torch.Tensor, x: torch.Tensor):
    """Global residual ||A x − b||² computed block-wise (no A reassembly).

    Scalar for x (n,); per-system vector (k,) for a batched x (n, k)."""
    r = blocks @ x - _match_rhs(bvecs, x)  # A_j x: (J, p) or (J, p, k)
    return torch.sum(r * r, dim=(0, 1))


def _block_col(v, ndim: int):
    """Reshape a per-block (J,) vector for broadcasting against (J, n[, k])
    state; scalars pass through untouched."""
    if isinstance(v, torch.Tensor) and v.ndim >= 1:
        return v.reshape(v.shape + (1,) * (ndim - v.ndim))
    return v


def _poll_buffer(stream):
    """A pinned ``(_POLL_SLOTS,)`` bool host buffer, its numpy view and one
    CUDA event per slot, made once per host thread and CUDA stream. Within
    a solve a slot is reused only once the host has read its poll. A
    stream runs its copies in the order they were queued, so a poll still
    in flight when its solve returns lands before any poll of a later solve
    that reuses its slot, and the later poll's event completes after it."""
    bufs = _poll_buffers.__dict__.setdefault("by_stream", {})
    if stream not in bufs:  # a stream hashes by its handle and device
        flags = torch.zeros(_POLL_SLOTS, dtype=torch.bool, pin_memory=True)
        bufs[stream] = flags, flags.numpy(), [torch.cuda.Event() for _ in range(_POLL_SLOTS)]
    return bufs[stream]


class _FreezePoll:
    """Whether the ``tol`` mask has frozen every column, as far as the host
    has read. Every ``POLL_EVERY`` epochs ``frozen`` queues ``active.any()``,
    copies it without blocking into a slot of a pinned buffer and records
    an event; at every epoch it reads the polls whose events have
    completed, oldest first. A poll takes the slot of the poll
    ``MAX_LEAD`` epochs back, so when that one is still unread the host
    reads it first, waiting on its event if the copy has not landed: the
    host's lead over the card stays capped. On a CPU device the flag is
    read in place, at once. ``copied`` counts the flags copied, one byte
    each; ``lead_waits`` the waits on an event not yet complete."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.copied = 0
        self.lead_waits = 0
        self.pending: collections.deque = collections.deque()  # slots in flight, oldest first
        if self.cuda:
            self.stream = torch.cuda.current_stream(device)
            self.flags, self.view, self.events = _poll_buffer(self.stream)

    def frozen(self, active: torch.Tensor, t: int) -> bool:
        """After epoch ``t``, whose residual gave the next epoch's mask
        ``active``: True once a poll has read no column active."""
        if (t + 1) % POLL_EVERY == 0:
            if not self.cuda:
                return not bool(active.any())
            if len(self.pending) == _POLL_SLOTS:  # the poll of epoch t − MAX_LEAD, unread
                slot = self.pending.popleft()
                if not self.events[slot].query():
                    self.lead_waits += 1
                    self.events[slot].synchronize()  # releases the GIL while it waits
                if not self.view[slot]:
                    return True
            slot = self.copied % _POLL_SLOTS
            self.copied += 1
            self.flags[slot].copy_(active.any(), non_blocking=True)
            self.events[slot].record(self.stream)
            self.pending.append(slot)
        while self.pending and self.events[self.pending[0]].query():
            if not self.view[self.pending.popleft()]:
                return True
        return False


def run_consensus(
    x0s: torch.Tensor,  # (J, n) or (J, n, k) per-block initial solutions
    apply_fn: Callable[[torch.Tensor], torch.Tensor],  # x0s-shaped: P_j v_j
    gamma,
    eta,
    num_epochs: int,
    x_ref: torch.Tensor | None = None,
    blocks: torch.Tensor | None = None,
    bvecs: torch.Tensor | None = None,
    avg_every: int = 1,
    compress: str | None = None,  # None | "bf16_delta"
    xbar0: torch.Tensor | None = None,  # warm start (elastic restart)
    tol: float | None = None,  # masked per-column early exit
    block_history: bool = False,  # per-block residual diagnostics
    *,
    stats: dict | None = None,  # out: epochs run, bytes the polls copied
):
    """Paper eqs. (5)–(7). Returns (x̄_final, history dict).

    history carries per-epoch MSE to ``x_ref`` (paper Fig. 2 metric) and the
    global residual when (blocks, bvecs) are supplied, each as an ``(E, …)``
    tensor; with a batched ``(J, n, k)`` input both metrics are per-system
    ``(k,)`` rows. ``history["initial"]`` holds the metrics of x̄(0).

    ``block_history=True`` additionally records the per-block residual
    ``history["block_residual_sq"]`` — ``(J,)`` per epoch, ``(J, k)``
    batched — from the same residual pass.

    ``tol`` arms the masked early exit: a column whose residual reaches
    ``residual_sq <= tol²`` freezes — its xs/x̄ columns stop updating under a
    ``torch.where`` mask — while the batch keeps its shape. The mask reads
    the residual carried from the previous epoch. Requires (blocks, bvecs).
    Once every column has frozen, x̄ and the metrics no longer change, so
    the loop ends as soon as the host reads a poll of the mask (every
    ``POLL_EVERY`` epochs; on a CUDA device read once its copy has landed,
    at most ``MAX_LEAD`` epochs later) that finds no column active, and the
    remaining history rows repeat the last one computed: the result is the
    one the full cap gives, bit for bit. A column that never freezes runs
    the cap.

    ``stats``, a dict, receives ``epochs`` (the epochs run), ``poll_bytes``
    (the bytes the polls copied to the host; none on a CPU device, where
    the flag is read in place) and ``lead_waits`` (the times the host
    waited for a poll to land, to keep within ``MAX_LEAD``).

    ``compress="bf16_delta"`` communicates the delta mean(x)−x̄ in bf16
    (eq. 7 rewritten as x̄ += η·Δ).

    ``gamma``/``eta`` accept per-block ``(J,)`` tensors: eq. (6) steps block j
    with γ_j and eq. (7) becomes x̄⁺ = mean_j(η_j·xs_j⁺) + (1−η̄)·x̄ with
    η̄ = mean(η_j).

    ``avg_every > 1`` runs the consensus average every k-th epoch; between
    averages workers take local projection steps against the stale x̄.
    """
    if xbar0 is None:
        xbar0 = torch.mean(x0s, dim=0)  # eq. (5)
    elif xbar0.ndim < x0s.ndim - 1:
        xbar0 = torch.broadcast_to(xbar0[..., None], x0s.shape[1:])
    if tol is not None and (blocks is None or bvecs is None):
        raise ValueError("tol early exit needs (blocks, bvecs) for residuals")
    if block_history and (blocks is None or bvecs is None):
        raise ValueError("block_history needs (blocks, bvecs) for residuals")

    def metrics(xbar):
        out = {}
        if x_ref is not None:
            ref = x_ref[..., None] if xbar.ndim > x_ref.ndim else x_ref
            d = xbar - ref
            out["mse"] = torch.mean(d * d, dim=0)
        if blocks is not None and bvecs is not None:
            if block_history:
                r = blocks @ xbar - _match_rhs(bvecs, xbar)
                per_block = torch.sum(r * r, dim=1)  # (J,) or (J, k)
                out["block_residual_sq"] = per_block
                out["residual_sq"] = torch.sum(per_block, dim=0)
            else:
                out["residual_sq"] = block_residual_sq(blocks, bvecs, xbar)
        return out

    init_metrics = metrics(xbar0)

    per_block = any(isinstance(v, torch.Tensor) and v.ndim >= 1 for v in (gamma, eta))
    gam = _block_col(gamma, x0s.ndim)
    if per_block:
        eta_col = _block_col(eta, x0s.ndim)
        eta_bar = eta.mean() if isinstance(eta, torch.Tensor) and eta.ndim >= 1 else eta

    hist = {
        key: torch.empty((num_epochs,) + v.shape, dtype=v.dtype, device=v.device)
        for key, v in init_metrics.items()
    }
    xs, xbar = x0s, xbar0
    ran = 0
    if tol is not None:
        # the mask of epoch t reads the residual of the x̄ it STARTS from:
        # the initial one, then each epoch's, so frozen columns stop moving
        tol_sq = tol * tol
        active = init_metrics["residual_sq"] > tol_sq  # (k,) batched, scalar otherwise
        poll = _FreezePoll(active.device)
    for t in range(num_epochs):
        xs_new = xs + gam * apply_fn(xbar[None] - xs)  # eq. (6), parallel j
        if (t + 1) % avg_every != 0:
            xbar_new = xbar
        elif compress == "bf16_delta":
            if per_block:  # Δ = mean(η_j (xs_j − x̄)), η folded into the wire
                delta = torch.mean(eta_col * (xs_new - xbar[None]), dim=0)
                xbar_new = xbar + delta.to(torch.bfloat16).to(xbar.dtype)
            else:
                delta = torch.mean(xs_new - xbar[None], dim=0)  # wire payload
                xbar_new = xbar + eta * delta.to(torch.bfloat16).to(xbar.dtype)
        elif per_block:  # eq. (7), η_j-weighted mean (reduces to scalar form)
            xbar_new = torch.mean(eta_col * xs_new, dim=0) + (1.0 - eta_bar) * xbar
        else:
            xbar_new = eta * torch.mean(xs_new, dim=0) + (1.0 - eta) * xbar  # eq. (7)
        if tol is not None:
            xs_new = torch.where(active, xs_new, xs)
            xbar_new = torch.where(active, xbar_new, xbar)
        out = metrics(xbar_new)
        for key, v in out.items():
            hist[key][t] = v
        xs, xbar = xs_new, xbar_new
        ran = t + 1
        if tol is not None and ran < num_epochs:
            active = out["residual_sq"] > tol_sq
            if poll.frozen(active, t):
                break
    if ran < num_epochs:  # every later epoch would recompute the same row
        for h in hist.values():
            h[ran:] = h[ran - 1]
    if stats is not None:
        polled = tol is not None
        stats.update(epochs=ran, poll_bytes=poll.copied if polled else 0,
                     lead_waits=poll.lead_waits if polled else 0)
    hist["initial"] = init_metrics
    return xbar, hist


def evaluate_candidates(
    x0s: torch.Tensor,
    apply_fn: Callable[[torch.Tensor], torch.Tensor],
    blocks: torch.Tensor,
    bvecs: torch.Tensor,
    gammas: torch.Tensor,  # (C,) scalar or (C, J) per-block candidates
    etas: torch.Tensor,  # (C,) scalar or (C, J) per-block candidates
    probe_epochs: int = 20,
    block_history: bool = False,
):
    """Run every (γ, η) candidate for ``probe_epochs`` and score it by final
    global residual — the single evaluation path behind hyperparameter
    tuning. The reference's vmap over candidates is a loop here.

    Candidates may be scalars ``(C,)`` or per-block vectors ``(C, J)``.
    Returns ``(scores, block_hist)``; ``block_hist`` is the per-epoch
    per-block residual history ``(C, E, J[, k])`` when ``block_history``
    is set, else None.
    """
    gammas = torch.as_tensor(gammas, dtype=x0s.dtype, device=x0s.device)
    etas = torch.as_tensor(etas, dtype=x0s.dtype, device=x0s.device)
    scores, hists = [], []
    for g, e in zip(gammas, etas):
        xbar, hist = run_consensus(
            x0s, apply_fn, g, e, probe_epochs,
            blocks=blocks if block_history else None,
            bvecs=bvecs if block_history else None,
            block_history=block_history,
        )
        scores.append(block_residual_sq(blocks, bvecs, xbar))
        if block_history:
            hists.append(hist["block_residual_sq"])
    return torch.stack(scores), (torch.stack(hists) if block_history else None)


def tune_hyperparams(
    x0s: torch.Tensor,
    apply_fn: Callable[[torch.Tensor], torch.Tensor],
    blocks: torch.Tensor,
    bvecs: torch.Tensor,
    gammas,
    etas,
    probe_epochs: int = 20,
    plan=None,
):
    """Grid-search (γ, η) by residual after a short probe run.

    Returns ``(gamma, eta)``. With a ``PartitionPlan`` supplied, the
    winning probe additionally reports how each of the plan's blocks
    converged: the return becomes ``(gamma, eta, rates)`` with ``rates``
    the per-block geometric decay rate over the probe window.
    """
    dev, dt = x0s.device, x0s.dtype
    gg, ee = torch.meshgrid(
        torch.as_tensor(gammas, dtype=dt, device=dev),
        torch.as_tensor(etas, dtype=dt, device=dev),
        indexing="ij",
    )
    pairs = torch.stack([gg.reshape(-1), ee.reshape(-1)], dim=1)
    scores, block_hist = evaluate_candidates(
        x0s, apply_fn, blocks, bvecs, pairs[:, 0], pairs[:, 1],
        probe_epochs, block_history=plan is not None,
    )
    scores = torch.where(torch.isfinite(scores), scores, torch.inf)
    # fold RHS columns: a batched probe scores a candidate by its summed
    # residual (the reference's flat argmin runs past the candidate axis)
    flat = scores.reshape(scores.shape[0], -1).sum(dim=1)
    idx = int(torch.argmin(flat))
    if plan is None:
        return float(pairs[idx, 0]), float(pairs[idx, 1])
    hist = block_hist[idx]  # (E, J[, k])
    epochs = hist.shape[0]
    rates = (
        hist[-1] / torch.clamp(hist[0], min=1e-30)
    ) ** (1.0 / (2.0 * max(epochs - 1, 1)))
    return float(pairs[idx, 0]), float(pairs[idx, 1]), rates
