"""SPMD distributed DAPC/APC on ``torch.distributed``.

The paper's task graph maps onto one program per rank of a ``DeviceMesh``:

  * block index ``j``  → the ``block_axes`` of the mesh (one contiguous group
    of row blocks per rank, batched over the local blocks);
  * consensus average → the local block mean, one ``all_reduce(SUM)`` over
    the block axes, divided by their size;
  * epochs            → a Python loop that queues device work.

Every rank passes the whole system (``blocks``, ``bvecs``, on the host or any
device) and keeps its own blocks on its device; every rank returns the same
replicated x̄. Beyond-paper features, as in the JAX package:

  * **2-D parallelism** (``solve_sharded_2d``): the solution dimension ``n``
    is sharded over the ``model`` axis. Per-block QR becomes a **TSQR** (local
    QR, the R stack gathered over ``model``, a small replicated QR), the
    projector factor is row-sharded, and an epoch pays one p-length sum over
    ``model`` plus the n/ms-length consensus mean over the block axes.
  * **Straggler-tolerant (stale) consensus** (``straggler_prob``): each epoch
    every block publishes its update only with probability 1−q; the average
    re-uses the last published state otherwise. The drop masks come from a
    ``torch.Generator`` per rank, seeded from ``(seed, every block-axis
    index)`` — decorrelated across ranks, but not ``jax.random``'s bits.

All of it is plain ``torch`` (``torch.linalg.qr``, ``solve_triangular``,
batched products), as the reference is plain ``jnp``: no hand kernel.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from repro_torch.core import apc, dapc
from repro_torch.core.collectives import mesh_axes_group
from repro_torch.core.matfree_sharded import mesh_device
from repro_torch.sparse.bsr import _tensor


def _local(arr, start: int, stop: int, dev: torch.device) -> torch.Tensor:
    """Blocks [start, stop) of a host or device array, on ``dev``."""
    if isinstance(arr, torch.Tensor):
        return arr[start:stop].to(dev)
    return _tensor(np.asarray(arr)[start:stop], dev)


def _replicated(arr, dtype, dev: torch.device) -> torch.Tensor:
    """The whole of ``arr`` on ``dev`` in ``dtype``."""
    if isinstance(arr, torch.Tensor):
        return arr.to(dev, dtype)
    return _tensor(np.asarray(arr), dev).to(dtype)


def _block_range(comm, num_blocks: int) -> tuple[int, int]:
    if num_blocks % comm.size:
        raise ValueError(
            f"num_blocks={num_blocks} not divisible over the {comm.size} "
            "devices of the block axes"
        )
    per = num_blocks // comm.size
    return comm.index * per, (comm.index + 1) * per


def _epoch_keys(seed: int, mesh, block_axes: Sequence[str]) -> torch.Generator:
    """This rank's straggler generator, seeded from ``seed`` and its index
    along EVERY axis of ``block_axes``: on a multi-axis block mesh, ranks
    sharing only their first index still draw independent drop patterns."""
    names = tuple(mesh.mesh_dim_names)
    coord = mesh.get_coordinate()
    words = [int(seed)] + [int(coord[names.index(a)]) for a in block_axes]
    state = np.random.SeedSequence(words).generate_state(2, np.uint32)
    gen = torch.Generator()
    gen.manual_seed((int(state[0]) << 32) | int(state[1]))
    return gen


def straggler_masks(seed: int, mesh, block_axes: Sequence[str], num_epochs: int,
                    num_local: int, straggler_prob: float) -> torch.Tensor:
    """(E, J_loc) bool on the host: whether each local block publishes its
    update in each epoch (drawn on this rank's ``_epoch_keys`` generator)."""
    gen = _epoch_keys(seed, mesh, tuple(block_axes))
    return torch.rand((num_epochs, num_local), generator=gen) >= float(straggler_prob)


# ---------------------------------------------------------------------------
# Row-sharded solver (the paper's layout: every worker holds full-width rows)
# ---------------------------------------------------------------------------


def solve_sharded(
    blocks,  # (J, p, n) — J divisible by the block axes' device count
    bvecs,  # (J, p) one RHS, or (J, p, k) coalesced batch
    mesh,
    mode: str,
    block_axes: Sequence[str] = ("data",),
    method: str = "dapc",
    gamma: float = 1.0,
    eta: float = 0.9,
    num_epochs: int = 100,
    straggler_prob: float = 0.0,
    seed: int = 0,
    x_ref=None,
    compress: str | None = None,  # "bf16_delta" halves the all-reduce payload
):
    """Distributed consensus solve, row-sharded blocks. Returns (x̄, history)
    on this rank's device, the same on every rank.

    ``bvecs`` with a trailing RHS axis ``(J, p, k)`` runs all k systems in
    the same program: state becomes ``(J_loc, n, k)`` and every collective
    (the consensus mean, the residual sum) carries k columns per round trip;
    x̄ comes back ``(n, k)`` and the history rows per-system ``(k,)``. A
    straggling block goes stale for ALL of its columns at once. History:
    ``residual_sq`` (and ``mse`` with ``x_ref``), ``(E, …)`` tensors.
    """
    block_axes = tuple(block_axes)
    comm = mesh_axes_group(mesh, block_axes)
    dev = mesh_device(mesh)
    lo, hi = _block_range(comm, blocks.shape[0])
    local_blocks = _local(blocks, lo, hi, dev)
    local_bvecs = _local(bvecs, lo, hi, dev)
    q = float(straggler_prob)

    # Algorithm 1 steps 2–3 over this rank's blocks; every product carries
    # a trailing RHS axis k unchanged
    if method == "dapc":
        x0s, Ws = dapc.setup_decomposed(local_blocks, local_bvecs, mode)
        apply_fn = dapc.make_apply(Ws, materialize_p=False)
    else:  # classical APC
        x0s, Ps = apc.setup_classical(local_blocks, local_bvecs, mode)
        apply_fn = apc.make_apply(Ps)
    ref = None if x_ref is None else _replicated(x_ref, local_blocks.dtype, dev)

    def metrics(xbar):
        r = torch.einsum("jpn,n...->jp...", local_blocks, xbar) - local_bvecs
        out = {"residual_sq": comm.all_reduce(torch.sum(r * r, dim=(0, 1)))}
        if ref is not None:
            d = xbar - ref
            out["mse"] = torch.mean(d * d, dim=0)
        return out

    xbar = comm.mean(torch.mean(x0s, dim=0))  # eq. (5)
    alive = None
    if q > 0.0:  # one mask per block, shared across the RHS columns it serves
        masks = straggler_masks(seed, mesh, block_axes, num_epochs, hi - lo, q)
        alive = masks.to(dev, x0s.dtype).reshape((num_epochs, hi - lo) + (1,) * (x0s.ndim - 1))
    xs, pub = x0s, x0s
    hist: dict = {}
    for t in range(num_epochs):
        xs = xs + gamma * apply_fn(xbar[None] - xs)  # eq. (6)
        pub = alive[t] * xs + (1.0 - alive[t]) * pub if alive is not None else xs
        if compress == "bf16_delta":
            local = torch.mean(pub - xbar[None], dim=0)
            delta = comm.mean(local.to(torch.bfloat16))
            xbar = xbar + eta * delta.to(xbar.dtype)  # eq. (7), Δ form
        else:
            mean_pub = comm.mean(torch.mean(pub, dim=0))
            xbar = eta * mean_pub + (1.0 - eta) * xbar  # eq. (7)
        for key, value in metrics(xbar).items():
            hist.setdefault(key, []).append(value)
    return xbar, {key: torch.stack(rows) for key, rows in hist.items()}


# ---------------------------------------------------------------------------
# 2-D solver: row blocks on the block axes, solution dimension on `model`
# ---------------------------------------------------------------------------


def _tsqr(b_loc: torch.Tensor, col):
    """TSQR of the tall matrices B (…, n, p) row-sharded over ``col`` (a
    ``Collectives``), batched over leading axes. Returns (Q_loc (…, n_loc,
    p), R (…, p, p) replicated)."""
    q1, r1 = torch.linalg.qr(b_loc, mode="reduced")  # local (n_loc, p), (p, p)
    rs = col.all_gather(r1, dim=-2)  # (…, ms·p, p), replicated
    p = r1.shape[-1]
    q2, r = torch.linalg.qr(rs, mode="reduced")
    return q1 @ q2[..., col.index * p:(col.index + 1) * p, :], r


def solve_sharded_2d(
    blocks_t,  # (J, n, p): per-block A_jᵀ (wide mode only)
    bvecs,  # (J, p) one RHS, or (J, p, k) coalesced batch
    mesh,
    block_axes: Sequence[str] = ("data",),
    col_axis: str = "model",
    gamma: float = 1.0,
    eta: float = 0.9,
    num_epochs: int = 100,
    x_ref=None,
):
    """2-D parallel decomposed APC (wide regime): TSQR setup + row-sharded
    solution. ``n`` must divide evenly by the ``col_axis`` extent. Returns
    (x̄, history) on this rank's device, x̄ gathered over ``col_axis`` (the
    same on every rank).

    A trailing RHS axis ``(J, p, k)`` batches all k systems: the TSQR factor
    is shared (b-independent), every sum and mean carries k columns, and x̄
    returns ``(n, k)`` with per-system ``(k,)`` history rows."""
    block_axes = tuple(block_axes)
    blk = mesh_axes_group(mesh, block_axes)
    col = mesh_axes_group(mesh, (col_axis,))
    dev = mesh_device(mesh)
    n = blocks_t.shape[1]
    if n % col.size:
        raise ValueError(f"n={n} not divisible by {col_axis}={col.size}")
    n_loc = n // col.size
    lo, hi = _block_range(blk, blocks_t.shape[0])
    bt_loc = _local(blocks_t, lo, hi, dev)[:, col.index * n_loc:(col.index + 1) * n_loc]
    b_loc = _local(bvecs, lo, hi, dev)
    ref_loc = None
    if x_ref is not None:
        ref_loc = _replicated(x_ref, bt_loc.dtype, dev)[col.index * n_loc:(col.index + 1) * n_loc]

    qs, r = _tsqr(bt_loc, col)  # W = Qᵀ, row-sharded: (J_loc, n_loc, p)
    rhs = b_loc if b_loc.ndim == 3 else b_loc[..., None]
    x0s = qs @ torch.linalg.solve_triangular(r.mT, rhs, upper=False)
    if b_loc.ndim == 2:
        x0s = x0s[..., 0]  # (J_loc, n_loc[, k])

    def apply_fn(v):  # v (J_loc, n_loc[, k]): P v = v − Q sum_model(Qᵀ v)
        u = col.all_reduce(torch.einsum("jnp,jn...->jp...", qs, v))
        return v - torch.einsum("jnp,jp...->jn...", qs, u)

    def metrics(xbar_loc):
        # residual: A_j x = sum_model(B_locᵀ x_loc)
        ax = col.all_reduce(torch.einsum("jnp,n...->jp...", bt_loc, xbar_loc))
        r = ax - b_loc
        out = {"residual_sq": blk.all_reduce(torch.sum(r * r, dim=(0, 1)))}
        if ref_loc is not None:
            d = xbar_loc - ref_loc
            out["mse"] = col.mean(torch.mean(d * d, dim=0))
        return out

    xbar = blk.mean(torch.mean(x0s, dim=0))
    xs = x0s
    hist: dict = {}
    for _ in range(num_epochs):
        xs = xs + gamma * apply_fn(xbar[None] - xs)
        xbar = eta * blk.mean(torch.mean(xs, dim=0)) + (1.0 - eta) * xbar
        for key, value in metrics(xbar).items():
            hist.setdefault(key, []).append(value)
    return col.all_gather(xbar), {key: torch.stack(rows) for key, rows in hist.items()}


# ---------------------------------------------------------------------------
# Elastic re-partitioning (worker count changes between runs / after failure)
# ---------------------------------------------------------------------------


def repartition(blocks, bvecs, new_num_blocks: int):
    """Re-split the same global system for a different worker count.

    APC state is reconstructible from (A, b) alone — after elastic scale-up
    or scale-down, re-run setup on the new layout and warm-start the
    consensus from any previous x̄. ``bvecs`` may be a single RHS ``(J, p)``
    or a coalesced batch ``(J, p, k)``: the trailing RHS axis rides through
    the re-split unchanged. Works on tensors and numpy arrays alike."""
    num_blocks, p, n = blocks.shape
    m = num_blocks * p
    if m % new_num_blocks:
        raise ValueError(f"m={m} rows not divisible into {new_num_blocks} blocks")
    flat_a = blocks.reshape(m, n)
    tail = tuple(bvecs.shape[2:])  # () single RHS, (k,) coalesced batch
    flat_b = bvecs.reshape(m, *tail)
    p2 = m // new_num_blocks
    return (
        flat_a.reshape(new_num_blocks, p2, n),
        flat_b.reshape(new_num_blocks, p2, *tail),
    )
