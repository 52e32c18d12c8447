"""Device-resident blocked-sparse (blocked-ELL / BSR) format.

The dense path decompresses every row block to a dense ``(p, n)`` array
before QR, so its memory scales as O(J·p·n) regardless of sparsity. This
module keeps the matrix blocked-sparse on the device:

  * ``BlockEll`` — a padded blocked-ELL layout: the rows are cut into
    ``bp``-row block-rows, each storing a fixed number ``S`` of dense
    ``(bp, bn)`` tiles plus the column-block index of every tile. Short
    rows are padded with index-0 tiles whose data is all zero, so padding
    contributes nothing to a product (no masks needed).
  * ``PartitionedBSR`` — the J-way row partition of a ``COOMatrix`` as
    stacked blocked-ELL shards for A_j and A_jᵀ, with the SpMM/SpMV
    products the matrix-free solver builds its projections from
    (``repro_torch.core.matfree``): the hand-written CUDA kernels under
    ``use_kernels=True`` (``repro_torch.kernels.spmm``), gather + einsum +
    ``index_add_`` otherwise. ``with_packed`` adds the packed-nonzero form
    of every stored shard (a CSR of its nonzeros, derived, never saved),
    which the kernel path's products stream instead of the tiles: the
    transposed shards' form is the CSC of A_j's nonzeros, so the epoch's
    fused pass needs no staged contributions and no scatter. ``place``
    keeps one rank's contiguous group of blocks of a host-built operator
    (the sharded solver's placement, ``repro_torch.core.matfree_sharded``).

The layout is built on the host by numpy code copied from the JAX package's
``sparse/bsr.py``, so both packages give equal index and data arrays, bit
for bit; only the finished arrays move to ``device``. Index arrays stay
int32 in storage (the kernels' and ``to_arrays``' type) and are widened to
int64 where PyTorch indexes with them.

Blocks are padded to ``p_pad`` rows with zero rows: a zero row is the
consistent equation 0·x = 0, so a block's projection is unchanged.
``from_coo(..., balance=True)`` reorders the rows within each block before
tiling to tighten the slot count ``S``; every public product translates
back to the original row order, so the operator contract is unchanged.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.spmm import ops as spmm_ops
from repro_torch.kernels.spmm.pack import Packed, pack
from repro_torch.kernels.spmm.ref import spmm_fused_plain, spmm_plain
from repro_torch.sparse.matrix import COOMatrix

DEFAULT_BLOCK_SHAPE = (8, 8)


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def _ell_arrays(
    rows: np.ndarray,
    cols: np.ndarray,
    vals: np.ndarray,
    m: int,
    n: int,
    bp: int,
    bn: int,
    dtype,
) -> tuple[np.ndarray, np.ndarray]:
    """Host-side COO -> blocked-ELL (indices (R, S), data (R, S, bp, bn)).

    ``S`` is max(nonzero tiles per block-row, 1) — even an all-zero matrix
    keeps one (zero) padding slot so downstream shapes stay static.
    Duplicate (row, col) entries resolve last-wins, matching
    ``COOMatrix.to_dense``'s scatter semantics.
    """
    R, C = _ceil_div(m, bp), _ceil_div(n, bn)
    if rows.size == 0:  # empty (or empty-slice) matrix: one zero pad slot
        return (
            np.zeros((R, 1), np.int32),
            np.zeros((R, 1, bp, bn), dtype),
        )
    br, bc = rows // bp, cols // bn
    order = np.lexsort((cols, rows))  # stable: later duplicates win
    rows, cols, vals = rows[order], cols[order], vals[order]
    br, bc = br[order], bc[order]
    key = br.astype(np.int64) * C + bc
    ukey, inv = np.unique(key, return_inverse=True)
    ubr, ubc = (ukey // C).astype(np.int64), (ukey % C).astype(np.int64)
    per_row = np.bincount(ubr, minlength=R)
    starts = np.concatenate(([0], np.cumsum(per_row)))[:-1]
    slot = np.arange(ukey.size) - starts[ubr]  # rank of tile within its row
    S = max(int(per_row.max()), 1)
    indices = np.zeros((R, S), np.int32)
    indices[ubr, slot] = ubc
    data = np.zeros((R, S, bp, bn), dtype)
    data[br, slot[inv], rows % bp, cols % bn] = vals
    return indices, data


def _balance_perm(
    local: np.ndarray,  # entry rows, external padded-local ids in [0, p_pad)
    col_blocks: np.ndarray,  # entry column-block ids
    p_pad: int,
    bp: int,
    max_sweeps: int = 50,
) -> np.ndarray:
    """Row order tightening the blocked-ELL slot count of ONE partition block.

    ``S`` is max over block-rows ("bins" of ``bp`` rows) of the number of
    DISTINCT column blocks the bin's rows touch. Steepest-descent row SWAPS
    from the identity order: every bin at the current maximum tries the
    exchange that pulls BOTH affected bins strictly below it (ties broken
    toward the fewest total tiles), until no heavy bin can shed a tile. The
    result never pads more slots than the unbalanced layout.

    Returns ``ext_pos`` (p_pad,) int32: the external row occupying each
    internal position.
    """
    nbins = p_pad // bp
    row_tiles: dict[int, frozenset] = {}
    for r, c in zip(local.tolist(), col_blocks.tolist()):
        row_tiles.setdefault(r, set()).add(c)  # type: ignore[arg-type]
    row_tiles = {r: frozenset(t) for r, t in row_tiles.items()}
    empty = frozenset()
    tiles_of = [row_tiles.get(r, empty) for r in range(p_pad)]

    members = [list(range(b * bp, (b + 1) * bp)) for b in range(nbins)]
    # per-bin tile -> number of member rows carrying it (multiplicity lets a
    # candidate removal know which tiles it would actually free)
    mult: list[dict] = []
    for b in range(nbins):
        m: dict = {}
        for r in members[b]:
            for t in tiles_of[r]:
                m[t] = m.get(t, 0) + 1
        mult.append(m)
    counts = [len(m) for m in mult]

    def swap_delta(b1, r1, b2, r2):
        """Bin tile counts after exchanging r1 (in b1) with r2 (in b2)."""
        t1, t2 = tiles_of[r1], tiles_of[r2]
        gone1 = sum(1 for t in t1 if mult[b1][t] == 1 and t not in t2)
        new1 = sum(1 for t in t2 if t not in mult[b1] and t not in t1)
        gone2 = sum(1 for t in t2 if mult[b2][t] == 1 and t not in t1)
        new2 = sum(1 for t in t1 if t not in mult[b2] and t not in t2)
        return counts[b1] - gone1 + new1, counts[b2] - gone2 + new2

    def apply_swap(b1, i1, b2, i2):
        r1, r2 = members[b1][i1], members[b2][i2]
        members[b1][i1], members[b2][i2] = r2, r1
        for b, out_r, in_r in ((b1, r1, r2), (b2, r2, r1)):
            m = mult[b]
            for t in tiles_of[out_r]:
                m[t] -= 1
                if not m[t]:
                    del m[t]
            for t in tiles_of[in_r]:
                m[t] = m.get(t, 0) + 1
            counts[b] = len(m)

    for _ in range(max_sweeps):
        improved = False
        worst = max(counts)
        for b1 in sorted(range(nbins), key=lambda b: -counts[b]):
            if counts[b1] < worst:
                break
            # lightest bins first: that's where a heavy row can land without
            # raising the max, and scanning a handful keeps the sweep cheap
            targets = sorted(
                (b for b in range(nbins) if b != b1 and counts[b] < counts[b1]),
                key=lambda b: counts[b],
            )[:8]
            best = None
            for i1 in range(bp):
                for b2 in targets:
                    for i2 in range(bp):
                        c1, c2 = swap_delta(
                            b1, members[b1][i1], b2, members[b2][i2]
                        )
                        if max(c1, c2) >= worst:
                            continue  # must pull BOTH bins under the max
                        key = (max(c1, c2), c1 + c2)
                        if best is None or key < best[0]:
                            best = (key, i1, b2, i2)
            if best is not None:
                _, i1, b2, i2 = best
                apply_swap(b1, i1, b2, i2)
                improved = True
        if not improved:
            break
    return np.concatenate([np.asarray(m) for m in members]).astype(np.int32)


def _gram_coo(rows: np.ndarray, cols: np.ndarray, vals: np.ndarray):
    """Host-side COO of G = A Aᵀ for one sparse block.

    G[i, i'] = Σ_c A[i, c] A[i', c]: group the entries by column; every
    column with t entries contributes a t×t outer product. Duplicate
    coordinates are pre-summed (``_ell_arrays`` assigns last-wins, which
    would drop accumulations otherwise).
    """
    order = np.argsort(cols, kind="stable")
    r, c, v = rows[order], cols[order], vals[order]
    gi, gj, gv = [np.empty(0, np.int64)], [np.empty(0, np.int64)], [np.empty(0)]
    if c.size:
        starts = np.flatnonzero(np.r_[True, c[1:] != c[:-1]])
        ends = np.r_[starts[1:], c.size]
        sizes = ends - starts
        single = sizes == 1
        s1 = starts[single]
        gi.append(r[s1])
        gj.append(r[s1])
        gv.append(v[s1] ** 2)
        for s, e in zip(starts[~single], ends[~single]):
            t = e - s
            gi.append(np.repeat(r[s:e], t))
            gj.append(np.tile(r[s:e], t))
            gv.append(np.outer(v[s:e], v[s:e]).ravel())
    gi, gj, gv = map(np.concatenate, (gi, gj, gv))
    if gi.size == 0:
        return gi, gj, gv
    p_span = int(gi.max()) + 1
    key = gi * p_span + gj
    ukey, inv = np.unique(key, return_inverse=True)
    summed = np.zeros(ukey.size, gv.dtype)
    np.add.at(summed, inv, gv)
    return ukey // p_span, ukey % p_span, summed


def _stack_shards(shards: list[tuple[np.ndarray, np.ndarray]]):
    """Pad per-shard ELL arrays to a common slot count and stack (host)."""
    S = max(idx.shape[1] for idx, _ in shards)
    J, R = len(shards), shards[0][0].shape[0]
    tile = shards[0][1].shape[-2:]
    idx_out = np.zeros((J, R, S), np.int32)
    data_out = np.zeros((J, R, S, *tile), shards[0][1].dtype)
    for j, (idx, data) in enumerate(shards):
        idx_out[j, :, : idx.shape[1]] = idx
        data_out[j, :, : idx.shape[1]] = data
    return idx_out, data_out


def _tensor(arr, device) -> torch.Tensor:
    """A host array as a tensor on ``device`` (read-only arrays copied)."""
    return torch.from_numpy(np.require(arr, requirements="CW")).to(device)


def _pad_cols(x: torch.Tensor, n: int, bn: int) -> torch.Tensor:
    """(..., n, k) -> (..., C, bn, k) tile view of the zero-padded column
    space."""
    n_pad = _ceil_div(n, bn) * bn
    if n_pad != n:
        x = torch.nn.functional.pad(x, (0, 0, 0, n_pad - n))
    return x.reshape(*x.shape[:-2], n_pad // bn, bn, x.shape[-1])


def _scatter_contrib(indices, contrib, num_col_blocks):
    """Scatter-add per-slot transpose contributions into the column space.

    indices (J, R, S), contrib (J, R, S, bn, k) -> (J, C*bn, k). Padding
    slots target column block 0 with zero data — they add exactly 0. On
    the card ``index_add_`` uses atomics, so the order of the sums varies
    from run to run; on the CPU it is fixed.
    """
    J, R, S, bn, k = contrib.shape
    C = num_col_blocks
    rows = (
        indices.long() + C * torch.arange(J, device=indices.device)[:, None, None]
    ).reshape(-1)
    out = torch.zeros((J * C, bn, k), dtype=contrib.dtype, device=contrib.device)
    out.index_add_(0, rows, contrib.reshape(J * R * S, bn, k))
    return out.reshape(J, C * bn, k)


def _spmm(indices, data, packed, xb, use_kernels: bool) -> torch.Tensor:
    """(J, R*bp, k) product of one shard stack: the packed kernel on its
    packed form, or (no packed form) the ELL wrapper, or the plain one."""
    if not use_kernels:
        return spmm_plain(indices, data, xb)
    if packed is None:
        return spmm_ops.spmm(indices, data, xb)
    return spmm_ops.spmm_packed(packed, xb)


@dataclasses.dataclass(frozen=True)
class BlockEll:
    """Blocked-ELL matrix: (R, S) tile indices + (R, S, bp, bn) tile data.

    Logical shape is ``shape``; rows/cols are zero-padded up to the tile
    grid (``R*bp``, ``C*bn``). Padding slots carry index 0 and zero data.
    """

    indices: torch.Tensor  # (R, S) int32 column-block ids
    data: torch.Tensor  # (R, S, bp, bn)
    shape: tuple[int, int]  # logical (m, n)

    @property
    def block_shape(self) -> tuple[int, int]:
        return tuple(self.data.shape[-2:])

    @property
    def num_block_rows(self) -> int:
        return self.indices.shape[0]

    @property
    def slots(self) -> int:
        return self.indices.shape[1]

    @property
    def nbytes(self) -> int:
        return int(sum(t.numel() * t.element_size() for t in (self.indices, self.data)))

    @property
    def dense_bytes(self) -> int:
        """What a densified copy of the logical matrix would cost."""
        m, n = self.shape
        return int(m * n * self.data.element_size())

    @staticmethod
    def from_coo(
        coo: COOMatrix,
        block_shape: tuple[int, int] = DEFAULT_BLOCK_SHAPE,
        dtype=np.float32,
        device=None,
    ) -> "BlockEll":
        """Convert host COO to blocked-ELL on ``device``."""
        m, n = coo.shape
        bp, bn = block_shape
        idx, data = _ell_arrays(
            coo.rows.astype(np.int64), coo.cols.astype(np.int64),
            coo.vals, m, n, bp, bn, np.dtype(dtype),
        )
        dev = resolve_device(device)
        return BlockEll(_tensor(idx, dev), _tensor(data, dev), (m, n))

    def slice_row_blocks(self, start: int, stop: int) -> "BlockEll":
        """Rows [start, stop) as a new BlockEll — a view of the tile arrays.

        Both bounds must sit on block-row boundaries; nothing is densified.
        """
        bp = self.block_shape[0]
        if start % bp or stop % bp:
            raise ValueError(
                f"slice bounds ({start}, {stop}) must be multiples of bp={bp}"
            )
        r0, r1 = start // bp, stop // bp
        if not 0 <= r0 <= r1 <= self.num_block_rows:
            raise ValueError(f"slice ({start}, {stop}) out of range")
        return BlockEll(
            self.indices[r0:r1], self.data[r0:r1], (stop - start, self.shape[1])
        )

    def matmul(self, x: torch.Tensor) -> torch.Tensor:
        """Blocked-ELL @ x for x (n, k); returns (R*bp, k) (padded rows kept)."""
        xb = _pad_cols(x, self.shape[1], self.block_shape[1])
        return spmm_plain(self.indices[None], self.data[None], xb[None])[0]

    def to_dense(self) -> np.ndarray:
        """Densify (tests/debug only) — the logical (m, n) matrix."""
        idx = self.indices.cpu().numpy()
        data = self.data.cpu().numpy()
        R, S = idx.shape
        bp, bn = data.shape[-2:]
        C = _ceil_div(self.shape[1], bn)
        out = np.zeros((R, C, bp, bn), data.dtype)
        r = np.repeat(np.arange(R), S)
        # padding slots all target block 0 with zero data: += keeps them inert
        np.add.at(out, (r, idx.ravel()), data.reshape(R * S, bp, bn))
        dense = out.transpose(0, 2, 1, 3).reshape(R * bp, C * bn)
        return dense[: self.shape[0], : self.shape[1]]


_ARRAY_FIELDS = (
    "fwd_indices", "fwd_data", "tra_indices", "tra_data",
    "gram_indices", "gram_data", "ext_pos", "int_pos",
)


@dataclasses.dataclass(frozen=True)
class PartitionedBSR:
    """J-way uniform row partition of a sparse matrix, blocked-ELL per shard.

    ``fwd_*`` holds the A_j shards ((J, Rp, S) tiles of (bp, bn)) — the only
    mandatory representation: ``rmatvec`` scatter-adds transposed tile
    products straight from it. ``with_transpose=True`` additionally stores
    the A_jᵀ shards (``tra_*``, (J, Rn, T) tiles of (bn, bp)), which the
    kernel path's ``rmatvec`` and ``fused_project`` stream through the SpMM
    kernels.
    ``with_gram=True`` stores the Gram operators G_j = A_j A_jᵀ as (p, p)
    blocked-ELL shards (``gram_*``), the inner-CG operator.

    ``balance=True`` stores the forward/transpose tiles in a per-block
    balanced row order: ``ext_pos[j, q]`` is the external row at internal
    position q and ``int_pos[j, q]`` its inverse. The Gram shards and every
    public product keep the EXTERNAL row order.

    ``fwd_packed``/``tra_packed``/``gram_packed`` are the packed-nonzero
    forms of the stored shards (``with_packed``): derived, not state, so
    ``to_arrays`` leaves them out and ``from_arrays(packed=True)`` rebuilds
    them. The matrix-free solver builds them on the card when it runs with
    kernels; ``nbytes`` counts them.

    ``shard = (start, stop, J)`` marks a placed operator (``place``): it
    holds blocks [start, stop) of a J-block operator, while ``shape``, ``p``
    and ``p_pad`` stay the whole system's. ``block_rhs`` then returns this
    shard's rows only.
    """

    fwd_indices: torch.Tensor  # (J, Rp, S) int32
    fwd_data: torch.Tensor  # (J, Rp, S, bp, bn)
    shape: tuple[int, int]  # logical (m, n) of the whole system
    p: int  # logical rows per partition block (ceil(m / J))
    p_pad: int  # block rows padded to the tile grid
    tra_indices: torch.Tensor | None = None  # (J, Rn, T) int32
    tra_data: torch.Tensor | None = None  # (J, Rn, T, bn, bp)
    gram_indices: torch.Tensor | None = None  # (J, Rp, Sg) int32
    gram_data: torch.Tensor | None = None  # (J, Rp, Sg, bp, bp)
    ext_pos: torch.Tensor | None = None  # (J, p_pad) int32: internal -> external
    int_pos: torch.Tensor | None = None  # (J, p_pad) int32: external -> internal
    planned: bool = False  # built from a non-uniform PartitionPlan
    fwd_packed: Packed | None = dataclasses.field(default=None, repr=False)
    tra_packed: Packed | None = dataclasses.field(default=None, repr=False)
    gram_packed: Packed | None = dataclasses.field(default=None, repr=False)
    shard: tuple[int, int, int] | None = None  # placed: (start, stop, J)

    @property
    def device(self) -> torch.device:
        return self.fwd_data.device

    @property
    def num_blocks(self) -> int:
        """Blocks held here (a placed shard's own)."""
        return self.fwd_indices.shape[0]

    @property
    def global_blocks(self) -> int:
        """Blocks of the whole operator (J, also for a placed shard)."""
        return self.num_blocks if self.shard is None else self.shard[2]

    @property
    def num_cols(self) -> int:
        return self.shape[1]

    @property
    def block_shape(self) -> tuple[int, int]:
        return tuple(self.fwd_data.shape[-2:])

    @property
    def nbytes(self) -> int:
        """Device-resident bytes of the sparse operator (all present parts,
        the packed forms included)."""
        arrs = (getattr(self, f) for f in _ARRAY_FIELDS)
        total = sum(a.numel() * a.element_size() for a in arrs if a is not None)
        packs = (self.fwd_packed, self.tra_packed, self.gram_packed)
        return int(total + sum(p.nbytes for p in packs if p is not None))

    @property
    def dense_bytes(self) -> int:
        """What the dense path's (J, p, n) ``blocks`` array would cost."""
        return int(
            self.global_blocks * self.p_pad * self.shape[1]
            * self.fwd_data.element_size()
        )

    @staticmethod
    def from_coo(
        coo: COOMatrix,
        num_blocks: int,
        block_shape: tuple[int, int] = DEFAULT_BLOCK_SHAPE,
        dtype=np.float32,
        with_transpose: bool = False,
        with_gram: bool = False,
        balance: bool = False,
        plan=None,
        device=None,
    ) -> "PartitionedBSR":
        """Partition + convert on the host, never densifying; the finished
        arrays land on ``device``.

        Builds one blocked-ELL layout over the zero-padded (J·p_pad, n) row
        space and cuts the J forward shards out of it. ``with_transpose``
        adds the A_jᵀ shards, ``with_gram`` the sparse G_j = A_j A_jᵀ
        shards, ``balance`` the per-block load-balanced row order (see
        ``_balance_perm``).

        ``plan`` (a ``repro_torch.core.partition.PartitionPlan``) overrides
        the uniform contiguous row→block map: block heights become the
        plan's max count and ragged blocks absorb the slack as zero padding
        rows. A planned operator's ``block_rhs`` is plan-order; use the
        owning solver's plan-aware ``block_rhs`` for original-order RHS.
        """
        m, n = coo.shape
        bp, bn = block_shape
        J = num_blocks
        use_plan = plan is not None and plan.kind != "uniform"
        if use_plan and (plan.m != m or plan.num_blocks != J):
            raise ValueError(
                f"plan is for (m={plan.m}, J={plan.num_blocks}), "
                f"got (m={m}, J={J})"
            )
        dev = resolve_device(device)
        p = plan.max_rows if use_plan else _ceil_div(m, J)
        p_pad = _ceil_div(p, bp) * bp
        dtype = np.dtype(dtype)

        rows = coo.rows.astype(np.int64)
        cols = coo.cols.astype(np.int64)
        vals = coo.vals
        # dedupe coordinates up front (last-wins, matching to_dense): the
        # Gram builder SUMS per-coordinate contributions, so duplicates
        # must be resolved once here or the inner-CG operator would
        # disagree with the forward shards
        if rows.size:
            key = rows * n + cols
            order = np.argsort(key, kind="stable")
            keep = np.ones(order.size, dtype=bool)
            keep[:-1] = key[order][1:] != key[order][:-1]
            sel = order[keep]
            rows, cols, vals = rows[sel], cols[sel], vals[sel]
        if use_plan:
            blk = plan.assignment.astype(np.int64)[rows]
            local = plan.slots[rows]
        else:
            blk = rows // p
            local = rows % p

        ext_np = int_np = None
        tile_local = local  # internal (tile-layout) row of every entry
        if balance:
            ext_np = np.stack(
                [
                    _balance_perm(
                        local[blk == j], cols[blk == j] // bn, p_pad, bp
                    )
                    for j in range(J)
                ]
            )
            int_np = np.empty_like(ext_np)
            np.put_along_axis(
                int_np, ext_np, np.broadcast_to(
                    np.arange(p_pad, dtype=np.int32), (J, p_pad)
                ), axis=1,
            )
            tile_local = int_np[blk, local].astype(np.int64)

        # global padded layout: block j owns rows [j*p_pad, j*p_pad + p_pad);
        # the shards of one parent share S, so they stack without re-padding
        fwd_idx, fwd_data = _ell_arrays(
            blk * p_pad + tile_local, cols, vals, J * p_pad, n, bp, bn, dtype
        )
        Rp = p_pad // bp
        fwd_idx = fwd_idx.reshape(J, Rp, -1)
        fwd_data = fwd_data.reshape(J, Rp, -1, bp, bn)

        tra = gram = (None, None)
        if with_transpose:
            tra = _stack_shards(
                [
                    _ell_arrays(
                        cols[blk == j], tile_local[blk == j],
                        vals[blk == j], n, p_pad, bn, bp, dtype,
                    )
                    for j in range(J)
                ]
            )
        # Gram shards stay in the EXTERNAL row order: the inner CG runs on
        # unpermuted vectors, so its hot loop never touches the permutation
        if with_gram:
            gram = _stack_shards(
                [
                    _ell_arrays(
                        *_gram_coo(local[blk == j], cols[blk == j], vals[blk == j]),
                        p_pad, p_pad, bp, bp, dtype,
                    )
                    for j in range(J)
                ]
            )

        def put(a):
            return None if a is None else _tensor(a, dev)

        return PartitionedBSR(
            put(fwd_idx), put(fwd_data), (m, n), p, p_pad,
            tra_indices=put(tra[0]), tra_data=put(tra[1]),
            gram_indices=put(gram[0]), gram_data=put(gram[1]),
            ext_pos=put(ext_np), int_pos=put(int_np), planned=use_plan,
        )

    def with_packed(self) -> "PartitionedBSR":
        """This operator plus the packed-nonzero form of every stored shard
        stack (``kernels.spmm.pack``), built on the operator's device."""

        def packed(indices, data):
            return None if indices is None else pack(indices, data)

        return dataclasses.replace(
            self,
            fwd_packed=packed(self.fwd_indices, self.fwd_data),
            tra_packed=packed(self.tra_indices, self.tra_data),
            gram_packed=packed(self.gram_indices, self.gram_data),
        )

    # -- mesh placement ------------------------------------------------------

    def shard_spec(self, mesh, axes: tuple[str, ...]) -> dict:
        """Per present child array, the ``(start, stop)`` block range of every
        shard of the mesh axes ``axes``, in shard order.

        Every child stacks its per-block shards on axis 0, so each gets the
        same contiguous ranges of J/D blocks (the reference's
        ``PartitionSpec(axes)`` on axis 0). Raises unless D divides J.
        """
        from repro_torch.core.matfree_sharded import mesh_block_devices

        D = mesh_block_devices(mesh, tuple(axes))
        J = self.global_blocks
        if J % D:
            raise ValueError(
                f"num_blocks={J} not divisible over the {D} devices of mesh "
                f"axes {tuple(axes)}"
            )
        per = J // D
        ranges = [(d * per, (d + 1) * per) for d in range(D)]
        return {
            name: ranges for name in _ARRAY_FIELDS if getattr(self, name) is not None
        }

    def place(self, mesh, axes: tuple[str, ...], device=None) -> "PartitionedBSR":
        """This rank's contiguous group of J/D blocks of every child array,
        moved to ``device`` (``None``: the mesh's device on this rank).

        Build the operator in host memory and place it: only this rank's
        blocks reach the card. Packed forms, when the source has them, are
        rebuilt for the shard on the device.
        """
        from repro_torch.core.collectives import mesh_axes_group
        from repro_torch.core.matfree_sharded import mesh_device

        spec = self.shard_spec(mesh, axes)
        start, stop = next(iter(spec.values()))[mesh_axes_group(mesh, tuple(axes)).index]
        dev = mesh_device(mesh) if device is None else resolve_device(device)
        kept = {
            name: getattr(self, name)[start:stop].to(dev)
            for name in spec
        }
        placed = dataclasses.replace(
            self, **kept, fwd_packed=None, tra_packed=None, gram_packed=None,
            shard=(start, stop, self.global_blocks),
        )
        return placed.with_packed() if self.fwd_packed is not None else placed

    # -- balanced-layout translation -----------------------------------------

    @staticmethod
    def _permute(rows: torch.Tensor, pos: torch.Tensor | None) -> torch.Tensor:
        if pos is None:
            return rows
        index = pos.long()[..., None].expand(-1, -1, rows.shape[-1])
        return torch.gather(rows, 1, index)

    def _to_external(self, rows: torch.Tensor) -> torch.Tensor:
        """Internal (tile-layout) block rows (J, p_pad, k) -> external order."""
        return self._permute(rows, self.int_pos)

    def _to_internal(self, rows: torch.Tensor) -> torch.Tensor:
        """External block rows (J, p_pad, k) -> internal tile-layout order."""
        return self._permute(rows, self.ext_pos)

    def _col_tiles(self, x: torch.Tensor) -> torch.Tensor:
        """x (n, k) or (J, n, k) -> the (J, C, bn, k) tile view the products
        read. A broadcast (n, k) operand is padded once and expanded over J
        with a zero stride, never copied J times."""
        xb = _pad_cols(x, self.shape[1], self.block_shape[1])
        if x.ndim == 2:
            xb = xb[None].expand(self.num_blocks, *xb.shape)
        return xb

    # -- products -----------------------------------------------------------

    def matvec(self, x: torch.Tensor, use_kernels: bool = False) -> torch.Tensor:
        """A_j x_j for every block: x (J, n, k) — or (n, k), broadcast to all
        blocks — returns (J, p_pad, k). Padded rows come back exactly zero."""
        out = _spmm(self.fwd_indices, self.fwd_data, self.fwd_packed, self._col_tiles(x),
                    use_kernels)
        return self._to_external(out)

    def rmatvec(self, y: torch.Tensor, use_kernels: bool = False) -> torch.Tensor:
        """A_jᵀ y_j for every block: y (J, p_pad, k) -> (J, n, k).

        Runs off the transposed shards when they are stored (the kernel path
        requires them); otherwise scatter-adds transposed tile products
        straight from the forward shards.
        """
        n = self.shape[1]
        bp, bn = self.block_shape
        y = self._to_internal(y)
        if use_kernels or self.tra_indices is not None:
            if self.tra_indices is None:
                raise ValueError(
                    "kernel rmatvec needs the transposed shards: build with "
                    "PartitionedBSR.from_coo(..., with_transpose=True)"
                )
            yb = _pad_cols(y, self.p_pad, bp)
            return _spmm(self.tra_indices, self.tra_data, self.tra_packed, yb, use_kernels)[:, :n]
        J = self.num_blocks
        yb = y.reshape(J, self.p_pad // bp, bp, -1)
        contrib = torch.einsum("jrspb,jrpk->jrsbk", self.fwd_data, yb)
        return _scatter_contrib(self.fwd_indices, contrib, _ceil_div(n, bn))[:, :n]

    def fused_project(
        self, x: torch.Tensor, y: torch.Tensor, use_kernels: bool = False
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """(A_j x, A_jᵀ y_j): the matrix-free epoch's two tile products.

        x (n, k) (broadcast to every block) or (J, n, k); y (J, p_pad, k).
        Returns the forward product (J, p_pad, k) and the transposed product
        (J, n, k). With kernels and both packed forms stored (the solver's
        path on the card), one ``spmm_fused_packed`` launch computes both, the
        transpose over the transposed shards' packed form with one writer per
        output row. Otherwise one pass over the forward ELL tiles feeds both
        contractions (the staged ``spmm_fused`` kernel under ``use_kernels``,
        the plain version without): the per-slot transpose contributions are
        staged and scatter-added here (``index_add_``).
        """
        J, n = self.num_blocks, self.shape[1]
        bp, bn = self.block_shape
        xb = self._col_tiles(x)
        yb = self._to_internal(y).reshape(J, self.p_pad // bp, bp, -1)
        if use_kernels and self.fwd_packed is not None and self.tra_packed is not None:
            fwd, tra = spmm_ops.spmm_fused_packed(self.fwd_packed, self.tra_packed, xb, yb)
        else:
            fused = spmm_ops.spmm_fused if use_kernels else spmm_fused_plain
            fwd, contrib = fused(self.fwd_indices, self.fwd_data, xb, yb)
            tra = _scatter_contrib(self.fwd_indices, contrib, _ceil_div(n, bn))
        return self._to_external(fwd), tra[:, :n]

    def gram_mv(self, y: torch.Tensor, use_kernels: bool = False) -> torch.Tensor:
        """(A_j A_jᵀ) y_j via the stored sparse Gram shards (or, without
        them, as rmatvec-then-matvec): (J, p_pad, k) -> (J, p_pad, k)."""
        if self.gram_indices is None:
            return self.matvec(self.rmatvec(y, use_kernels), use_kernels)
        yb = _pad_cols(y, self.p_pad, self.block_shape[0])
        return _spmm(self.gram_indices, self.gram_data, self.gram_packed, yb, use_kernels)

    def gram_diag(self) -> torch.Tensor:
        """diag(A_j A_jᵀ) per block — (J, p_pad) row sums of squares in
        float32, the Jacobi preconditioner for the inner CG (zero on padded
        rows)."""
        sq = torch.sum(self.fwd_data.to(torch.float32) ** 2, dim=(2, 4))
        sq = sq.reshape(self.num_blocks, self.p_pad)
        if self.int_pos is None:
            return sq
        return torch.gather(sq, 1, self.int_pos.long())

    def jacobi_weights(self, eps: float = 1e-10) -> torch.Tensor:
        """Inverse Gram diagonal (J, p_pad, 1), the inner-CG Jacobi weights.

        The clamp is RELATIVE: near-zero but nonzero diagonals are bounded
        at ``1 / (max_block_diag * eps)``; exactly-zero diagonals (the
        padding rows) keep weight 0 so their iterates stay pinned at zero.
        """
        diag = self.gram_diag()
        floor = torch.amax(diag, dim=1, keepdim=True) * eps
        inv = 1.0 / torch.maximum(diag, floor)
        return torch.where(diag > 0, inv, torch.zeros_like(inv))[..., None]

    def slot_occupancy(self) -> tuple[int, float]:
        """(S, mean occupied slots per block-row) of the forward shards."""
        occupied = torch.any(self.fwd_data != 0, dim=-1).any(dim=-1).sum(dim=-1)
        return int(self.fwd_indices.shape[-1]), float(occupied.double().mean())

    # -- checkpoint serialization --------------------------------------------

    def to_arrays(self, prefix: str = "op_") -> tuple[dict, dict]:
        """Flatten to plain numpy arrays + JSON-able metadata, in the JAX
        package's format: every present array child under ``prefix +
        field_name``, the static shape metadata in ``meta``."""
        arrays: dict = {}
        for name in _ARRAY_FIELDS:
            value = getattr(self, name)
            if value is not None:
                arrays[prefix + name] = value.detach().cpu().numpy()
        meta = {
            "shape": list(self.shape), "p": int(self.p), "p_pad": int(self.p_pad),
            "planned": bool(self.planned),
        }
        return arrays, meta

    @classmethod
    def from_arrays(cls, arrays, meta: dict, prefix: str = "op_", device=None,
                    packed: bool = False):
        """Rebuild on ``device`` from ``to_arrays`` output — this package's
        or the JAX package's (extra keys in ``arrays`` are ignored);
        ``packed`` rebuilds the packed forms too (``with_packed``)."""
        dev = resolve_device(device)
        kwargs = {
            name: _tensor(np.asarray(arrays[prefix + name]), dev)
            for name in _ARRAY_FIELDS
            if prefix + name in arrays
        }
        op = cls(
            shape=tuple(meta["shape"]), p=int(meta["p"]),
            p_pad=int(meta["p_pad"]),
            planned=bool(meta.get("planned", False)), **kwargs,
        )
        return op.with_packed() if packed else op

    def block_rhs(self, b: np.ndarray) -> torch.Tensor:
        """RHS (m,) or (m, k) -> (J, p_pad, k) on the device, zero-padded
        like the rows."""
        if self.planned:
            # the uniform rows//p scatter below would misplace entries; the
            # owning solver holds the plan and does the plan-aware scatter
            raise ValueError(
                "operator was built from a non-uniform PartitionPlan; use "
                "the prepared solver's block_rhs (it owns the plan)"
            )
        b = np.asarray(b)
        if b.ndim == 1:
            b = b[:, None]
        m = self.shape[0]
        if b.shape[0] != m:
            raise ValueError(f"expected {m} rows, got {b.shape[0]}")
        rows = np.arange(m)
        return self._scatter_rhs(b, (rows // self.p) * self.p_pad + rows % self.p)

    def _scatter_rhs(self, b: np.ndarray, dest: np.ndarray) -> torch.Tensor:
        """Rows of ``b`` (m, k) placed at ``dest`` of a zero (J·p_pad, k)
        host array in the operator's dtype; the blocks held here (a placed
        shard's own) move to the device."""
        dtype = torch.empty(0, dtype=self.fwd_data.dtype).numpy().dtype
        out = np.zeros((self.global_blocks * self.p_pad, b.shape[1]), dtype)
        out[dest] = b
        out = out.reshape(self.global_blocks, self.p_pad, -1)
        if self.shard is not None:
            out = out[self.shard[0]:self.shard[1]]
        return _tensor(out, self.device)
