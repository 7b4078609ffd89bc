"""Alternating least squares: training, and the model it serves.

The port of `predictionio_tpu/ops/als.py` (MLlib `ALS` semantics:
ALS-WR regularization `reg * n_row`, `abs(normal) / sqrt(rank)` init,
explicit and Hu-Koren-Volinsky implicit feedback), single device.

  1. Host packing is a numpy copy of the JAX package's, bit for bit:
     COO ratings grouped by row, rows bucketed by degree on a x1.25
     cap ladder, buckets split into slabs under the transient budgets.
     Slot padding carries idx == -1; a slab of odd row count gets one
     `_FILL_ROW` row, a remnant of the JAX package's row pairing, kept
     so that the slab layout is the same; it is never written.
  2. `device_slabs` uploads the ragged entries only and pads them on
     the device.
  3. One half-step solves every row of one side against the other:
     rank <= 16 slab by slab through the exact path (`_solve_bucket`,
     batched Cholesky); larger ranks through `_solve_batch`: per slab
     the gathered opposite rows in the `cast` dtype (bf16 by default)
     and the Gram accumulated in fp32, then one Jacobi-CG, warm-started
     from the current rows, over all the slabs that fit
     `_CG_BATCH_BUDGET` (the whole side at MovieLens-25M's shape). The
     JAX package pairs consecutive rows to fill 128x128 MXU tiles (its
     `_solve_slab_paired`) and runs CG per slab; the port solves each
     row as its own system, so its CG scalars are per row, not per
     pair, and it converges at least as fast.
  4. `_run_als` alternates users and items in place, eagerly: with one
     CG per side an iteration is some 530 launches, which the host
     enqueues in a quarter of the time the card takes to run them, so a
     CUDA graph of the iteration (the counterpart of the JAX package's
     one compiled `fori_loop`) gains nothing measurable (PERF.md).

Streaming fold-in (`fold_in_rows`) re-solves given rows against fixed
opposite factors: one exact half-step through `_solve_bucket` (batched
Cholesky at rank <= 16, CG from zero at larger ranks) on the device of
the opposite factors, the rows bucketed by degree as training buckets
them.

Not ported yet: the sharded loop (`_run_als_sharded`, `_pack_by_owner`,
`hbm_footprint`).

The model: `ALSModel` holds the factor matrices as tensors plus the id
maps. The user factors live on the serving device. The item factors
(the item master) live there too, or in host RAM when they are loaded
with `items_device="cpu"`: a catalog that a serving plan shards over
several cards or tiers (a hot slab on the card, the rest on the host)
is never placed whole on one card. A model trained by the JAX package is
carried over as numpy arrays (`als_model_from_numpy`) or through an
`.npz` file (`save_npz` / `load_npz`), which holds the two factor
matrices and both id lists and needs no pickle.
"""

from __future__ import annotations

import logging
import math
import time
from dataclasses import dataclass
from pathlib import Path
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from predictionio_tpu_torch.device import resolve_device
from predictionio_tpu_torch.ingest.arrays import RatingColumns
from predictionio_tpu_torch.ingest.bimap import BiMap
from predictionio_tpu_torch.ops.linalg import exact_fp32, pcg_solve, spd_solve

# degree-bucket caps: BASE, then x GROWTH steps rounded up to a multiple
# of 8; a row of degree d lands in the smallest bucket with cap >= d
_BUCKET_BASE = 16
_BUCKET_GROWTH = 1.25

# sentinel row index of a slab's even-count padding row (never written)
_FILL_ROW = np.int32(2**31 - 1)

# ranks <= this solve through the exact batched Cholesky
_SMALL_RANK = 16

# warm-started CG iterations on the rank > _SMALL_RANK path (the JAX
# package's default; the residual is tracked and surfaced)
_CG_ITERS = 8

# per-slab transient budgets (bytes, f32): a slab of B rows x cap K at
# rank R is split so that B*K*R*4 <= gather budget and B*R*R*4 <=
# normal budget
_SLAB_GATHER_BUDGET = 2 << 30
_SLAB_NORMAL_BUDGET = 512 << 20

# bytes of f32 normal matrices one CG solve may hold: consecutive slabs
# of a side share one CG (one launch sequence) up to it. The slab
# budgets above still bound each slab's gathered copy
_CG_BATCH_BUDGET = 4 << 30

# keeps observed implicit entries with zero confidence alive through the
# square-root-of-confidence weights (see `_prepare_side`)
_EPS = 1e-12

_log = logging.getLogger(__name__)


def _cap_ladder(max_count: int) -> np.ndarray:
    """Bucket caps: BASE, then x_BUCKET_GROWTH steps rounded up to a
    multiple of 8, up to max_count."""
    caps = [_BUCKET_BASE]
    while caps[-1] < max_count:
        caps.append(int(math.ceil(caps[-1] * _BUCKET_GROWTH / 8) * 8))
    return np.asarray(caps, np.int64)


@dataclass
class _SideBuckets:
    """Degree-bucketed CSR for one side (one entry per slab), stored
    ragged: per-row counts + concatenated idx/val. `padded()` is the
    host form; `device_slabs` pads on the device."""
    rows: List[np.ndarray]     # [rows_b] row indexes into this side
    counts: List[np.ndarray]   # [rows_b] real entries per row
    idx: List[np.ndarray]      # [entries_b] ragged opposite-side indexes
    val: List[np.ndarray]      # [entries_b] ragged ratings
    caps: List[int]            # bucket cap (padded row width) per slab
    n_rows: int

    def padded(self, j: int) -> Tuple[np.ndarray, np.ndarray]:
        """Host materialization of slab j as ([rows_b, cap] idx with -1
        padding, [rows_b, cap] val)."""
        counts, cap = self.counts[j], self.caps[j]
        nb = len(counts)
        member, intra = _group_offsets(counts)
        idx = np.full((nb, cap), -1, np.int32)
        val = np.zeros((nb, cap), np.float32)
        idx[member, intra] = self.idx[j]
        val[member, intra] = self.val[j]
        return idx, val


def _group_offsets(counts: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Destination coordinates for a ragged->padded scatter of items laid
    out in stable group order: `member[j]` is item j's group index,
    `intra[j]` its offset within the group."""
    total = int(counts.sum())
    member = np.repeat(np.arange(len(counts)), counts)
    intra = np.arange(total) - np.repeat(np.cumsum(counts) - counts, counts)
    return member, intra


def _pack_side(row_ix: np.ndarray, col_ix: np.ndarray, val: np.ndarray,
               n_rows: int, rank: Optional[int] = None) -> _SideBuckets:
    """Group COO entries by row, then bucket rows by degree into slabs
    (host, vectorized). With `rank`, oversized buckets are split into
    row chunks so each slab's solve transients stay inside the
    budgets."""
    order = np.argsort(row_ix, kind="stable")
    r, c, v = row_ix[order], col_ix[order], val[order]
    uniq, starts, counts = np.unique(r, return_index=True, return_counts=True)
    ladder = _cap_ladder(int(counts.max()) if len(counts) else _BUCKET_BASE)
    caps_per_row = ladder[np.searchsorted(ladder, counts)]
    out = _SideBuckets([], [], [], [], [], n_rows)
    for cap in np.unique(caps_per_row):
        sel = caps_per_row == cap
        rows = uniq[sel].astype(np.int32)
        m_starts, m_counts = starts[sel], counts[sel]
        nb = len(rows)
        member_of, intra = _group_offsets(m_counts)
        src = np.repeat(m_starts, m_counts) + intra
        ends = np.cumsum(m_counts)
        if rank is None:
            chunk = nb
        else:
            chunk = max(2, min(_SLAB_NORMAL_BUDGET // (rank * rank * 4),
                               _SLAB_GATHER_BUDGET // (int(cap) * rank * 4)))
            chunk -= chunk % 2
        for s in range(0, nb, max(chunk, 1)):
            e = min(s + chunk, nb)
            rws, cnts = rows[s:e], m_counts[s:e].astype(np.int32)
            lo = ends[s - 1] if s else 0
            src_se = src[lo:ends[e - 1]]
            if len(rws) % 2:
                rws = np.concatenate([rws, np.asarray([_FILL_ROW], np.int32)])
                cnts = np.concatenate([cnts, np.zeros(1, np.int32)])
            out.rows.append(rws)
            out.counts.append(cnts)
            out.idx.append(c[src_se].astype(np.int32))
            out.val.append(v[src_se].astype(np.float32))
            out.caps.append(int(cap))
    return out


def _pad_side_device(rows_c: torch.Tensor, counts_c: torch.Tensor,
                     idx_c: torch.Tensor, val_c: torch.Tensor,
                     meta: Sequence[Tuple[int, int, int]]) -> List[tuple]:
    """Ragged -> padded slabs on the device. Inputs are a side's slabs
    concatenated; `meta` is the ((rows_j, entries_j, cap_j), ...) slab
    table. Returns (rows, idx, val) per slab, idx carrying -1 slot
    padding. `output_size` keeps `repeat_interleave` free of host
    syncs."""
    dev = rows_c.device
    out = []
    ro = eo = 0
    for nb, ne, cap in meta:
        rows = rows_c[ro:ro + nb]
        counts = counts_c[ro:ro + nb].long()
        starts = torch.cumsum(counts, 0) - counts
        slot = torch.arange(nb, device=dev) * cap - starts
        pos = torch.arange(ne, device=dev) + torch.repeat_interleave(
            slot, counts, output_size=ne)
        idx = torch.full((nb * cap,), -1, dtype=torch.int32, device=dev)
        idx[pos] = idx_c[eo:eo + ne]
        val = torch.zeros(nb * cap, dtype=val_c.dtype, device=dev)
        val[pos] = val_c[eo:eo + ne]
        out.append((rows, idx.view(nb, cap), val.view(nb, cap)))
        ro += nb
        eo += ne
    return out


def device_slabs(side: _SideBuckets, val_dtype: torch.dtype = torch.float32,
                 device=None) -> List[tuple]:
    """Upload one side's slabs as (rows int32 [B], padded idx int32
    [B, cap], padded val [B, cap]) tensors on `device` (None = cuda).
    Only the ragged entries cross, as four uploads, and are padded on
    the device. `val_dtype` is bfloat16 only under `als_train`'s rule."""
    dev = resolve_device(device)
    meta = tuple((len(side.counts[j]), len(side.idx[j]), side.caps[j])
                 for j in range(len(side.rows)))
    if not meta:
        return []
    vals = torch.from_numpy(np.concatenate(side.val)).to(val_dtype)
    return _pad_side_device(
        torch.from_numpy(np.concatenate(side.rows)).to(dev),
        torch.from_numpy(np.concatenate(side.counts)).to(dev),
        torch.from_numpy(np.concatenate(side.idx)).to(dev),
        vals.to(dev), meta)


@dataclass
class PackedRatings:
    """Degree-bucketed slabs for both sides of a rating matrix — the
    reusable output of `pack_ratings` (pack once, train many times)."""
    user_side: _SideBuckets
    item_side: _SideBuckets
    n_users: int
    n_items: int
    rank: int


def pack_ratings(u_ix: np.ndarray, i_ix: np.ndarray, val: np.ndarray,
                 n_users: int, n_items: int, rank: int) -> PackedRatings:
    """Host-side packing of COO ratings into solver slabs for both
    alternation sides, with rank-aware memory-budget slab splitting."""
    return PackedRatings(
        user_side=_pack_side(u_ix, i_ix, val, n_users, rank),
        item_side=_pack_side(i_ix, u_ix, val, n_items, rank),
        n_users=n_users, n_items=n_items, rank=rank)


def padded_entries(packed: PackedRatings) -> int:
    """Padded slab entries of both sides: the slots one iteration reads."""
    return sum(len(rows) * k for side in (packed.user_side, packed.item_side)
               for rows, k in zip(side.rows, side.caps))


def iteration_flops(packed: PackedRatings, cg_iters: int = _CG_ITERS) -> int:
    """FLOPs of ONE full iteration (both half-steps) as the port runs it,
    over the padded slab shapes (multiply-add = 2 FLOPs). Unlike the
    JAX package's count, it has no junk cross blocks: the port solves
    each row as its own system. Per slab of B rows x cap K at rank R:

    rank > _SMALL_RANK: Gram 2*B*K*R^2 (the full R x R product), rhs
      2*B*K*R; CG per iteration a matvec 2*B*R^2 and 12*B*R of vector
      work (two dot products, three axpys, the preconditioner), plus the
      warm-start and true-residual matvecs 4*B*R^2.
    rank <= _SMALL_RANK: Gram + rhs as above, Cholesky and the two
      triangular solves ~2*(R^3/3 + 2*R^2) per row."""
    r = packed.rank
    total = 0
    for side in (packed.user_side, packed.item_side):
        for rows, k in zip(side.rows, side.caps):
            b = len(rows)
            total += 2 * b * k * r * r + 2 * b * k * r
            if r > _SMALL_RANK:
                total += b * cg_iters * (2 * r * r + 12 * r) + 4 * b * r * r
            else:
                total += b * 2 * (r ** 3 // 3 + 2 * r * r)
    return total


def _bmm_f32(a: torch.Tensor, b: torch.Tensor,
             out: torch.Tensor) -> torch.Tensor:
    """a @ b accumulated in fp32 into `out`; bf16 operands go through
    cuBLAS's fp32-output bf16 product (CUDA only: the CPU caller upcasts
    first). A product of two bf16 values is exact in fp32, so either way
    only the summation order differs."""
    if a.dtype == torch.float32:
        return torch.bmm(a, b, out=out)
    return torch.bmm(a, b, out_dtype=torch.float32, out=out)


def _solve_bucket(factors: torch.Tensor, idx: torch.Tensor,
                  val: torch.Tensor, reg: float, alpha: float,
                  yty: Optional[torch.Tensor], *,
                  implicit: bool) -> torch.Tensor:
    """Solve the normal equations of one slab — the exact f32 path.

    factors: [n_opposite, rank] opposite-side factors
    idx/val: [rows_b, cap_b]; slot padding carries idx == -1
    yty: [rank, rank] Gram matrix of the opposite factors (implicit)
    Returns [rows_b, rank] solutions; empty rows get an identity system
    and a zero solution. rank <= _SMALL_RANK solves by batched Cholesky,
    larger ranks by Jacobi-CG with min(32, rank + 8) iterations from
    zero."""
    rank = factors.shape[1]
    with exact_fp32():
        msk = (idx >= 0).to(factors.dtype)                  # [B, K]
        val = val.to(factors.dtype)
        yg = factors[idx.clamp_min(0).long()] * msk[..., None]
        if implicit:
            # MLlib trainImplicit semantics: confidence c = 1 + alpha*|r|,
            # preference p = 1 iff r > 0
            conf = alpha * val.abs() * msk                  # c - 1
            pref = (val > 0).to(factors.dtype)
            a = torch.bmm((yg * conf[..., None]).mT, yg) + yty
            rhs = pref * (1.0 + conf) * msk
        else:
            a = torch.bmm(yg.mT, yg)
            rhs = val * msk
        b = torch.bmm(yg.mT, rhs[..., None]).squeeze(-1)
        n_row = msk.sum(dim=1)                              # ALS-WR scaling
        eye = torch.eye(rank, dtype=factors.dtype, device=factors.device)
        a = a + (reg * n_row)[:, None, None] * eye
        live = n_row > 0
        a = torch.where(live[:, None, None], a, eye)
        if rank <= _SMALL_RANK:
            x = spd_solve(a, b)
        else:
            x = pcg_solve(a, b, iters=min(32, rank + 8))
        return torch.where(live[:, None], x, 0.0)


@dataclass
class _Slab:
    """One slab's gather operands on the rank > _SMALL_RANK path."""
    gidx: torch.Tensor           # int32 [B*K]: slot padding -> zero row
    w: Optional[torch.Tensor]    # implicit: [B, K, 1] sqrt confidence
    wb: torch.Tensor             # [B, K, 1] rhs weights, cast dtype
    rows: int
    k: int


@dataclass
class _Batch:
    """Consecutive slabs of one side whose rows one CG solves; the
    per-row tensors run over the slabs' rows in order."""
    slabs: List[_Slab]
    safe_rows: torch.Tensor      # int64 [N]: rows, _FILL_ROW clamped
    live: torch.Tensor           # bool [N, 1]: the row has entries
    diag: torch.Tensor           # f32 [N, 1]: reg * n_row, 1 if empty
    real: torch.Tensor           # int64: positions of the rows to write
    write_rows: torch.Tensor     # int64: their row ids (no _FILL_ROW)


def _prepare_side(slabs: Sequence[tuple], n_own: int, n_opp: int,
                  reg: float, alpha: float, *, implicit: bool,
                  cast: torch.dtype, rank: int) -> List[_Batch]:
    """The per-run part of the JAX package's `_paired_normal_eqs`,
    without the pairing, for one side's device slabs, grouped into CG
    batches of at most `_CG_BATCH_BUDGET` bytes of normal matrices.

    The gather reads an opposite table with one zero row appended at
    `n_opp`, where slot padding points: that is the masked copy (a {0, 1}
    mask times a row) without a multiply. For implicit feedback the copy
    is weighted by sqrt(c) (c = alpha*|r| + _EPS on observed entries), so
    one copy serves both Gram operands, and the rhs weights
    pref*(1+c)/sqrt(c) undo it on the rhs."""
    per_batch = max(1, _CG_BATCH_BUDGET // (rank * rank * 4))
    groups: List[list] = []
    n = 0
    for slab in slabs:
        if not groups or n + slab[0].shape[0] > per_batch:
            groups.append([])
            n = 0
        groups[-1].append(slab)
        n += slab[0].shape[0]
    batches = []
    for group in groups:
        parts, rows_l, n_l = [], [], []
        for rows, idx, val in group:
            msk = idx >= 0
            m = msk.float()
            v = val.float()
            if implicit:
                conf = alpha * v.abs() * m + _EPS * m
                w = torch.sqrt(conf).to(cast)[..., None]
                wb = torch.where(conf > 0, (v > 0) * (1.0 + conf)
                                 * torch.rsqrt(conf.clamp_min(1e-30)), 0.0)
            else:
                w, wb = None, v * m
            parts.append(_Slab(torch.where(msk, idx, n_opp).reshape(-1), w,
                               wb.to(cast)[..., None], idx.shape[0],
                               idx.shape[1]))
            rows_l.append(rows)
            n_l.append(m.sum(dim=1))
        rows, n_row = torch.cat(rows_l), torch.cat(n_l)
        real = torch.nonzero(rows != _FILL_ROW).squeeze(1)
        batches.append(_Batch(
            parts, safe_rows=rows.clamp_max(n_own - 1).long(),
            live=(n_row > 0)[:, None],
            diag=(reg * n_row + (n_row == 0).float())[:, None],
            real=real, write_rows=rows[real].long()))
    return batches


def _solve_batch(own: torch.Tensor, opp_ext: torch.Tensor, batch: _Batch,
                 yty: Optional[torch.Tensor], *,
                 cg_iters: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The rank > _SMALL_RANK solver (the JAX package's
    `_solve_slab_paired`, one system per row, one CG over the batch's
    slabs): per slab the gathered opposite rows in the cast dtype and
    the Gram and rhs accumulated in fp32; then the ALS-WR diagonal
    (identity on empty rows) and `cg_iters` steps of Jacobi-CG
    warm-started from the current rows. Returns ([N, R] solutions, zero
    on empty rows; [N] relative residuals, zero on empty rows)."""
    rank = opp_ext.shape[1]
    n = batch.live.shape[0]
    a = own.new_empty((n, rank, rank))
    b = own.new_empty((n, rank, 1))
    o = 0
    for slab in batch.slabs:
        ygm = opp_ext.index_select(0, slab.gidx).view(slab.rows, slab.k,
                                                      rank)
        wb = slab.wb
        if slab.w is not None:
            ygm = ygm * slab.w
        if not ygm.is_cuda:
            ygm, wb = ygm.float(), wb.float()
        _bmm_f32(ygm.mT, ygm, a[o:o + slab.rows])
        _bmm_f32(ygm.mT, wb, b[o:o + slab.rows])
        o += slab.rows
    if yty is not None:
        a += yty
    a.diagonal(dim1=-2, dim2=-1).add_(batch.diag)
    x0 = torch.where(batch.live, own.index_select(0, batch.safe_rows), 0.0)
    x, rel, _ = pcg_solve(a, b.squeeze(-1), iters=cg_iters, x0=x0,
                          rtol=0.0, return_info=True)
    return (torch.where(batch.live, x, 0.0),
            torch.where(batch.live[:, 0], rel, 0.0))


class _Iteration:
    """One ALS iteration (users, then items) over a run's slabs, in place
    on `x` and `y`; `res` holds the iteration's largest relative
    residual of the rank > _SMALL_RANK solves (0 on the exact path).
    What depends only on the ratings is derived once, here."""

    def __init__(self, x: torch.Tensor, y: torch.Tensor,
                 user_slabs: Sequence[tuple], item_slabs: Sequence[tuple],
                 reg: float, alpha: float, *, implicit: bool, rank: int,
                 cg_iters: int = _CG_ITERS,
                 cast: Optional[torch.dtype] = None):
        self.reg, self.alpha = reg, alpha
        self.implicit, self.rank, self.cg_iters = implicit, rank, cg_iters
        self.cast = cast or torch.float32
        self.res = torch.zeros((), dtype=torch.float32, device=x.device)
        self.cg = rank > _SMALL_RANK
        self.sides = []
        for own, opp, slabs in ((x, y, user_slabs), (y, x, item_slabs)):
            if self.cg:
                slabs = _prepare_side(slabs, own.shape[0], opp.shape[0],
                                      reg, alpha, implicit=implicit,
                                      cast=self.cast, rank=rank)
            else:
                slabs = [(rows[:int((rows != _FILL_ROW).sum())].long(), idx,
                          val) for rows, idx, val in slabs]
            self.sides.append((own, opp, slabs))

    def half_step(self, own: torch.Tensor, opposite: torch.Tensor,
                  slabs: Sequence) -> None:
        yty = opposite.T @ opposite if self.implicit else None
        if not self.cg:
            for write_rows, idx, val in slabs:
                sol = _solve_bucket(opposite, idx, val, self.reg,
                                    self.alpha, yty, implicit=self.implicit)
                own.index_copy_(0, write_rows, sol[:write_rows.shape[0]])
            return
        opp = opposite.to(self.cast)
        opp_ext = torch.cat([opp, opp.new_zeros(1, self.rank)])
        for batch in slabs:
            sol, rel = _solve_batch(own, opp_ext, batch, yty,
                                    cg_iters=self.cg_iters)
            own.index_copy_(0, batch.write_rows,
                            sol.index_select(0, batch.real))
            torch.maximum(self.res, rel.max(), out=self.res)

    def __call__(self) -> None:
        with exact_fp32():
            self.res.zero_()
            for own, opp, slabs in self.sides:
                self.half_step(own, opp, slabs)


def _run_als(x: torch.Tensor, y: torch.Tensor, user_slabs: Sequence[tuple],
             item_slabs: Sequence[tuple], reg: float, alpha: float,
             n_iter: int, *, implicit: bool, rank: int,
             cg_iters: int = _CG_ITERS, cast: Optional[torch.dtype] = None
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The training loop: `n_iter` iterations of a users half-step and an
    items half-step over the device slabs ((rows, idx, val) tuples as
    `device_slabs` makes them). Returns (x, y, the last iteration's
    largest relative solver residual as a 0-d tensor; 0.0 on the exact
    small-rank path). The inputs are not modified; past the per-run
    preparation the loop never waits on the device."""
    x, y = x.clone(), y.clone()
    it = _Iteration(x, y, user_slabs, item_slabs, reg, alpha,
                    implicit=implicit, rank=rank, cg_iters=cg_iters,
                    cast=cast)
    from predictionio_tpu_torch.resilience.watchdog import progress
    for _ in range(n_iter):
        progress()          # an iteration of a refresher's rebuild
        it()
    return x, y, it.res


def half_step(own: torch.Tensor, opposite: torch.Tensor,
              slabs: Sequence[tuple], reg: float, alpha: float = 1.0, *,
              implicit: bool = False, cg_iters: int = _CG_ITERS,
              cast: Optional[torch.dtype] = None
              ) -> Tuple[torch.Tensor, float]:
    """One half-step of training: the rows of `own` in `slabs` (device
    slabs of that side) solved against fixed `opposite` factors; rows in
    no slab keep their values. Returns (new own factors, largest
    relative solver residual). The unit under test of the parity
    checks."""
    rank = own.shape[1]
    own = own.clone()
    it = _Iteration(own, opposite, slabs, [], reg, alpha,
                    implicit=implicit, rank=rank, cg_iters=cg_iters,
                    cast=cast)
    with exact_fp32():
        it.half_step(*it.sides[0])
    return own, float(it.res)


def _row_normals(seed: int, side: int, n_rows: int, rank: int
                 ) -> np.ndarray:
    """Standard normals [n_rows, rank] where row r depends only on
    (seed, side, r): a counter-based draw (splitmix64 of the counter
    row * 2h + j, h = ceil(rank / 2), offset by a key mixed from seed
    and side) whose uniform pairs give two normals each by Box-Muller,
    in float32. Vectorized and in place; no generator per row."""
    half = (rank + 1) // 2
    golden = np.uint64(0x9E3779B97F4A7C15)

    def mix(z):                      # splitmix64's finalizer, in place
        z ^= z >> np.uint64(30)
        z *= np.uint64(0xBF58476D1CE4E5B9)
        z ^= z >> np.uint64(27)
        z *= np.uint64(0x94D049BB133111EB)
        z ^= z >> np.uint64(31)
        return z

    with np.errstate(over="ignore"):
        key = np.asarray([(seed * 2 + side) & ((1 << 64) - 1)], np.uint64)
        key += golden
        key = mix(key) + golden
        z = np.arange(n_rows, dtype=np.uint64)[:, None] * np.uint64(2 * half)
        z = z + np.arange(2 * half, dtype=np.uint64)
        z += key
        mix(z)
    u = (z >> np.uint64(40)).astype(np.float32)           # 24-bit uniforms
    u *= np.float32(2.0 ** -24)
    radius = np.sqrt(np.float32(-2.0) * np.log1p(-u[:, :half]))  # 1-u > 0
    angle = np.float32(2.0 * np.pi) * u[:, half:]
    return np.concatenate([radius * np.cos(angle), radius * np.sin(angle)],
                          axis=1)[:, :rank]


def init_factors(n_users: int, n_items: int, rank: int, seed: int,
                 user_present: Optional[np.ndarray] = None,
                 item_present: Optional[np.ndarray] = None
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Starting factors (numpy f32): MLlib's abs(normal)/sqrt(rank).
    Row r of each side depends only on (seed, side, r), not on the
    matrix height, so a catalog padded with never-rated rows trains the
    same as one without them. Rows with no ratings are zero: they are
    never solved, and a nonzero phantom row would bias the implicit
    Gram matrix Y^T Y. The JAX package draws threefry normals, which
    this does not reproduce; parity checks hand both packages the same
    starting factors."""
    x = np.abs(_row_normals(seed, 0, max(n_users, 1), rank)) / math.sqrt(rank)
    y = np.abs(_row_normals(seed, 1, max(n_items, 1), rank)) / math.sqrt(rank)
    if user_present is not None:
        x = np.where(user_present[:, None], x, 0.0)
    if item_present is not None:
        y = np.where(item_present[:, None], y, 0.0)
    return x.astype(np.float32), y.astype(np.float32)


def _present(side: _SideBuckets, n_rows: int) -> np.ndarray:
    present = np.zeros(max(n_rows, 1), bool)
    for rows in side.rows:
        present[rows[rows != _FILL_ROW]] = True
    return present


def als_train(ratings: "RatingColumns | Tuple[np.ndarray, np.ndarray, np.ndarray] | None",
              n_users: Optional[int] = None,
              n_items: Optional[int] = None, *,
              rank: int = 10,
              iterations: int = 10,
              reg: float = 0.01,
              implicit: bool = False,
              alpha: float = 1.0,
              seed: int = 0,
              packed: Optional[PackedRatings] = None,
              timings: Optional[dict] = None,
              precision: str = "bf16",
              cg_iters: int = _CG_ITERS,
              device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Train factor matrices (X [n_users, rank], Y [n_items, rank]) and
    return them as f32 tensors on `device` (None = cuda; raises without
    CUDA unless `device="cpu"`).

    MLlib semantics: ALS-WR regularization, `abs(normal)/sqrt(rank)`
    init, `iterations` full alternations. `packed` (from `pack_ratings`)
    skips host packing. `timings`, if given, gets pack_s / transfer_s /
    solve_s / fetch_s wall-clock phases and `solver_residual`, the
    largest relative residual of the last iteration's inexact solves
    (0.0 on the exact path).

    `precision` ("bf16" | "f32") is the dtype of the GATHERED opposite
    rows on the rank > 16 path; the Gram accumulation and CG are fp32,
    and rank <= 16 is exact fp32 regardless. Rating values cross to the
    device in bf16 only on that path in explicit mode with bf16
    precision, and only when every rating round-trips bf16 exactly
    (half-star ratings do, 4.7 does not). `cg_iters` sets the
    warm-started CG steps. With reg near 0 on ill-conditioned data the
    CG may not converge; a residual above 1e-2 is logged as a warning
    (raise `cg_iters`, or use rank <= 16 for the exact solver).
    """
    dev = resolve_device(device)
    cast = {"bf16": torch.bfloat16, "f32": None}[precision]
    t0 = time.perf_counter()
    if packed is not None:
        user_side, item_side = packed.user_side, packed.item_side
        n_users, n_items = packed.n_users, packed.n_items
        if packed.rank != rank:
            raise ValueError("packed slabs were split for rank "
                             f"{packed.rank}, not {rank}")
    else:
        if isinstance(ratings, RatingColumns):
            u_ix, i_ix, val = ratings.user_ix, ratings.item_ix, ratings.rating
            n_users = n_users or len(ratings.users)
            n_items = n_items or len(ratings.items)
        else:
            u_ix, i_ix, val = ratings
            if n_users is None or n_items is None:
                raise ValueError("als_train on bare arrays needs n_users "
                                 "and n_items")
        user_side = _pack_side(u_ix, i_ix, val, n_users, rank)
        item_side = _pack_side(i_ix, u_ix, val, n_items, rank)
    t_pack = time.perf_counter()

    x, y = init_factors(n_users, n_items, rank, seed,
                        user_present=_present(user_side, n_users),
                        item_present=_present(item_side, n_items))
    cg = rank > _SMALL_RANK
    val_dt = (torch.bfloat16
              if (cg and cast is torch.bfloat16 and not implicit
                  and _bf16_exact(user_side.val))
              else torch.float32)
    x, y = torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev)
    user_slabs = device_slabs(user_side, val_dt, dev)
    item_slabs = device_slabs(item_side, val_dt, dev)
    _sync(dev)
    t_xfer = time.perf_counter()

    x, y, res = _run_als(x, y, user_slabs, item_slabs, reg, alpha,
                         iterations, implicit=implicit, rank=rank,
                         cg_iters=cg_iters, cast=cast)
    _sync(dev)
    t_solve = time.perf_counter()
    x, y = x[:n_users], y[:n_items]
    _check_residual(float(res), timings)
    if timings is not None:
        timings.update(pack_s=t_pack - t0, transfer_s=t_xfer - t_pack,
                       solve_s=t_solve - t_xfer,
                       fetch_s=time.perf_counter() - t_solve)
    return x, y


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _bf16_exact(arrays) -> bool:
    """True iff every value in the per-slab arrays round-trips bfloat16
    exactly (host, chunked: no values-sized temporary). Guards the bf16
    value transfer in `als_train`."""
    step = 1 << 22
    for a in arrays:
        a = np.asarray(a)
        for s in range(0, len(a), step):
            c = torch.from_numpy(np.ascontiguousarray(a[s:s + step],
                                                      np.float32))
            if not torch.equal(c, c.to(torch.bfloat16).float()):
                return False
    return True


def _check_residual(res: float, timings: Optional[dict]) -> None:
    """Record the inexact-solver residual (the worst across a run's
    solves) and warn when the warm-started CG did not converge — the
    exact Cholesky of the reference has no such failure mode."""
    if timings is not None:
        timings["solver_residual"] = max(
            res, timings.get("solver_residual", 0.0))
    if res > 1e-2:
        _log.warning(
            "ALS normal-equation solve did not converge (max relative "
            "residual %.2e > 1e-2): the system is ill-conditioned — "
            "likely reg is near zero. Raise cg_iters, raise reg, or use "
            "rank <= %d for the exact solver.", res, _SMALL_RANK)


def rmse(x, y, u_ix, i_ix, val) -> float:
    """Root mean squared error of x[u] . y[i] against `val`, the products
    on the factors' device in f32, the mean in f64 on the host."""
    x = torch.as_tensor(x)
    y = torch.as_tensor(y, device=x.device)
    u = torch.as_tensor(np.asarray(u_ix), dtype=torch.long, device=x.device)
    i = torch.as_tensor(np.asarray(i_ix), dtype=torch.long, device=x.device)
    pred = (x[u] * y[i]).sum(dim=1).cpu().numpy()
    return float(np.sqrt(np.mean((pred - np.asarray(val)) ** 2)))


@dataclass
class ALSModel:
    """Factor matrices + BiMaps (`examples/.../ALSModel.scala`)."""
    user_factors: torch.Tensor   # [n_users, rank] f32
    item_factors: torch.Tensor   # [n_items, rank] f32
    users: BiMap
    items: BiMap

    @property
    def device(self) -> torch.device:
        """The serving device: that of the user factors. The item master
        may lie in host RAM while a serving plan holds the device copy."""
        return self.user_factors.device

    def sanity_check(self) -> None:
        if self.user_factors.dim() != 2 or self.item_factors.dim() != 2:
            raise ValueError("ALSModel factors must be 2-D")
        if self.user_factors.shape[1] != self.item_factors.shape[1]:
            raise ValueError(
                f"ALSModel rank mismatch: users {self.user_factors.shape[1]}"
                f" vs items {self.item_factors.shape[1]}")
        if (len(self.users), len(self.items)) != (
                self.user_factors.shape[0], self.item_factors.shape[0]):
            raise ValueError("ALSModel id maps and factor rows disagree")
        if not (torch.isfinite(self.user_factors).all()
                and torch.isfinite(self.item_factors).all()):
            raise ValueError("ALSModel has non-finite factors")

    def to(self, device=None, items_device=None) -> "ALSModel":
        """This model with its user factors on `device` (None = cuda;
        raises without CUDA) and its item master on `items_device`
        (None = the same device, "cpu" = host RAM), as
        `als_model_from_numpy` places them; the id maps are shared."""
        dev = resolve_device(device)
        item_dev = dev if items_device is None else resolve_device(
            items_device)
        return ALSModel(self.user_factors.to(dev),
                        self.item_factors.to(item_dev), self.users,
                        self.items)

    def save_npz(self, path: Union[str, Path]) -> None:
        """Write factors and id lists (row order) to an `.npz`."""
        np.savez(path,
                 user_factors=self.user_factors.cpu().numpy(),
                 item_factors=self.item_factors.cpu().numpy(),
                 user_ids=np.array(self.users.keys(), dtype=str),
                 item_ids=np.array(self.items.keys(), dtype=str))


# per-row event cap of the fold-in (the newest are kept): bounds the
# gathered slab
_FOLD_HISTORY_CAP = 8192


def fold_in_rows(opposite: "torch.Tensor | np.ndarray", histories, *,
                 reg: float, implicit: bool = False, alpha: float = 1.0,
                 device=None) -> torch.Tensor:
    """Closed-form least-squares fold-in: re-solve factor rows against
    FIXED opposite-side factors, one exact ALS half-step (projecting new
    or updated users into a trained space without a retrain).
    `histories` holds one `(opposite_ix, value)` array pair per row to
    solve; returns [len(histories), rank] f32 rows on the device of the
    solve: `device`, else that of `opposite` (a tensor), else cuda.

    The rows are solved by `_solve_bucket`, with the ALS-WR `reg * n`
    diagonal and, implicit, confidence c = 1 + alpha*|r| and the Gram of
    all the opposite rows: a folded row equals that row's training solve
    by the same solver given the same opposite factors. The rows are
    bucketed by degree on the training's cap ladder (`_pack_side`), so a
    long history pads only its own bucket. A history longer than
    `_FOLD_HISTORY_CAP` keeps its newest events (such rows converge on
    the next full retrain). A row with no history comes out zero. Only
    the opposite rows the histories name cross to the solve's device
    when `opposite` lies elsewhere (an item master in host RAM)."""
    opp = torch.as_tensor(opposite, dtype=torch.float32)
    dev = resolve_device(device if device is not None else
                         (opp.device if isinstance(opposite, torch.Tensor)
                          else None))
    rank = opp.shape[1]
    n_rows = len(histories)
    out = torch.zeros((n_rows, rank), dtype=torch.float32, device=dev)
    lens = [min(len(ix), _FOLD_HISTORY_CAP) for ix, _ in histories]
    if not sum(lens):
        return out
    row_ix = np.repeat(np.arange(n_rows, dtype=np.int32), lens)
    col_ix = np.concatenate([np.asarray(ix, np.int32)[len(ix) - n:]
                             for (ix, _), n in zip(histories, lens)])
    val = np.concatenate([np.asarray(v, np.float32)[len(v) - n:]
                          for (_, v), n in zip(histories, lens)])
    # the opposite rows the histories name, as a compact table on `dev`
    used, local = np.unique(col_ix, return_inverse=True)
    table = opp.index_select(0, torch.from_numpy(used.astype(np.int64)).to(
        opp.device)).to(dev)
    yty = (opp.T @ opp).to(dev) if implicit else None
    side = _pack_side(row_ix, local.astype(np.int32), val, n_rows)
    for rows, idx, v in device_slabs(side, torch.float32, dev):
        rows = rows[:int((rows != _FILL_ROW).sum())].long()
        sol = _solve_bucket(table, idx, v, reg, alpha, yty,
                            implicit=implicit)
        out.index_copy_(0, rows, sol[:rows.shape[0]])
    return out


def als_model_from_numpy(user_factors: np.ndarray, item_factors: np.ndarray,
                         user_ids: Sequence[str], item_ids: Sequence[str],
                         device=None, items_device=None) -> ALSModel:
    """An `ALSModel` on `device` (None = cuda) from host factors and the
    ids of their rows, e.g. the arrays and BiMap keys of a model the JAX
    package trained. `items_device` places the item master (None = the
    same device); `"cpu"` keeps it in host RAM, so that the deploy's
    `serve_plan` can shard or tier a catalog past one card's budget."""
    dev = resolve_device(device)
    item_dev = dev if items_device is None else resolve_device(items_device)
    users = BiMap.from_keys(str(u) for u in user_ids)
    items = BiMap.from_keys(str(i) for i in item_ids)
    if len(users) != len(user_ids) or len(items) != len(item_ids):
        raise ValueError("als_model_from_numpy: duplicate ids")
    model = ALSModel(
        torch.tensor(user_factors, dtype=torch.float32, device=dev),
        torch.tensor(item_factors, dtype=torch.float32, device=item_dev),
        users, items)
    model.sanity_check()
    return model


def load_npz(path: Union[str, Path], device=None,
             items_device=None) -> ALSModel:
    """Read a `save_npz` file onto `device` (None = cuda), the item
    master onto `items_device` (as in `als_model_from_numpy`)."""
    with np.load(path, allow_pickle=False) as z:
        return als_model_from_numpy(
            z["user_factors"], z["item_factors"],
            z["user_ids"].tolist(), z["item_ids"].tolist(), device=device,
            items_device=items_device)
