"""Softmax attention with padding masks, and the ring's blockwise form.

The port of `predictionio_tpu/ops/attention.py`, the attention of the
sequential recommender (`ops/seqrec.py`). Plain PyTorch tensor ops on
any device (the JAX package leaves it to XLA; there is no TPU kernel on
this path):

  - `attention_reference`: [B, S, H, Dh] -> [B, S, H, Dh] at scale
    1/sqrt(Dh); masked scores are set to -1e30 (not -inf) and the
    softmax is masked again with the combined mask, so that a query row
    with no visible key (a left-padding slot under the causal mask) is
    exactly 0, forward and backward. `F.scaled_dot_product_attention`
    masks with -inf, which makes such rows NaN; it is not used here.
  - `ring_blocks`: the ring of the JAX package's `_ring_attention_local`
    over the shards of one sequence, each query, key, value and
    key-validity block on its shard's device. Every shard accumulates a
    streaming softmax `(m, num, den)` per query with `_stream_block`,
    one hop per shard: its own key/value block first, then the one
    before it, each block moving to the next shard's device with `.to`
    after a hop (autograd carries its gradient back); a dead row's
    `den` of 0 is replaced by 1. It equals `attention_reference` up to
    float association.
  - `blockwise_attention`: `ring_blocks` with every block on one device.
  - `ring_attention`: with no mesh, or a trivial sequence axis, the
    reference path; else the sequence split into the "sp" blocks of
    each of this process's `batch_axis` groups (the batch split over
    them where it divides, as in the JAX package) and `ring_blocks`
    over each group's devices. An "sp" axis that spans processes
    raises NotImplementedError (`Mesh.require_local`).
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import torch

_NEG = -1e30


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = False,
                        kv_mask: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """Plain softmax attention. `kv_mask` [B, S] bool marks VALID key
    positions (False = a padding slot that receives no attention)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    mask = None
    if causal:
        S = q.shape[1]
        mask = torch.tril(torch.ones((S, S), dtype=torch.bool,
                                     device=q.device))[None, None]
    if kv_mask is not None:
        km = kv_mask[:, None, None, :]
        mask = km if mask is None else (mask & km)
    if mask is None:
        return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1), v)
    s = s.masked_fill(~mask, _NEG)
    p = torch.softmax(s, dim=-1)
    # a fully masked row reads uniform from the softmax; the combined
    # mask zeroes it, so the dead row is exactly 0 as in the ring
    p = p.masked_fill(~mask, 0.0)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)


Carry = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def _stream_block(carry: Carry, k_blk: torch.Tensor, v_blk: torch.Tensor,
                  kv_ok: torch.Tensor, q: torch.Tensor, q_pos: torch.Tensor,
                  k_pos: torch.Tensor, scale: float, causal: bool) -> Carry:
    """One streaming-softmax step against a key/value block. carry =
    (m [B,H,Sq], num [B,Sq,H,Dh], den [B,H,Sq]); `kv_ok` [B, Skv] bool
    marks the block's valid key slots; `q_pos`, `k_pos` are the global
    positions of the query and key slots."""
    m, num, den = carry
    s = torch.einsum("bqhd,bkhd->bhqk", q, k_blk) * scale   # [B,H,Sq,Skv]
    mask = kv_ok[:, None, None, :]                          # [B,1,1,Skv]
    if causal:
        mask = mask & (q_pos[:, None] >= k_pos[None, :])[None, None]
    s = s.masked_fill(~mask, _NEG)
    m_new = torch.maximum(m, s.amax(dim=-1))                # [B,H,Sq]
    alpha = torch.exp(m - m_new)
    p = torch.exp(s - m_new[..., None])
    # a fully masked row would otherwise read exp(_NEG - _NEG) = 1
    p = p.masked_fill(~mask, 0.0)
    num = num * alpha.transpose(1, 2)[..., None] \
        + torch.einsum("bhqk,bkhd->bqhd", p, v_blk)
    den = den * alpha + p.sum(dim=-1)
    return m_new, num, den


def ring_blocks(qs: Sequence[torch.Tensor], ks: Sequence[torch.Tensor],
                vs: Sequence[torch.Tensor], oks: Sequence[torch.Tensor], *,
                causal: bool = False) -> List[torch.Tensor]:
    """The ring over the n shards of a sequence: shard i holds the
    query, key and value blocks `qs[i]`, `ks[i]`, `vs[i]` [B, S/n, H,
    Dh] of sequence block i and its key-validity block `oks[i]` [B, S/n]
    (bool), on its device. Returns each shard's attention output block,
    on the shard's device."""
    n = len(qs)
    s_loc = qs[0].shape[1]
    scale = 1.0 / math.sqrt(qs[0].shape[-1])
    devs = [q.device for q in qs]
    iotas = [torch.arange(s_loc, device=d) for d in devs]
    carries = [(q.new_full((q.shape[0], q.shape[2], s_loc), _NEG),
                torch.zeros_like(q), q.new_zeros((q.shape[0], q.shape[2],
                                                  s_loc))) for q in qs]
    blocks = list(zip(ks, vs, oks))
    for hop in range(n):
        for i in range(n):
            owner = (i - hop) % n              # whose block shard i holds
            carries[i] = _stream_block(
                carries[i], *blocks[i], qs[i], i * s_loc + iotas[i],
                owner * s_loc + iotas[i], scale, causal)
        if hop < n - 1:                        # shard i's block moves on
            blocks = [tuple(t.to(devs[i]) for t in blocks[i - 1])
                      for i in range(n)]
    outs = []
    for _, num, den in carries:
        # dead rows have num = 0 and den = 0: divide by a where'd 1, not
        # max(den, eps), whose backward scales gradients by 1/eps
        den_safe = torch.where(den > 0, den, torch.ones_like(den))
        outs.append(num / den_safe.transpose(1, 2)[..., None])
    return outs


def _blocks(t: torch.Tensor, n: int) -> List[torch.Tensor]:
    s_loc = t.shape[1] // n
    return [t[:, j * s_loc:(j + 1) * s_loc] for j in range(n)]


def blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, n_blocks: int, causal: bool = False,
                        kv_mask: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """The ring's recurrence over `n_blocks` sequence blocks on one
    device; [B, S, H, Dh] in and out, S a multiple of `n_blocks`."""
    B, S = q.shape[:2]
    if S % n_blocks:
        raise ValueError(f"sequence length {S} must divide over "
                         f"{n_blocks} blocks")
    if kv_mask is None:
        kv_mask = torch.ones((B, S), dtype=torch.bool, device=q.device)
    return torch.cat(ring_blocks(
        *(_blocks(t, n_blocks) for t in (q, k, v, kv_mask)),
        causal=causal), dim=1)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   mesh=None, *, axis: str = "sp", batch_axis: str = "data",
                   causal: bool = False,
                   kv_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Sequence-parallel attention over `mesh` (a `parallel.Mesh`) axis
    `axis`, the batch over this process's `batch_axis` groups where it
    divides; [B, S, H, Dh] in, and out on `q`'s device. Equal to
    `attention_reference` up to float association; with no mesh or a
    trivial axis (size 1 or absent) it is `attention_reference`.
    `kv_mask` [B, S] bool marks valid key positions (False =
    padding)."""
    shape = getattr(mesh, "shape", None) or {}
    n = int(shape.get(axis, 1))
    if n == 1:
        return attention_reference(q, k, v, causal=causal, kv_mask=kv_mask)
    B, S = q.shape[:2]
    if S % n:
        raise ValueError(f"sequence length {S} must divide over {n} "
                         f"{axis!r} shards")
    mesh.require_local(axis)
    if kv_mask is None:
        kv_mask = torch.ones((B, S), dtype=torch.bool, device=q.device)
    rows = [r for r in mesh.plane(batch_axis, axis)
            if mesh.owner(int(r[0])) == mesh.process_index]
    if B % len(rows):
        rows = rows[:1]
    b_loc = B // len(rows)
    outs = []
    for g, row in enumerate(rows):
        devs = [mesh.devices[int(p)] for p in row]
        parts = [[blk.to(d) for blk, d in zip(
            _blocks(t[g * b_loc:(g + 1) * b_loc], n), devs)]
            for t in (q, k, v, kv_mask)]
        outs.append(torch.cat([o.to(q.device) for o in ring_blocks(
            *parts, causal=causal)], dim=1))
    return torch.cat(outs, dim=0)
