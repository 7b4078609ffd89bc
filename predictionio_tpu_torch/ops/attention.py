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
  - `blockwise_attention`: the ring's recurrence on one device. Each of
    `n_blocks` query blocks takes the key/value blocks in the order
    the ring hands them round (its own first, then the one before it),
    accumulating a streaming softmax `(m, num, den)` per query with
    `_stream_block`; a dead row's `den` of 0 is replaced by 1. It equals
    `attention_reference` up to float association. `_stream_block` is
    the body a `torch.distributed` ring over several cards would run
    once per hop.
  - `ring_attention`: with no mesh, or a trivial sequence axis, the
    reference path; a sequence axis over several devices is the
    sharded ring, which the port does not have yet.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

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


def blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, n_blocks: int, causal: bool = False,
                        kv_mask: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """The ring's recurrence over `n_blocks` sequence blocks on one
    device; [B, S, H, Dh] in and out, S a multiple of `n_blocks`."""
    B, S, H, _ = q.shape
    if S % n_blocks:
        raise ValueError(f"sequence length {S} must divide over "
                         f"{n_blocks} blocks")
    if kv_mask is None:
        kv_mask = torch.ones((B, S), dtype=torch.bool, device=q.device)
    s_loc = S // n_blocks
    scale = 1.0 / math.sqrt(q.shape[-1])
    iota = torch.arange(s_loc, device=q.device)
    outs = []
    for idx in range(n_blocks):
        rows = slice(idx * s_loc, (idx + 1) * s_loc)
        q_blk = q[:, rows]
        carry = (q.new_full((B, H, s_loc), _NEG), torch.zeros_like(q_blk),
                 q.new_zeros((B, H, s_loc)))
        for step in range(n_blocks):
            owner = (idx - step) % n_blocks      # the ring's hand-round
            cols = slice(owner * s_loc, (owner + 1) * s_loc)
            carry = _stream_block(carry, k[:, cols], v[:, cols],
                                  kv_mask[:, cols], q_blk,
                                  idx * s_loc + iota, owner * s_loc + iota,
                                  scale, causal)
        _, num, den = carry
        # dead rows have num = 0 and den = 0: divide by a where'd 1, not
        # max(den, eps), whose backward scales gradients by 1/eps
        den_safe = torch.where(den > 0, den, torch.ones_like(den))
        outs.append(num / den_safe.transpose(1, 2)[..., None])
    return torch.cat(outs, dim=1)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   mesh=None, *, axis: str = "sp", causal: bool = False,
                   kv_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Sequence-parallel attention over `mesh` axis `axis` (a mapping
    `mesh.shape` of axis sizes). With no mesh or a trivial axis (size 1
    or absent) it is `attention_reference`. A sequence axis over several
    devices raises: the `torch.distributed` ring is not ported yet
    (ROADMAP Queue 1, item 4)."""
    shape = getattr(mesh, "shape", None) or {}
    if int(shape.get(axis, 1)) == 1:
        return attention_reference(q, k, v, causal=causal, kv_mask=kv_mask)
    raise NotImplementedError(
        f"ring attention over a {shape[axis]}-device {axis!r} axis needs "
        "the torch.distributed ring (ROADMAP Queue 1, item 4); this port "
        "runs attention on one device (mesh=None)")
