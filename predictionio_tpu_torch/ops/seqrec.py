"""Sequential recommendation: a causal transformer over item histories.

The port of `predictionio_tpu/ops/seqrec.py` (the SASRec-style model of
the `seqrec` template). `SeqRecNet` encodes [B, S] right-aligned item
ids (PAD = n_items) into the last position's [B, D] representation:

    x = item_table[seqs] * sqrt(D) + pos_emb
    per layer (pre-LN): x += attn(LN1(x)) @ wo ; x += relu(LN2(x) @ w1) @ w2
    LN_f(x)[:, -1]

with heads as contiguous Dh chunks of D, causal attention under
`kv_mask = seqs != n_items` (`ops.attention.attention_reference`: a
left-padding query is exactly 0), LayerNorm with the biased variance
and eps 1e-6. The loss is the in-batch softmax of the encodings against
the TIED table's target rows over a temperature.

The parameters keep the JAX pytree's names and [fan_in, fan_out] layout
as `nn.Parameter`s (`l0.wq`, ... for its nested `l{i}` dicts), so that
`params_from_jax` is a checked copy and a model's `params` resume a
later run (`init_params`, the streaming warm start).

`seqrec_train` runs on `device` (None = cuda; raises without CUDA
unless `device="cpu"`): no shuffle, the first floor(N / batch) batches
in order every epoch, one eager autograd step and `ops.adam.Adam`
update per batch (the JAX package scans an epoch in one program). The
initialization draws from a `torch.Generator` seeded by `seed` on the
CPU, not from threefry. `seqrec_encode` is the serving path: the device
copy of the weights is cached on the model (`_devp`, never pickled).
The mesh forms (batch over "data", the sequence over "sp" by ring
attention) are not ported: training runs on one device.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from predictionio_tpu_torch.device import resolve_device
from predictionio_tpu_torch.ops.adam import Adam
from predictionio_tpu_torch.ops.attention import attention_reference

TOP_NAMES = ("item_table", "pos_emb", "ln_f", "ln_f_b")
BLOCK_NAMES = ("ln1", "ln1_b", "wq", "wk", "wv", "wo", "ln2", "ln2_b",
               "w1", "w2")
LN_EPS = 1e-6


def n_layers_of(params: dict) -> int:
    """The layer count of a parameter tree: its `l<digits>` keys."""
    return sum(1 for k in params if k.startswith("l") and k[1:].isdigit())


@dataclass
class SeqRecModel:
    params: dict           # transformer weights, the JAX pytree as numpy
    seq_len: int
    n_items: int
    n_heads: int

    @property
    def item_emb(self) -> np.ndarray:
        """[n_items, D] tied output/input item table (PAD row dropped)."""
        return np.asarray(self.params["item_table"])[:self.n_items]

    def sanity_check(self):
        assert all(np.isfinite(v).all() for v in _leaves(self.params))

    def __getstate__(self):
        # the serve-time device copy (_devp) stays out of the pickle: a
        # stored model is numpy weights only
        d = dict(self.__dict__)
        d.pop("_devp", None)
        return d


def _leaves(params: dict):
    for v in params.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def params_from_jax(params_np: dict) -> dict:
    """The JAX package's seqrec parameters (its nested pytree, as numpy)
    as the port's: the same names, nesting and layout, float32 copies,
    checked for completeness and shape."""
    n_layers = n_layers_of(params_np)
    want = set(TOP_NAMES) | {f"l{i}" for i in range(n_layers)}
    if set(params_np) != want:
        raise ValueError(f"seqrec params: keys {sorted(params_np)}, "
                         f"expected {sorted(want)}")
    out = {k: np.array(params_np[k], dtype=np.float32) for k in TOP_NAMES}
    D = out["pos_emb"].shape[1]
    shapes = {"ln1": (D,), "ln1_b": (D,), "wq": (D, D), "wk": (D, D),
              "wv": (D, D), "wo": (D, D), "ln2": (D,), "ln2_b": (D,),
              "w1": (D, 2 * D), "w2": (2 * D, D)}
    if out["item_table"].shape[1] != D or out["ln_f"].shape != (D,) \
            or out["ln_f_b"].shape != (D,):
        raise ValueError("seqrec params: the top-level widths differ")
    for i in range(n_layers):
        layer = params_np[f"l{i}"]
        if set(layer) != set(BLOCK_NAMES):
            raise ValueError(f"seqrec params: l{i} keys {sorted(layer)}")
        out[f"l{i}"] = {k: np.array(layer[k], dtype=np.float32)
                        for k in BLOCK_NAMES}
        for k, shape in shapes.items():
            if out[f"l{i}"][k].shape != shape:
                raise ValueError(f"seqrec params: l{i}.{k} is "
                                 f"{out[f'l{i}'][k].shape}, not {shape}")
    return out


def random_params(seed: int, n_items: int, seq_len: int, dim: int,
                  n_layers: int) -> dict:
    """Random weights from a CPU `torch.Generator` seeded by `seed`, in
    the JAX package's scales: the item table (PAD row n_items included)
    normal / sqrt(dim), positions normal * 0.02, dense layers normal /
    sqrt(fan_in), LayerNorms at gain 1 and bias 0."""
    gen = torch.Generator().manual_seed(int(seed))

    def normal(*shape):
        return torch.randn(shape, generator=gen, dtype=torch.float32)

    def dense(fan_in, fan_out):
        return (normal(fan_in, fan_out) / np.sqrt(fan_in)).numpy()

    ones, zeros = np.ones(dim, np.float32), np.zeros(dim, np.float32)
    p = {"item_table": (normal(n_items + 1, dim) / np.sqrt(dim)).numpy(),
         "pos_emb": (normal(seq_len, dim) * 0.02).numpy(),
         "ln_f": ones.copy(), "ln_f_b": zeros.copy()}
    for layer in range(n_layers):
        p[f"l{layer}"] = {
            "ln1": ones.copy(), "ln1_b": zeros.copy(),
            "wq": dense(dim, dim), "wk": dense(dim, dim),
            "wv": dense(dim, dim), "wo": dense(dim, dim),
            "ln2": ones.copy(), "ln2_b": zeros.copy(),
            "w1": dense(dim, 2 * dim), "w2": dense(2 * dim, dim)}
    return p


def _parameter(a, dev) -> nn.Parameter:
    return nn.Parameter(torch.as_tensor(np.asarray(a, np.float32)).to(dev))


class _Block(nn.Module):
    """One pre-LN transformer layer's weights (the pytree's `l{i}`)."""

    def __init__(self, params: dict, dev):
        super().__init__()
        for name in BLOCK_NAMES:
            setattr(self, name, _parameter(params[name], dev))


class SeqRecNet(nn.Module):
    """The encoder and its loss over parameters named as in the JAX
    pytree (`named_parameters()` gives `item_table`, ..., `l0.wq`)."""

    def __init__(self, params: dict, *, n_items: int, n_heads: int,
                 device=None):
        super().__init__()
        dev = resolve_device(device)
        self.n_items, self.n_heads = n_items, n_heads
        for name in TOP_NAMES:
            setattr(self, name, _parameter(params[name], dev))
        self.n_layers = n_layers_of(params)
        for i in range(self.n_layers):
            self.add_module(f"l{i}", _Block(params[f"l{i}"], dev))

    def forward(self, seqs: torch.Tensor) -> torch.Tensor:
        """[B, S] int ids (PAD = n_items, right-aligned) -> [B, D], the
        final position's representation."""
        B, S = seqs.shape
        D = self.pos_emb.shape[1]
        H = self.n_heads
        valid = seqs != self.n_items                         # [B, S]
        x = self.item_table[seqs] * math.sqrt(D) + self.pos_emb
        for i in range(self.n_layers):
            lp = getattr(self, f"l{i}")
            h = F.layer_norm(x, (D,), lp.ln1, lp.ln1_b, eps=LN_EPS)
            q = (h @ lp.wq).reshape(B, S, H, D // H)
            k = (h @ lp.wk).reshape(B, S, H, D // H)
            v = (h @ lp.wv).reshape(B, S, H, D // H)
            a = attention_reference(q, k, v, causal=True, kv_mask=valid)
            x = x + a.reshape(B, S, D) @ lp.wo
            h = F.layer_norm(x, (D,), lp.ln2, lp.ln2_b, eps=LN_EPS)
            x = x + torch.relu(h @ lp.w1) @ lp.w2
        x = F.layer_norm(x, (D,), self.ln_f, self.ln_f_b, eps=LN_EPS)
        return x[:, -1, :]                 # right-aligned: last = newest

    def loss(self, seqs: torch.Tensor, targets: torch.Tensor,
             temperature: float) -> torch.Tensor:
        """In-batch softmax of the encodings against the tied table's
        target rows."""
        u = self(seqs)
        t = self.item_table[targets]                         # [B, D]
        logits = (u @ t.T) / temperature
        return -torch.log_softmax(logits, dim=-1).diagonal().mean()

    def numpy_params(self) -> dict:
        out = {name: getattr(self, name).detach().cpu().numpy()
               for name in TOP_NAMES}
        for i in range(self.n_layers):
            lp = getattr(self, f"l{i}")
            out[f"l{i}"] = {name: getattr(lp, name).detach().cpu().numpy()
                            for name in BLOCK_NAMES}
        return out


def train_step(net: SeqRecNet, adam: Adam, seqs: torch.Tensor,
               targets: torch.Tensor, temperature: float) -> torch.Tensor:
    """One batch: the loss, its gradients by autograd, one Adam update.
    Returns the loss (a 0-dim device tensor; nothing waits for it)."""
    loss = net.loss(seqs, targets, temperature)
    adam.step(torch.autograd.grad(loss, adam.params))
    return loss.detach()


def seqrec_train(sequences: np.ndarray, targets: np.ndarray, *,
                 n_items: int, seq_len: int, dim: int = 64,
                 n_heads: int = 2, n_layers: int = 2,
                 batch_size: int = 256, epochs: int = 5,
                 lr: float = 3e-3, temperature: float = 0.07,
                 seed: int = 0, device=None, init_params=None,
                 step_losses: Optional[List[torch.Tensor]] = None,
                 on_step: Optional[Callable[[int], None]] = None
                 ) -> SeqRecModel:
    """Train on [N, seq_len] right-aligned item-id sequences (PAD =
    n_items) with [N] next-item targets. `init_params` (the JAX pytree's
    names and layout; its layers set the depth) resumes from earlier
    weights with fresh Adam moments. `step_losses`, if given, gets each
    step's loss as a device tensor; `on_step`, if given, is called with
    each step's index (from 0 over all epochs) once the step is
    enqueued."""
    dev = resolve_device(device)
    if sequences.shape[1] != seq_len:
        raise ValueError(f"sequences are {sequences.shape[1]} wide, "
                         f"seq_len is {seq_len}")
    n = (len(sequences) // batch_size) * batch_size
    if n == 0:
        raise ValueError(
            f"need at least one full batch ({batch_size}) of sequences")
    if init_params is not None:
        params = params_from_jax(init_params)
    else:
        params = random_params(seed, n_items, seq_len, dim, n_layers)
    net = SeqRecNet(params, n_items=n_items, n_heads=n_heads, device=dev)
    adam = Adam(list(net.parameters()), lr)
    seq_all = torch.from_numpy(np.asarray(sequences[:n], np.int64)
                               .reshape(-1, batch_size, seq_len)).to(dev)
    tgt_all = torch.from_numpy(np.asarray(targets[:n], np.int64)
                               .reshape(-1, batch_size)).to(dev)
    steps = seq_all.shape[0]
    for epoch in range(epochs):
        for s in range(steps):
            loss = train_step(net, adam, seq_all[s], tgt_all[s], temperature)
            if step_losses is not None:
                step_losses.append(loss)
            if on_step is not None:
                on_step(epoch * steps + s)
    return SeqRecModel(params=net.numpy_params(), seq_len=seq_len,
                       n_items=n_items, n_heads=n_heads)


def seqrec_encode(model: SeqRecModel, seqs: np.ndarray,
                  device=None) -> np.ndarray:
    """[B, seq_len] histories -> [B, D] user representations, on
    `device` (None = cuda). The serving hot path: the weights' device
    copy is cached on the model (outside its pickled state)."""
    dev = resolve_device(device)
    cached = getattr(model, "_devp", None)
    if cached is None or cached[0] != dev:
        cached = (dev, SeqRecNet(model.params, n_items=model.n_items,
                                 n_heads=model.n_heads, device=dev))
        model._devp = cached
    with torch.inference_mode():
        out = cached[1](torch.from_numpy(
            np.asarray(seqs, np.int64)).to(dev))
    return out.cpu().numpy()


def build_sequences(user_ix: np.ndarray, item_ix: np.ndarray,
                    t_millis: np.ndarray, *, n_items: int, seq_len: int,
                    min_len: int = 2):
    """Group events into per-user time-ordered item sequences and emit
    (sequences [N, seq_len] right-aligned PAD=n_items, targets [N]):
    for each user with >= min_len events, the history-before-last is
    the sequence and the last item the target. Host-side, vectorized
    (no per-user Python loop)."""
    order = np.lexsort((t_millis, user_ix))
    u, i = user_ix[order], item_ix[order]
    starts = np.r_[0, np.flatnonzero(np.diff(u)) + 1]
    ends = np.r_[starts[1:], len(u)]
    lens = ends - starts
    keep = lens >= min_len
    starts, ends, lens = starts[keep], ends[keep], lens[keep]
    n = len(starts)
    seqs = np.full((n, seq_len), n_items, np.int32)
    # history = up to seq_len items BEFORE the last; right-aligned
    hist_len = np.minimum(lens - 1, seq_len)
    # flat gather: for row r, take items [end-1-hist .. end-1)
    rows = np.repeat(np.arange(n), hist_len)
    offs = (np.arange(int(hist_len.sum()))
            - np.repeat(np.cumsum(hist_len) - hist_len, hist_len))
    src = np.repeat(ends - 1 - hist_len, hist_len) + offs
    cols = np.repeat(seq_len - hist_len, hist_len) + offs
    seqs[rows, cols] = i[src]
    targets = i[ends - 1].astype(np.int32)
    return seqs, targets
