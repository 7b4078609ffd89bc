"""Random-forest classifier: level-wise, dense, every tree at once.

The port of `predictionio_tpu/ops/forest.py`, which replaces MLlib's
`RandomForest.trainClassifier` used by the reference's classification
template (`examples/scala-parallel-classification/add-algorithm/src/main/
scala/RandomForestAlgorithm.scala:41-72`):

  1. Features are quantile-binned on the host into `[n, f]` bins (the
     `maxBins` analog; split candidates = bin boundaries), bit for bit
     the JAX package's numpy.
  2. All trees grow together on `device` (None = cuda; raises without
     CUDA unless `device="cpu"`), one depth level per `grow_level`. The
     class histogram `hist[tree, node, feature, bin, class]` of a level
     is one flat fp32 tensor `[t * n_nodes * C * f * B]` indexed by
     `tree * size + (node * C + class) * f * B + feature * B + bin`, and
     filled by `index_add_` of the bootstrap weights over chunks of
     samples, each chunk's keys and weights under `_HIST_KEY_BUDGET`
     bytes. The weights are whole numbers (Poisson counts, or 1), so
     every bin is exact in fp32 below 2^24 whatever order the card's
     atomics take: the histogram equals the JAX package's bit for bit.
  3. Split selection is a vectorized argmax of impurity gain (gini or
     entropy) over `[f x B]` candidates per (tree, node) under a random
     per-node feature-subset mask (`featureSubsetStrategy`); the first
     maximum wins, as `jnp.argmax`'s does.
  4. Nodes whose best gain is <= 0 degrade to an always-left split, so
     every tree keeps the same static depth; leaves predict the majority
     class of their final histogram and the forest predicts by majority
     vote over trees (lowest class index on a tie).

Bagging matches MLlib: Poisson(1) bootstrap weights per (tree, sample)
when `n_trees > 1`, none for a single tree. The random draws (the
weights, then one set of feature ranks per level) come from one CPU
`torch.Generator` seeded by `seed` and are uploaded, so a seed grows
the same forest on the card as on the CPU. They are not the JAX
package's threefry draws: a forest of one tree over every feature draws
nothing that matters and equals the JAX package's; any other forest
differs from it by design, as `ops.als.init_factors` does.

The mesh form (per-device partial histograms and a `psum`) is not
ported: training runs on one device.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass, replace
from typing import Optional

import numpy as np
import torch

from predictionio_tpu_torch.device import resolve_device


# rows sampled for quantile estimation: exact quantiles over millions
# of rows cost ~10x more host time for bin edges that differ in the
# third decimal (MLlib likewise samples its input for split finding,
# DecisionTree.findSplitsBins)
_QUANTILE_SAMPLE = 200_000


def quantile_bins(features: np.ndarray, max_bins: int,
                  seed: int = 0) -> np.ndarray:
    """Per-feature quantile bin edges `[f, max_bins - 1]` (host-side,
    once per training run; estimated from a row sample past
    `_QUANTILE_SAMPLE` rows)."""
    n = features.shape[0]
    if n > _QUANTILE_SAMPLE:
        ix = np.random.RandomState(seed).choice(
            n, _QUANTILE_SAMPLE, replace=False)
        features = features[ix]
    qs = np.linspace(0, 1, max_bins + 1)[1:-1]
    return np.quantile(features, qs, axis=0).T.astype(np.float32)


def apply_bins(features: np.ndarray, edges: np.ndarray) -> np.ndarray:
    """Bin features `[n, f]` into [0, B), in the smallest integer dtype
    that holds the bins (uint8 below 256 bins — also the transfer-lean
    form — else int32). Works on a transposed copy so every searchsorted
    reads a contiguous column."""
    xt = np.ascontiguousarray(np.asarray(features, np.float32).T)
    f, n = xt.shape
    out = np.empty((f, n), np.uint8 if edges.shape[1] < 256 else np.int32)
    for j in range(f):
        out[j] = np.searchsorted(edges[j], xt[j], side="right")
    return np.ascontiguousarray(out.T)


def _subset_size(strategy: str, n_features: int, n_trees: int) -> int:
    """featureSubsetStrategy -> features considered per node (MLlib
    semantics: 'auto' = all for one tree, sqrt for a forest)."""
    if strategy == "auto":
        strategy = "all" if n_trees == 1 else "sqrt"
    if strategy == "all":
        return n_features
    if strategy == "sqrt":
        return max(1, int(math.sqrt(n_features)))
    if strategy == "log2":
        return max(1, int(math.log2(n_features)))
    if strategy == "onethird":
        return max(1, n_features // 3)
    raise ValueError(f"Unknown featureSubsetStrategy {strategy!r}")


def _impurity(counts: torch.Tensor, total: torch.Tensor,
              kind: str) -> torch.Tensor:
    """counts [..., C], total [..., 1] -> impurity [...]."""
    p = counts / torch.clamp(total, min=1e-9)
    if kind == "gini":
        return 1.0 - (p * p).sum(-1)
    if kind == "entropy":
        return -(p * torch.where(p > 0, torch.log2(torch.clamp(p, min=1e-12)),
                                 0.0)).sum(-1)
    raise ValueError(f"Unknown impurity {kind!r}")


# transient budget for one histogram chunk: its [t, chunk, f] keys (in
# the index dtype) and the weights broadcast beside them stay under this
# many bytes, so a 1M x 100 x 10-tree level never materializes the full
# [t, n * f] index space
_HIST_KEY_BUDGET = 256 << 20


def _histogram(s: torch.Tensor, w: torch.Tensor, fb_cols: torch.Tensor, *,
               n_nodes: int, c: int, f: int, b: int) -> torch.Tensor:
    """Class histogram of a level from the samples.

    s:       [t, n]  node*C + class per (tree, sample)
    w:       [t, n]  bootstrap weights (float32)
    fb_cols: [n, f]  flat feature-bin column f*B + bin
    Returns [t, nd, f, B, C] (a view of the flat histogram). Keys are
    int32 while the flat index fits, else int64; samples go in chunks
    whose keys and weight broadcast respect `_HIST_KEY_BUDGET`."""
    t, n = s.shape
    size = n_nodes * c * f * b
    idx, idx_bytes = ((torch.int32, 4) if t * size < 2 ** 31
                      else (torch.int64, 8))
    chunk = max(1, _HIST_KEY_BUDGET // (max(t, 1) * max(f, 1)
                                        * (idx_bytes + 4)))
    hist = torch.zeros(t * size, dtype=torch.float32, device=s.device)
    base = (torch.arange(t, device=s.device, dtype=idx) * size)[:, None]
    s = s.to(idx) * (f * b) + base                      # [t, n]
    fb = fb_cols.to(idx)
    for lo in range(0, n, chunk):
        hi = min(n, lo + chunk)
        keys = s[:, lo:hi, None] + fb[None, lo:hi, :]   # [t, chunk, f]
        upd = w[:, lo:hi, None].expand(-1, -1, f)
        hist.index_add_(0, keys.reshape(-1), upd.reshape(-1))
    return hist.view(t, n_nodes, c, f, b).permute(0, 1, 3, 4, 2)


def _select_splits(hist: torch.Tensor, ranks: torch.Tensor, *,
                   n_nodes: int, c: int, f: int, b: int, subset: int,
                   impurity: str):
    """Vectorized split selection from the histogram [t, nd, f, B, C];
    `ranks` [t, nd, f] is each node's random order of the features, of
    which the first `subset` are considered. Returns (split_feature,
    split_bin), int32 [t, nd]."""
    t = hist.shape[0]
    # threshold "<= bin" -> left counts = cumsum over B
    left = torch.cumsum(hist, dim=3)
    total = left[:, :, :, -1, :]                   # [t, nd, f, C]
    right = total[:, :, :, None, :] - left
    nl = left.sum(-1)                              # [t, nd, f, B]
    nr = right.sum(-1)
    nt = nl + nr
    imp_l = _impurity(left, nl[..., None], impurity)
    imp_r = _impurity(right, nr[..., None], impurity)
    parent = total[:, :, 0, :]                     # [t, nd, C]
    n_parent = parent.sum(-1)                      # [t, nd]
    imp_p = _impurity(parent, n_parent[..., None], impurity)
    child = (nl * imp_l + nr * imp_r) / torch.clamp(nt, min=1e-9)
    gain = imp_p[:, :, None, None] - child         # [t, nd, f, B]

    # the last bin is "everything left" = no split; forbid it as a
    # candidate, and forbid features outside the random subset
    gain[:, :, :, -1] = -math.inf
    gain = torch.where((ranks < subset)[:, :, :, None], gain, -math.inf)

    flat = gain.reshape(t, n_nodes, f * b)
    best = torch.argmax(flat, dim=-1)              # [t, nd]
    best_gain = flat.gather(-1, best[..., None])[..., 0]
    # non-positive gain (or empty node) -> always-left split
    degenerate = ~(best_gain > 0)
    split_f = torch.where(degenerate, 0, best // b).to(torch.int32)
    split_b = torch.where(degenerate, b - 1, best % b).to(torch.int32)
    return split_f, split_b


def _route(xb: torch.Tensor, node: torch.Tensor, split_f: torch.Tensor,
           split_b: torch.Tensor) -> torch.Tensor:
    """Move each (tree, sample) to its child node: node [t, n] (int64)
    -> 2 * node + (xb[sample, split_feature] > split_bin)."""
    sf = split_f.long().gather(1, node)            # [t, n]
    feat_vals = xb.gather(1, sf.T).T               # [t, n]
    go_right = feat_vals > split_b.gather(1, node)
    return node * 2 + go_right.long()


def grow_level(fb_cols: torch.Tensor, node: torch.Tensor, y: torch.Tensor,
               w: torch.Tensor, xb: torch.Tensor, ranks: torch.Tensor, *,
               n_nodes: int, n_classes: int, n_features: int, n_bins: int,
               subset: int, impurity: str):
    """One level for every tree at once.

    fb_cols: [n, f]      flat feature-bin columns (shared across trees)
    node:    [t, n]      current node of each sample in each tree (int64)
    y:       [n]         class ids (int64)
    w:       [t, n]      bootstrap weights
    xb:      [n, f]      binned features
    ranks:   [t, nd, f]  per-node feature ranks (the random subset)
    Returns (split_feature [t, nd], split_bin [t, nd], new node [t, n])."""
    kw = dict(n_nodes=n_nodes, c=n_classes, f=n_features, b=n_bins)
    s = node * n_classes + y[None, :]
    hist = _histogram(s, w, fb_cols, **kw)
    split_f, split_b = _select_splits(hist, ranks, subset=subset,
                                      impurity=impurity, **kw)
    return split_f, split_b, _route(xb, node, split_f, split_b)


def _leaf_counts(node: torch.Tensor, y: torch.Tensor, w: torch.Tensor, *,
                 n_nodes: int, n_classes: int) -> torch.Tensor:
    """Weighted class counts per leaf, [t, n_nodes, C]."""
    t = node.shape[0]
    size = n_nodes * n_classes
    keys = (node * n_classes + y[None, :]
            + torch.arange(t, device=node.device)[:, None] * size)
    counts = torch.zeros(t * size, dtype=torch.float32, device=node.device)
    counts.index_add_(0, keys.reshape(-1), w.reshape(-1))
    return counts.view(t, n_nodes, n_classes)


def draw_ranks(gen: torch.Generator, n_trees: int, n_nodes: int,
               n_features: int) -> torch.Tensor:
    """One level's per-node feature ranks [t, nd, f] (int64, on the
    CPU): the ranks of uniform draws, a uniform random permutation."""
    u = torch.rand((n_trees, n_nodes, n_features), generator=gen)
    return torch.argsort(torch.argsort(u, dim=-1, stable=True), dim=-1,
                         stable=True)


@dataclass
class ForestModel:
    """Level-order flattened forest: internal node i at level l sits at
    global index 2^l - 1 + i."""
    bin_edges: np.ndarray       # [f, B-1]
    split_feature: np.ndarray   # [t, 2^depth - 1]
    split_bin: np.ndarray       # [t, 2^depth - 1]
    leaf_class: np.ndarray      # [t, 2^depth]
    classes: np.ndarray         # [C] original label values
    max_depth: int
    device: str = "cuda"        # where large batches traverse

    @property
    def n_trees(self) -> int:
        return self.split_feature.shape[0]

    def sanity_check(self):
        assert self.split_feature.shape == self.split_bin.shape
        assert self.leaf_class.shape[1] == 2 ** self.max_depth

    def to(self, device=None, items_device=None) -> "ForestModel":
        """This model traversing large batches on `device` (None =
        cuda)."""
        return replace(self, device=str(resolve_device(device)))

    # below this many (tree, sample) traversals the host loop answers
    # (a device call's uploads, launches and fetch cost more than the
    # walk); from it on, the traversal runs on the model's device. On an
    # H100 (phase classification of chip_smoke.py, PERF.md) the card
    # wins from 8,192 cells (8 trees x 1,024 queries) and the host up to
    # 2,560; the JAX package's TPU-tuned 1 << 14 left batchpredict's
    # 1,024-query chunks on the host
    HOST_CROSSOVER_CELLS = 1 << 13

    def predict(self, features: np.ndarray) -> np.ndarray:
        """Majority vote over trees; returns original label values.
        Size-dispatched: big batches run the device traversal, small
        ones the equivalent host loop. Tie-breaking (lowest class index)
        is identical on both paths."""
        xb = apply_bins(np.asarray(features, np.float32), self.bin_edges)
        if self.n_trees * xb.shape[0] >= self.HOST_CROSSOVER_CELLS:
            return self.classes[self.predict_device(xb)]
        return self.classes[self.predict_host(xb)]

    def predict_host(self, xb: np.ndarray) -> np.ndarray:
        """Class indices [n] of binned features by the host loop."""
        t, n = self.n_trees, xb.shape[0]
        c = len(self.classes)
        node = np.zeros((t, n), np.int32)
        rows = np.arange(n)[None, :]
        trees = np.arange(t)[:, None]
        for level in range(self.max_depth):
            off = (1 << level) - 1
            sf = self.split_feature[trees, off + node]
            sb = self.split_bin[trees, off + node]
            node = node * 2 + (xb[rows, sf] > sb)
        votes = self.leaf_class[trees, node]             # [t, n]
        # per-sample class counts in one bincount: flat id = class*n + col
        counts = np.bincount(
            (votes.astype(np.int64) * n + np.arange(n)).ravel(),
            minlength=c * n).reshape(c, n)
        return np.argmax(counts, axis=0)

    def predict_device(self, xb: np.ndarray) -> np.ndarray:
        """Class indices [n] of binned features by `_predict_device` on
        the model's device."""
        dev = resolve_device(self.device)

        def up(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

        return _predict_device(
            up(xb), up(self.split_feature), up(self.split_bin),
            up(self.leaf_class), max_depth=self.max_depth,
            n_classes=len(self.classes)).cpu().numpy()


def _predict_device(xb: torch.Tensor, split_feature: torch.Tensor,
                    split_bin: torch.Tensor, leaf_class: torch.Tensor, *,
                    max_depth: int, n_classes: int) -> torch.Tensor:
    """Forest traversal on the tensors' device: level-unrolled gathers
    and a vote count; returns class indices [n] (argmax ties -> lowest
    index, the host path's np.argmax convention)."""
    t, n = split_feature.shape[0], xb.shape[0]
    node = torch.zeros((t, n), dtype=torch.int64, device=xb.device)
    sf_all, sb_all = split_feature.long(), split_bin.long()
    for level in range(max_depth):
        off = (1 << level) - 1
        sf = sf_all.gather(1, off + node)
        sb = sb_all.gather(1, off + node)
        node = node * 2 + (xb.gather(1, sf.T).T > sb).long()
    votes = leaf_class.long().gather(1, node)            # [t, n]
    counts = torch.zeros((n, n_classes), dtype=torch.int32,
                         device=xb.device)
    counts.scatter_add_(1, votes.T, torch.ones_like(votes.T,
                                                    dtype=torch.int32))
    return torch.argmax(counts, dim=1)


def forest_train(features: np.ndarray, labels: np.ndarray, *,
                 n_trees: int = 10, max_depth: int = 5, max_bins: int = 32,
                 impurity: str = "gini",
                 feature_subset_strategy: str = "auto",
                 seed: int = 0, device=None,
                 timings: Optional[dict] = None) -> ForestModel:
    """Train a random forest on dense features [n, f] and labels [n] on
    `device`. `timings`, if given, is filled with bin_s (host quantile
    binning) and device_s (the draws, upload, level loop and fetch)
    wall-clock phases."""
    dev = resolve_device(device)
    t0 = time.perf_counter()
    features = np.asarray(features, np.float32)
    labels = np.asarray(labels)
    classes, y_np = np.unique(labels, return_inverse=True)
    n, f = features.shape
    c = max(len(classes), 2)
    edges = quantile_bins(features, max_bins)
    xb_np = apply_bins(features, edges)
    subset = _subset_size(feature_subset_strategy, f, n_trees)
    t_bin = time.perf_counter()

    gen = torch.Generator().manual_seed(seed)
    if n_trees == 1:
        w = torch.ones((1, n), dtype=torch.float32)
    else:
        w = torch.poisson(torch.ones((n_trees, n)), generator=gen)
    w = w.to(dev)
    # binned features cross at uint8 (max_bins <= 256) and stay narrow on
    # the device (the router's gather and compare read them as they
    # are); fb_cols is derived on the device
    xb = torch.from_numpy(xb_np).to(dev)
    fb_cols = (xb.to(torch.int32)
               + torch.arange(f, dtype=torch.int32, device=dev)[None, :]
               * max_bins)
    y = torch.from_numpy(y_np.astype(np.int64)).to(dev)
    node = torch.zeros((n_trees, n), dtype=torch.int64, device=dev)

    split_fs, split_bs = [], []
    for level in range(max_depth):
        ranks = draw_ranks(gen, n_trees, 1 << level, f).to(dev)
        sf, sb, node = grow_level(
            fb_cols, node, y, w, xb, ranks, n_nodes=1 << level,
            n_classes=c, n_features=f, n_bins=max_bins, subset=subset,
            impurity=impurity)
        split_fs.append(sf)
        split_bs.append(sb)

    counts = _leaf_counts(node, y, w, n_nodes=1 << max_depth, n_classes=c)
    # empty leaves (never reached in training) fall back to the global
    # class distribution
    global_counts = torch.from_numpy(
        np.bincount(y_np, minlength=c).astype(np.float32)).to(dev)
    counts = counts + 1e-6 * global_counts[None, None, :]
    leaf_class = torch.argmax(counts, dim=-1).to(torch.int32).cpu().numpy()
    split_feature = torch.cat(split_fs, dim=1).cpu().numpy()
    split_bin = torch.cat(split_bs, dim=1).cpu().numpy()
    if timings is not None:
        timings["bin_s"] = t_bin - t0
        timings["device_s"] = time.perf_counter() - t_bin

    return ForestModel(
        bin_edges=edges, split_feature=split_feature, split_bin=split_bin,
        leaf_class=leaf_class, classes=classes.astype(np.float32),
        max_depth=max_depth, device=str(dev))
