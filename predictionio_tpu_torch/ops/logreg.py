"""Softmax (multinomial logistic) regression by full-batch Adam.

The port of `predictionio_tpu/ops/logreg.py`, the classification
template's alternative algorithm (SURVEY.md §2 lists
LogisticRegression among the MLlib kernels to replace). Features are
standardized on the host and the transform folded back into w and b
afterwards, as in the JAX package. The loop runs on `device` (None =
cuda; raises without CUDA unless `device="cpu"`): `steps` full-batch
steps from zero w and b, the gradient of

    -mean(onehot . log_softmax(x w + b)) + reg * sum(w^2)

(no penalty on b) by autograd, and a hand-written Adam update in
optax's order and at optax's defaults (b1 0.9, b2 0.999, eps 1e-8,
eps_root 0; the bias corrections `1 - b**count` in float32; the
shared `ops.adam.Adam`), so that the CPU and the card run the same
arithmetic. The result agrees with the JAX package's optax loop to fp32
summation order.

Over a mesh (`logreg_train(mesh=)`) the samples shard over "data" with a
`mask` column that is 0 on the padding rows, as in the JAX package's
masked mean: each shard's masked partial sum of the cross-entropy is
divided by the global `mask.sum()`, the shards' gradients add up by
autograd on this process's first shard device (w and b move to each
shard with `.to`) and `all_reduce` over processes, the penalty's
gradient counted once. Adam stays replicated. One device is a mesh of
one shard (`parallel.data_mesh`).
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np
import torch

from predictionio_tpu_torch.device import resolve_device
from predictionio_tpu_torch.ops.adam import Adam
from predictionio_tpu_torch.parallel.mesh import (all_reduce, data_mesh,
                                                  shard_put)


@dataclass
class LogRegModel:
    w: np.ndarray         # [d, n_classes]
    b: np.ndarray         # [n_classes]
    labels: np.ndarray    # [n_classes] original label values
    device: str = "cuda"  # where predict computes the logits

    def sanity_check(self):
        assert np.isfinite(self.w).all() and np.isfinite(self.b).all()

    def to(self, device=None, items_device=None) -> "LogRegModel":
        """This model predicting on `device` (None = cuda)."""
        return replace(self, device=str(resolve_device(device)))


def _adam_loop(shards, d: int, n: float, dev, *, n_classes: int, steps: int,
               lr: float, reg: float, mesh=None):
    """(w [d, C], b [C]) on `dev` after `steps` full-batch Adam steps:
    the cross-entropy of `shards` (each (features [n_s, d], one-hot
    [n_s, C] weighted by the row mask) on its device) summed and divided
    by `n`, plus the penalty, counted once over `mesh`'s processes, whose
    gradients sum."""
    w = torch.zeros((d, n_classes), dtype=torch.float32, device=dev,
                    requires_grad=True)
    b = torch.zeros((n_classes,), dtype=torch.float32, device=dev,
                    requires_grad=True)
    params = (w, b)
    adam = Adam(params, lr)
    penalty = mesh is None or mesh.process_index == 0
    for _ in range(steps):
        loss = None
        for x, onehot in shards:
            logits = x @ w.to(x.device) + b.to(x.device)
            per_ex = (onehot * torch.log_softmax(logits, dim=1)).sum(1)
            part = (-per_ex.sum() / n).to(dev)
            loss = part if loss is None else loss + part
        if penalty:
            loss = loss + reg * (w * w).sum()
        grads = torch.autograd.grad(loss, params)
        if mesh is not None:
            grads = [all_reduce(g, mesh) for g in grads]
        adam.step(grads)
    return w.detach(), b.detach()


def _fit(features: torch.Tensor, class_ix: torch.Tensor, *, n_classes: int,
         steps: int, lr: float, reg: float):
    """(w [d, C], b [C]) after `steps` Adam steps on the standardized
    features [n, d], on their device: `_adam_loop` on tensors already
    there (for timing the loop alone)."""
    n, d = features.shape
    onehot = torch.nn.functional.one_hot(
        class_ix.long(), n_classes).to(torch.float32)
    return _adam_loop([(features, onehot)], d, n, features.device,
                      n_classes=n_classes, steps=steps, lr=lr, reg=reg)


def _fit_on_mesh(fs: np.ndarray, class_ix: np.ndarray, dm, *,
                 n_classes: int, steps: int, lr: float, reg: float):
    """`_fit` over the shards of the one-axis "data" mesh `dm` (see the
    module docstring); (w, b) on this process's first shard device."""
    shards = [(x, torch.nn.functional.one_hot(c.long(), n_classes)
               .to(torch.float32) * m[:, None])
              for x, c, m in zip(shard_put(fs, dm),
                                 shard_put(class_ix, dm, dtype=None),
                                 shard_put(np.ones(len(class_ix),
                                                   np.float32), dm))]
    # n: the global mask.sum()
    return _adam_loop(shards, fs.shape[1], max(float(len(class_ix)), 1.0),
                      dm.local_devices[0], n_classes=n_classes, steps=steps,
                      lr=lr, reg=reg, mesh=dm)


def logreg_train(features: np.ndarray, labels: np.ndarray, *,
                 steps: int = 200, lr: float = 0.1,
                 reg: float = 1e-4, device=None,
                 mesh=None) -> LogRegModel:
    """`mesh` (a `parallel.Mesh`) shards the samples over its "data"
    axis and the model predicts on its first local device (a mesh of
    one "data" shard trains there as on one device); None trains on
    `device`."""
    dev = resolve_device(device if mesh is None else mesh.local_devices[0])
    if features.shape[0] == 0:
        raise ValueError("no training points")
    uniq = np.unique(labels)
    class_ix = np.searchsorted(uniq, labels).astype(np.int32)
    # standardize features for conditioning; fold the transform into w/b
    mu = features.mean(axis=0)
    sd = features.std(axis=0) + 1e-8
    fs = ((features - mu) / sd).astype(np.float32)
    w, b = _fit_on_mesh(fs, class_ix, data_mesh(mesh, dev),
                        n_classes=len(uniq), steps=steps, lr=lr, reg=reg)
    w = w.cpu().numpy() / sd[:, None]
    b = b.cpu().numpy() - mu @ w
    return LogRegModel(w, b, uniq, str(dev))


def logreg_predict(model: LogRegModel, features: np.ndarray) -> np.ndarray:
    dev = resolve_device(model.device)
    w = torch.from_numpy(np.asarray(model.w, np.float32)).to(dev)
    b = torch.from_numpy(np.asarray(model.b, np.float32)).to(dev)
    x = torch.from_numpy(np.ascontiguousarray(features, np.float32)).to(dev)
    return model.labels[np.argmax((x @ w + b).cpu().numpy(), axis=1)]
