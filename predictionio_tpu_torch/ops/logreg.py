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
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np
import torch

from predictionio_tpu_torch.device import resolve_device
from predictionio_tpu_torch.ops.adam import Adam


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


def _fit(features: torch.Tensor, class_ix: torch.Tensor, *, n_classes: int,
         steps: int, lr: float, reg: float):
    """(w [d, C], b [C]) after `steps` Adam steps on the standardized
    features [n, d], on their device."""
    n, d = features.shape
    dev = features.device
    w = torch.zeros((d, n_classes), dtype=torch.float32, device=dev,
                    requires_grad=True)
    b = torch.zeros((n_classes,), dtype=torch.float32, device=dev,
                    requires_grad=True)
    onehot = torch.nn.functional.one_hot(
        class_ix.long(), n_classes).to(torch.float32)
    params = (w, b)
    adam = Adam(params, lr)
    for _ in range(steps):
        logits = features @ w + b
        per_ex = (onehot * torch.log_softmax(logits, dim=1)).sum(1)
        loss = -per_ex.sum() / n + reg * (w * w).sum()
        adam.step(torch.autograd.grad(loss, params))
    return w.detach(), b.detach()


def logreg_train(features: np.ndarray, labels: np.ndarray, *,
                 steps: int = 200, lr: float = 0.1,
                 reg: float = 1e-4, device=None) -> LogRegModel:
    dev = resolve_device(device)
    if features.shape[0] == 0:
        raise ValueError("no training points")
    uniq = np.unique(labels)
    class_ix = np.searchsorted(uniq, labels).astype(np.int32)
    # standardize features for conditioning; fold the transform into w/b
    mu = features.mean(axis=0)
    sd = features.std(axis=0) + 1e-8
    fs = ((features - mu) / sd).astype(np.float32)
    w, b = _fit(torch.from_numpy(fs).to(dev),
                torch.from_numpy(class_ix).to(dev), n_classes=len(uniq),
                steps=steps, lr=lr, reg=reg)
    w = w.cpu().numpy() / sd[:, None]
    b = b.cpu().numpy() - mu @ w
    return LogRegModel(w, b, uniq, str(dev))


def logreg_predict(model: LogRegModel, features: np.ndarray) -> np.ndarray:
    dev = resolve_device(model.device)
    w = torch.from_numpy(np.asarray(model.w, np.float32)).to(dev)
    b = torch.from_numpy(np.asarray(model.b, np.float32)).to(dev)
    x = torch.from_numpy(np.ascontiguousarray(features, np.float32)).to(dev)
    return model.labels[np.argmax((x @ w + b).cpu().numpy(), axis=1)]
