"""Multinomial Naive Bayes over dense nonnegative features.

The port of `predictionio_tpu/ops/naive_bayes.py`, which replaces Spark
MLlib `NaiveBayes` as used by the classification template
(`examples/scala-parallel-classification/add-algorithm/src/main/scala/
NaiveBayesAlgorithm.scala:35-56`). MLlib's multinomial NB computes
per-class log priors pi_c = log(N_c / N) and log likelihoods theta_cj =
log((sum of feature j over class c + lambda) / (total over class c +
lambda * d)); prediction is argmax_c (pi_c + x . theta_c).

The fit is two class sums and a few logs on `device` (None = cuda;
raises without CUDA unless `device="cpu"`). The class sums are one fp32
product of the class one-hot with the features (TF32 is off,
`device.resolve_device`): on whole-number features below 2^24 per sum
they are exact in any summation order, so the card's statistics equal
the CPU's bit for bit. Prediction scores on the model's device.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, replace
from typing import Optional

import numpy as np
import torch

from predictionio_tpu_torch.device import resolve_device


@dataclass
class NaiveBayesModel:
    pi: np.ndarray        # [n_classes] log priors
    theta: np.ndarray     # [n_classes, d] log likelihoods
    labels: np.ndarray    # [n_classes] original label values
    device: str = "cuda"  # where predict scores

    def sanity_check(self):
        assert np.isfinite(self.pi).all() and np.isfinite(self.theta).all()

    def to(self, device=None, items_device=None) -> "NaiveBayesModel":
        """This model scoring on `device` (None = cuda)."""
        return replace(self, device=str(resolve_device(device)))


def _fit(features: torch.Tensor, class_ix: torch.Tensor, lam: float, *,
         n_classes: int):
    """(pi [C], theta [C, d]) from features [n, d] (any dtype: a narrow
    upload widens here) and class indices [n], on their device."""
    d = features.shape[1]
    x = features.to(torch.float32)
    onehot = torch.nn.functional.one_hot(
        class_ix.long(), n_classes).to(torch.float32)      # [n, C]
    counts = onehot.sum(0)
    feat_sums = onehot.T @ x                               # [C, d]
    lam_t = torch.tensor(lam, dtype=torch.float32, device=x.device)
    pi = torch.log(counts) - torch.log(counts.sum())
    theta = (torch.log(feat_sums + lam_t)
             - torch.log(feat_sums.sum(1, keepdim=True) + lam_t * d))
    return pi, theta


def _integer_valued(a: np.ndarray) -> bool:
    """True iff every element is a whole number. Integer dtypes answer
    without touching the data; float inputs scan in row chunks so no
    features-sized temporary is ever allocated."""
    if np.issubdtype(a.dtype, np.integer) or a.dtype == bool:
        return True
    step = max(1, (1 << 22) // max(1, int(np.prod(a.shape[1:]))))
    for s in range(0, a.shape[0], step):
        chunk = a[s:s + step]
        if not np.equal(np.mod(chunk, 1.0), 0).all():
            return False
    return True


def narrow_features(features: np.ndarray) -> np.ndarray:
    """The features in the cheapest EXACT upload dtype: uint8 for whole
    numbers below 256 (the multinomial regime: a quarter of the f32
    bytes), uint16 below 65,536, float32 otherwise. Requires
    nonnegative features."""
    src = np.asarray(features)
    feats = np.asarray(src, np.float32)   # zero-copy when already f32
    if _integer_valued(src):
        fmax = feats.max(initial=0.0)
        if fmax < 256:
            return feats.astype(np.uint8)
        if fmax < 65536:
            return feats.astype(np.uint16)
    return feats


def nb_train(features: np.ndarray, labels: np.ndarray,
             lam: float = 1.0, *, device=None,
             timings: Optional[dict] = None) -> NaiveBayesModel:
    """features [n, d] nonnegative; labels [n] arbitrary floats/ints.

    The upload narrows to `narrow_features`' dtype and widens on the
    device; accumulation is f32 in every case. `timings`, if given, is
    filled with transfer_s (the upload, synchronized) and solve_s (the
    fit and the fetch) wall-clock phases."""
    dev = resolve_device(device)
    if features.shape[0] == 0:
        raise ValueError("no training points")
    if float(np.asarray(features).min(initial=0.0)) < 0:
        raise ValueError("multinomial NB requires nonnegative features")
    uniq = np.unique(labels)
    class_ix = np.searchsorted(uniq, labels).astype(np.int32)
    feats_np = narrow_features(features)
    t0 = time.perf_counter()
    feats_d = torch.from_numpy(np.ascontiguousarray(feats_np)).to(dev)
    cix_d = torch.from_numpy(class_ix).to(dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t1 = time.perf_counter()
    pi, theta = _fit(feats_d, cix_d, lam, n_classes=len(uniq))
    out = NaiveBayesModel(pi.cpu().numpy(), theta.cpu().numpy(), uniq,
                          str(dev))
    if timings is not None:
        timings["transfer_s"] = t1 - t0
        timings["solve_s"] = time.perf_counter() - t1
    return out


def _scores(model: NaiveBayesModel, features: np.ndarray) -> np.ndarray:
    dev = resolve_device(model.device)
    pi = torch.from_numpy(np.asarray(model.pi, np.float32)).to(dev)
    theta = torch.from_numpy(np.asarray(model.theta, np.float32)).to(dev)
    x = torch.from_numpy(np.ascontiguousarray(features, np.float32)).to(dev)
    return (pi[None, :] + x @ theta.T).cpu().numpy()


def nb_predict(model: NaiveBayesModel, features: np.ndarray) -> np.ndarray:
    """Returns predicted original label values, [b]."""
    return model.labels[np.argmax(_scores(model, features), axis=1)]


def nb_predict_proba(model: NaiveBayesModel,
                     features: np.ndarray) -> np.ndarray:
    scores = _scores(model, features)
    e = np.exp(scores - scores.max(axis=1, keepdims=True))
    return e / e.sum(axis=1, keepdims=True)
