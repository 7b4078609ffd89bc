"""Reusable algorithm helpers over string-categorical data.

The port of `predictionio_tpu/e2/engine.py`.

Parity targets:
  - `CategoricalNaiveBayes` — NB over string feature vectors with
    per-position likelihood maps and an unseen-feature default hook
    (`e2/.../engine/CategoricalNaiveBayes.scala:26-170`)
  - `MarkovChain` — row-normalized top-N sparse transition matrix
    (`e2/.../engine/MarkovChain.scala:28-88`)
  - `BinaryVectorizer` — (property, value) pair -> binary feature vector
    (`e2/.../engine/BinaryVectorizer.scala`)

These are host-side helpers for small categorical models; the dense
numerical kernels live in `predictionio_tpu_torch.ops`.
"""

from __future__ import annotations

import math
from collections import Counter, defaultdict
from dataclasses import dataclass
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np


@dataclass(frozen=True)
class LabeledPoint:
    """(LabeledPoint, CategoricalNaiveBayes.scala:173)"""
    label: str
    features: Tuple[str, ...]


class CategoricalNaiveBayes:
    """NB over string-categorical features.

    `log_score` returns None when the point's label is unknown; unseen
    feature values fall back to `default_likelihood` (a function of the
    position's log-likelihood values), matching
    `CategoricalNaiveBayes.scala logScoreInternal`.
    """

    def __init__(self, priors: Dict[str, float],
                 likelihoods: Dict[str, List[Dict[str, float]]]):
        self.priors = priors            # label -> log prior
        self.likelihoods = likelihoods  # label -> per-position value->loglik

    @staticmethod
    def train(points: Iterable[LabeledPoint]) -> "CategoricalNaiveBayes":
        points = list(points)
        if not points:
            raise ValueError("no training points")
        n_features = len(points[0].features)
        label_counts = Counter(p.label for p in points)
        total = sum(label_counts.values())
        priors = {lb: math.log(c / total) for lb, c in label_counts.items()}
        likelihoods: Dict[str, List[Dict[str, float]]] = {}
        for lb, c in label_counts.items():
            per_pos = []
            for j in range(n_features):
                counts = Counter(p.features[j] for p in points
                                 if p.label == lb)
                per_pos.append({v: math.log(k / c)
                                for v, k in counts.items()})
            likelihoods[lb] = per_pos
        return CategoricalNaiveBayes(priors, likelihoods)

    def log_score(self, point: LabeledPoint,
                  default_likelihood: Callable[[List[float]], float]
                  = lambda lls: float("-inf")) -> Optional[float]:
        if point.label not in self.priors:
            return None
        lls = self.likelihoods[point.label]
        score = self.priors[point.label]
        for j, v in enumerate(point.features):
            if v in lls[j]:
                score += lls[j][v]
            else:
                score += default_likelihood(list(lls[j].values()))
        return score

    def predict(self, features: Sequence[str]) -> str:
        """argmax label (CategoricalNaiveBayes.scala predict); unseen
        feature values score strictly below every seen value of that
        position."""
        def unseen(lls: List[float]) -> float:
            return (min(lls) if lls else 0.0) - math.log(2.0)

        best, best_score = None, float("-inf")
        for lb in self.priors:
            s = self.log_score(LabeledPoint(lb, tuple(features)), unseen)
            if s is not None and s > best_score:
                best, best_score = lb, s
        return best


class MarkovChain:
    """Top-N row-normalized transition model (MarkovChain.scala:28-88)."""

    def __init__(self, transitions: Dict[int, List[Tuple[int, float]]],
                 n_states: int):
        self.transitions = transitions
        self.n_states = n_states

    @staticmethod
    def train(pairs: Iterable[Tuple[int, int]], n_states: int,
              top_n: int = 10) -> "MarkovChain":
        counts: Dict[int, Counter] = defaultdict(Counter)
        for a, b in pairs:
            counts[a][b] += 1
        transitions: Dict[int, List[Tuple[int, float]]] = {}
        for a, c in counts.items():
            total = sum(c.values())
            top = c.most_common(top_n)
            transitions[a] = [(b, k / total) for b, k in top]
        return MarkovChain(transitions, n_states)

    def predict(self, state: int) -> List[Tuple[int, float]]:
        """One transition step from `state` (MarkovChain predict)."""
        return self.transitions.get(state, [])


class BinaryVectorizer:
    """(property, value) pairs -> fixed binary vector
    (BinaryVectorizer.scala)."""

    def __init__(self, index: Dict[Tuple[str, str], int]):
        self.index = index
        self.num_features = len(index)

    @staticmethod
    def fit(maps: Iterable[Dict[str, str]],
            properties: Sequence[str]) -> "BinaryVectorizer":
        seen: Dict[Tuple[str, str], int] = {}
        for m in maps:
            for p in properties:
                if p in m and (p, m[p]) not in seen:
                    seen[(p, m[p])] = len(seen)
        return BinaryVectorizer(seen)

    def to_vector(self, m: Dict[str, str]) -> np.ndarray:
        out = np.zeros(self.num_features, np.float32)
        for key, ix in self.index.items():
            if m.get(key[0]) == key[1]:
                out[ix] = 1.0
        return out
