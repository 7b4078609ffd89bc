"""Cross-validation helpers.

The port of `predictionio_tpu/e2/evaluation.py`.

Parity: `e2/.../evaluation/CrossValidation.scala:26-67` —
`CommonHelperFunctions.splitData`: k folds by index modulo; each fold
yields (training points, eval info, [(query, actual)]) matching the
`readEval` contract.
"""

from __future__ import annotations

from typing import Callable, List, Sequence, Tuple, TypeVar

T = TypeVar("T")
Q = TypeVar("Q")
A = TypeVar("A")


def split_data(k: int, data: Sequence[T],
               to_training: Callable[[Sequence[T]], object],
               to_qa: Callable[[T], Tuple[Q, A]]
               ) -> List[Tuple[object, str, List[Tuple[Q, A]]]]:
    """k folds by element-index modulo (zipWithIndex % k semantics)."""
    if k < 2:
        raise ValueError("k must be >= 2")
    folds = []
    for fold in range(k):
        train = [x for i, x in enumerate(data) if i % k != fold]
        test = [x for i, x in enumerate(data) if i % k == fold]
        folds.append((to_training(train), f"fold{fold}",
                      [to_qa(x) for x in test]))
    return folds
