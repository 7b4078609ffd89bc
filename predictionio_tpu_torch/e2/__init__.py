"""e2: reusable engine/evaluation helpers.

The port of `predictionio_tpu/e2/`, numpy there and numpy here (no
device work). Parity: the reference's standalone `e2/` module
(SURVEY.md §2.5) —
`CategoricalNaiveBayes`, `MarkovChain`, `BinaryVectorizer`
(`e2/src/main/scala/.../engine/`) and `CommonHelperFunctions.splitData`
(`e2/.../evaluation/CrossValidation.scala:26-67`).
"""

from predictionio_tpu_torch.e2.engine import (  # noqa: F401
    BinaryVectorizer, CategoricalNaiveBayes, LabeledPoint, MarkovChain,
)
from predictionio_tpu_torch.e2.evaluation import split_data  # noqa: F401
