"""Entity id maps, rating and pair columns, labeled points."""

from predictionio_tpu_torch.ingest.arrays import (  # noqa: F401
    LabeledPoints, PairColumns, RatingColumns,
    labeled_points_from_properties,
)
from predictionio_tpu_torch.ingest.bimap import BiMap  # noqa: F401
