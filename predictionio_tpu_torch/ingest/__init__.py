"""Entity id maps, rating columns and labeled points."""

from predictionio_tpu_torch.ingest.arrays import (  # noqa: F401
    LabeledPoints, RatingColumns, labeled_points_from_properties,
)
from predictionio_tpu_torch.ingest.bimap import BiMap  # noqa: F401
