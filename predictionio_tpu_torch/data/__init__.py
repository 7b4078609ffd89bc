"""Events, the storage SPI with its MEM, SQLITE, EVLOG and PEVLOG
drivers, the engine-facing store facade, entity maps and batch views.
Importing it loads no torch: PEVLOG's spawn-started scan workers import
`data.storage`."""

from predictionio_tpu_torch.data.view import DataView  # noqa: F401
