"""Multi-tenant admission of the serving tier (the port of
`predictionio_tpu/tenancy/`): per-app auth with the event server's access
keys, token-bucket and concurrency quotas with metadata-store overrides,
and the micro-batcher's weighted-fair (DRR) lanes.

  admission.py  TenancyConfig, AdmissionController, TenantIdentity
  drr.py        DRRQueue, the batcher's pending store

Off by default (`PIO_TENANCY=off`): the serve path then keeps one FIFO
lane, no auth and no charge.
"""

from predictionio_tpu_torch.tenancy.admission import (  # noqa: F401
    DEFAULT_TENANT, TENANT_HEADER, AdmissionController, BoundedTenantMap,
    QuotaExceeded, TenancyConfig, TenantIdentity,
)
from predictionio_tpu_torch.tenancy.drr import DRRQueue  # noqa: F401
