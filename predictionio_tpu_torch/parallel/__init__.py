"""Device meshes, row sharding over a device list, multi-process setup."""

from predictionio_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    MeshSpec,
    all_reduce,
    data_mesh,
    gather_rows,
    initialize_distributed,
    local_devices,
    make_mesh,
    pad_rows,
    pad_to_multiple,
    shard_put,
    spans,
    split_over_data,
)
