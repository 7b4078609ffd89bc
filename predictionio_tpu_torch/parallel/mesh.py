"""Row sharding of host arrays over a list of torch devices.

The port of the serving half of `predictionio_tpu/parallel/mesh.py`:
`pad_to_multiple` and `pad_rows` are copies; `shard_put` is the row
sharding that `jax.device_put` with a batch sharding gives there, written
out as one contiguous tensor per device. The list may name one device
more than once (several shards on one card). The training mesh
(`MeshSpec`, `make_mesh`, `initialize_distributed`) comes with the
training slices.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch


def pad_to_multiple(n: int, m: int) -> int:
    """Smallest multiple of m that is >= n (>= m so empty stays shardable)."""
    return max(((n + m - 1) // m) * m, m)


def pad_rows(a: np.ndarray, target: int, fill=0) -> np.ndarray:
    """Pad dim 0 of `a` to `target` rows with `fill`."""
    if a.shape[0] == target:
        return a
    if a.shape[0] > target:
        raise ValueError(f"Cannot pad {a.shape[0]} rows down to {target}")
    pad_width = [(0, target - a.shape[0])] + [(0, 0)] * (a.ndim - 1)
    return np.pad(a, pad_width, constant_values=fill)


def shard_put(host: np.ndarray, devices: Sequence[torch.device]
              ) -> List[torch.Tensor]:
    """Pad dim 0 of `host` with zero rows to a multiple of
    `len(devices)` and place block s of the rows on `devices[s]`: one
    contiguous fp32 tensor of `per_shard` rows per device, never sharing
    memory with `host`."""
    if not devices:
        raise ValueError("shard_put: no devices")
    a = np.ascontiguousarray(host, dtype=np.float32)
    n = len(devices)
    a = pad_rows(a, pad_to_multiple(a.shape[0], n))
    per = a.shape[0] // n
    return [torch.tensor(a[s * per:(s + 1) * per], device=dev)
            for s, dev in enumerate(devices)]
