"""Device selection for the port's entry points.

Every entry point takes an explicit `device` argument and runs on CUDA
unless the caller asks for the CPU. There is no silent CPU carry-on: a
process without a GPU that asks for nothing gets an error, so a run can
never look like a device run while it is not one.

Exact fp32 products are set here too, once for the process: matrix
products on CUDA do not round their fp32 inputs to TF32. The JAX package
pins `Precision.HIGHEST` per operation; torch has only the process-wide
flag, so no code of the port sets it back, and a solve in one thread
cannot turn TF32 on under a product in another.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """`device` as a `torch.device`; None means `cuda`. Raises when the
    result is a CUDA device and CUDA is not available. Turns TF32 off
    for fp32 matrix products (idempotent)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested (the default) but CUDA is not "
            "available in this process; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    return dev
