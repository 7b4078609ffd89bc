"""Device selection for the port's entry points.

Every entry point takes an explicit `device` argument and runs on CUDA
unless the caller asks for the CPU. There is no silent CPU carry-on: a
process without a GPU that asks for nothing gets an error, so a run can
never look like a device run while it is not one.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """`device` as a `torch.device`; None means `cuda`. Raises when the
    result is a CUDA device and CUDA is not available."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested (the default) but CUDA is not "
            "available in this process; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    return dev
