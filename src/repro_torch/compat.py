"""Device resolution shared by every entry point of the port."""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means the GPU; only an explicit ``"cpu"`` runs on the CPU.

    Raises ``RuntimeError`` when a CUDA device is asked for (explicitly
    or by default) and none is available — no entry point carries on on
    the CPU because it found no GPU.
    """
    dev = torch.device("cuda") if device is None else torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch: a CUDA device is required "
            f"(device={device!r}) but torch.cuda.is_available() is False; "
            "pass device='cpu' explicitly to run on the CPU")
    return dev
