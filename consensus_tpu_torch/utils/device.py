"""Device selection for the port's entry points.

Entry points run on the GPU unless the caller asks for the CPU: with no
device given they take ``cuda`` and raise when no card is present, so a
run meant for the GPU never carries on silently on the CPU.  A CUDA device
always comes back with its index (``cuda`` alone is the card current at
resolution), so a device mesh's shards never follow whichever card is
current later.
"""

from __future__ import annotations

from typing import Optional

import torch


def resolve_device(device: Optional[str | torch.device] = None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
