"""Device selection for the port's entry points.

Entry points take ``device="cuda"`` by default and raise when CUDA is
absent; the CPU is used only when a caller asks for it. Nothing falls back
on its own.
"""

from __future__ import annotations

from typing import Union

import torch


def resolve_device(device: Union[str, torch.device]) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device='cuda' was requested but CUDA is not available; pass "
                "device='cpu' explicitly to run the port on the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
