"""Device resolution for every entry point of the port."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda:0``; anything else as given.

    Raises when CUDA is asked for (explicitly or by default) and is absent:
    the port never falls back to the CPU silently — a caller that wants the
    CPU says ``device="cpu"``."""
    dev = torch.device("cuda:0" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but CUDA is not available; pass "
            "device='cpu' to run the plain PyTorch path")
    return dev
