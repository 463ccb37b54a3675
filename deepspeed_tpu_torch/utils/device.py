"""Device selection for the port's entry points: they run on the card
unless the caller asks for the CPU."""

from __future__ import annotations

import os

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means this rank's card, ``cuda:(LOCAL_RANK % cards)``
    (``cuda:0`` for a single process). A CUDA device where no card is
    present raises instead of carrying on silently on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port's plain PyTorch path on the CPU")
    if device is None:
        local = int(os.environ.get("LOCAL_RANK", "0"))
        dev = torch.device("cuda", local % torch.cuda.device_count())
    return dev
