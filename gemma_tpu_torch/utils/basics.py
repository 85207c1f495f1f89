"""Integer helpers shared by the port (counterpart of gemma_tpu/utils/basics.py)."""

from __future__ import annotations

import torch

# Reference: gemma/tokenizer.h:29 (BOS_ID = 2).
BOS_ID = 2


def round_up(x: int, multiple: int) -> int:
    return ((x + multiple - 1) // multiple) * multiple


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def resolve_device(device: str | torch.device | None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names one.

    Raises when CUDA is asked for (explicitly or by default) and absent:
    the port never drops to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch path on the CPU")
    return dev
