"""bf16 bit patterns in numpy (counterpart of the helpers of the same
names in gemma_tpu/utils/basics.py, which lean on a bfloat16 numpy dtype;
these use integer arithmetic alone, so the codecs need numpy and nothing
else)."""

from __future__ import annotations

import numpy as np


def f32_to_bf16_truncate(x: np.ndarray) -> np.ndarray:
    """Truncate f32 to bf16 by chopping the low 16 bits (no rounding).

    The reference's SFP encoder truncates rather than rounds because the SFP
    rounding step follows (compression/sfp-inl.h:478-480).
    """
    u = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    return (u >> 16).astype(np.uint16)


def f32_to_bf16_round(x: np.ndarray) -> np.ndarray:
    """Round-to-nearest-even f32 -> bf16 bit pattern (uint16); a NaN stays
    a quiet NaN of its sign."""
    u = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    rounded = (u + (np.uint32(0x7FFF) + ((u >> 16) & np.uint32(1)))) >> 16
    nan = (u & np.uint32(0x7FFFFFFF)) > np.uint32(0x7F800000)
    return np.where(nan, (u >> 16) | np.uint32(0x40), rounded).astype(
        np.uint16)


def bf16_bits_to_f32(u16: np.ndarray) -> np.ndarray:
    """Expand bf16 bit patterns (uint16) to f32."""
    return (np.asarray(u16, dtype=np.uint32) << 16).view(np.float32)
