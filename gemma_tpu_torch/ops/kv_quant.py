"""Int8 KV-cache row quantization (counterpart of gemma_tpu/ops/kv_quant.py).

One symmetric scale per (batch, layer, k/v, head, position):
scale = max|row| / 127, codes = round-half-to-even(row / scale).  The
attention kernels apply the scales to their outputs (scores pick up
scale_k, probabilities scale_v), so the [S, D] panels are never
dequantized element by element.
"""

from __future__ import annotations

import torch

KV_QMAX = 127.0


def quantize_rows(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x: [..., D] -> (codes i8 [..., D], scale f32 [...]); zero rows get scale 0."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1)
    # Divided by a tensor, not a Python number: torch's CUDA kernels
    # multiply by a scalar divisor's reciprocal instead, which can land one
    # ulp off the division the JAX package and the kernels compute.
    scale = amax / torch.full_like(amax, KV_QMAX)
    inv = torch.where(scale > 0.0, 1.0 / scale, torch.zeros_like(scale))
    # torch.round rounds half to even, as jnp.rint does.
    codes = torch.round(xf * inv[..., None]).to(torch.int8)
    return codes, scale


def dequantize_rows(codes: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """codes i8 [..., D], scale f32 [...] -> f32 [..., D]."""
    return codes.float() * scale[..., None].float()
