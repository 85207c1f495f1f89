"""Transformer elementwise ops (counterpart of gemma_tpu/ops/ops.py; the
reference formulas are ops/ops-inl.h and ops/ops.h).

The formulas are load-bearing for parity and are kept op for op:
RMSNorm with eps inside the rsqrt and (1 + w) scaling, split-halves RoPE
with pow-computed inverse timescales, the tanh Gelu with the training
constants, soft caps cap*tanh(x/cap), and the embedding scale sqrt(dim)
rounded to bf16 before the multiply.
"""

from __future__ import annotations

import numpy as np
import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """RMSNorm with (1 + weight), f32 accumulation (ops-inl.h:212-245).

    x: [..., size], weight: [size]; returns x's dtype."""
    xf = x.float()
    mul = torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + 1e-6)
    m = xf * mul
    out = m + m * weight.float()
    return out.to(x.dtype)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Tanh-approximation Gelu with the reference's constants (ops-inl.h:127-137)."""
    xf = x.float()
    arg = xf * (0.797884560804236 + 0.03567740813636141 * xf * xf)
    return (xf * (0.5 + 0.5 * torch.tanh(arg))).to(x.dtype)


def soft_cap(cap: float, x: torch.Tensor) -> torch.Tensor:
    """cap * tanh(x / cap); identity when cap == 0 (ops-inl.h:1259-1308)."""
    if cap == 0.0:
        return x
    return (cap * torch.tanh(x.float() / cap)).to(x.dtype)


def create_inv_timescale(qkv_dim: int, half_rope: bool = False,
                         base_frequency: float = 10000.0) -> np.ndarray:
    """RoPE inverse timescales, f64 pow then f32 (ops/ops.h:28-42)."""
    rope_dim = qkv_dim // 2 if half_rope else qkv_dim
    dims = np.arange(rope_dim // 2, dtype=np.float64)
    return (1.0 / np.power(base_frequency, 2.0 * dims / rope_dim)).astype(
        np.float32)


def rope(x: torch.Tensor, pos: torch.Tensor, inv_timescale: torch.Tensor,
         mul: float = 1.0) -> torch.Tensor:
    """Split-halves RoPE (ops-inl.h:358-475), `mul` applied before the rotation.

    x: [..., D]; pos broadcastable to x.shape[:-1]."""
    half = x.shape[-1] // 2
    xf = x.float() * mul
    theta = pos.float()[..., None] * inv_timescale.float()
    sin, cos = torch.sin(theta), torch.cos(theta)
    x0, x1 = xf[..., :half], xf[..., half:]
    return torch.cat([x0 * cos - x1 * sin, x0 * sin + x1 * cos],
                     dim=-1).to(x.dtype)


def half_rope(x: torch.Tensor, pos: torch.Tensor, inv_timescale: torch.Tensor,
              mul: float = 1.0) -> torch.Tensor:
    """PostQKType::HalfRope: rotate the first half, then scale everything
    (gemma/attention.cc:89-95)."""
    half = x.shape[-1] // 2
    rotated = rope(x[..., :half], pos, inv_timescale)
    out = torch.cat([rotated, x[..., half:]], dim=-1)
    return (out.float() * mul).to(x.dtype)


def embedding_scaling(model_dim: int) -> float:
    """sqrt(model_dim) rounded to bf16 (gemma/gemma.cc:119-123)."""
    s = torch.tensor(float(np.sqrt(np.float32(model_dim))), dtype=torch.float32)
    return float(s.to(torch.bfloat16))


def softmax(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Max-subtracted softmax in f32 (ops-inl.h:1125-1171)."""
    xf = x.float()
    e = torch.exp(xf - xf.amax(dim=dim, keepdim=True))
    return e / e.sum(dim=dim, keepdim=True)
