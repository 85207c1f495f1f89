"""Prefill attention over the ring KV cache (counterpart of
gemma_tpu/ops/flash_attention.py:flash_prefill_attention; reference
gemma/flash_attention.{h,cc}).

On CUDA tensors it launches the kernel of csrc/flash_attention.cu (K5)
for the pool's type (i8, bf16 or f32); on CPU tensors it runs the plain
dense version (ops/attention.py) over the same mask.  Positions must be
contiguous per query (positions[b, i] == positions[b, 0] + i), which
chunked prefill guarantees.
"""

from __future__ import annotations

import torch

from gemma_tpu_torch.ops import _cuda
from gemma_tpu_torch.ops.attention import (attention_mask,
                                           dot_softmax_weighted_sum,
                                           dot_softmax_weighted_sum_q)

FLASH_ATTENTION_I8 = _cuda.Kernel(
    "flash_attention_i8", "flash_attention.cu", "gemma_flash_attention_i8",
    [_cuda.P] * 7 + [_cuda.I] * 10 + [_cuda.F])
# bf16 and f32 pools: the same entry without the scales pointer.
FLASH_ATTENTION_BF16 = _cuda.Kernel(
    "flash_attention_bf16", "flash_attention.cu",
    "gemma_flash_attention_bf16", [_cuda.P] * 6 + [_cuda.I] * 10 + [_cuda.F])
FLASH_ATTENTION_F32 = _cuda.Kernel(
    "flash_attention_f32", "flash_attention.cu",
    "gemma_flash_attention_f32", [_cuda.P] * 6 + [_cuda.I] * 10 + [_cuda.F])
_KERNELS = {torch.int8: FLASH_ATTENTION_I8,
            torch.bfloat16: FLASH_ATTENTION_BF16,
            torch.float32: FLASH_ATTENTION_F32}


def _prefix(prefix_end, b, device):
    if isinstance(prefix_end, int):
        return torch.full((b,), prefix_end, dtype=torch.int32, device=device)
    return torch.as_tensor(prefix_end, device=device).to(torch.int32)


def flash_prefill_attention_plain(cache, layer_idx, q, positions, window,
                                  att_cap=0.0, prefix_end=0):
    """K5's function in plain PyTorch: dense masked attention over the ring.
    q [B, T, heads, D] (RoPE'd and scaled) -> [B, T, heads, D] f32."""
    pool, idx, ring = cache.pool(layer_idx)
    mask = attention_mask(positions, ring, window, prefix_end)
    if cache.quantized:
        sc = cache.pool_scale(layer_idx)
        return dot_softmax_weighted_sum_q(
            q, pool[:, idx, 0, :, :ring], pool[:, idx, 1, :, :ring],
            sc[:, idx, 0, :, 0, :ring], sc[:, idx, 1, :, 0, :ring], mask,
            att_cap=att_cap)
    return dot_softmax_weighted_sum(
        q, cache.k_layer(layer_idx)[:, :, :ring],
        cache.v_layer(layer_idx)[:, :, :ring], mask, att_cap=att_cap)


def flash_prefill_attention(cache, layer_idx, q, positions, window,
                            att_cap=0.0, prefix_end=0):
    """Prefill attention (flash_attention.py:205-259).  Returns f32
    [B, T, heads, D]."""
    if not q.is_cuda:
        return flash_prefill_attention_plain(cache, layer_idx, q, positions,
                                             window, att_cap, prefix_end)
    pool, idx, ring = cache.pool(layer_idx)
    sc = cache.pool_scale(layer_idx)
    b, t, heads, d = q.shape
    _, n_layers, _, kvh, s_alloc, _ = pool.shape
    groups = heads // kvh
    kernel = _KERNELS.get(pool.dtype)
    if kernel is None:
        raise ValueError(f"no prefill attention kernel for a {pool.dtype} "
                         "pool")
    _cuda.check(pool, "pool", pool.dtype)
    if kernel is FLASH_ATTENTION_I8:
        _cuda.check(sc, "pool_scale", torch.float32,
                    (b, n_layers, 2, kvh, 1, s_alloc))
    # [B, T, KVH, G, D] -> [B, KVH, T*G, D], rows t-major.
    qg = (q.float().reshape(b, t, kvh, groups, d).permute(0, 2, 1, 3, 4)
          .reshape(b, kvh, t * groups, d).contiguous())
    base = positions[:, 0].to(torch.int32).contiguous()
    newest = positions.amax(dim=-1).to(torch.int32).contiguous()
    pe = _prefix(prefix_end, b, q.device).contiguous()
    out = torch.empty_like(qg)
    scales = () if sc is None else (sc.data_ptr(),)
    kernel.launch(
        qg.data_ptr(), pool.data_ptr(), *scales, base.data_ptr(),
        newest.data_ptr(), pe.data_ptr(), out.data_ptr(), b, n_layers, idx,
        kvh, t * groups, groups, s_alloc, d, ring, int(window),
        float(att_cap))
    return (out.reshape(b, kvh, t, groups, d).permute(0, 2, 1, 3, 4)
            .reshape(b, t, heads, d))
