"""Fused KV-row write + single-token attention for decode (counterpart of
gemma_tpu/ops/decode_attention.py:decode_attention_write_packed).

`decode_attention_write_packed` takes the fused qkv GEMM's f32 row per
batch slot (q heads kv-major, then per-KV-head interleaved K, V), applies
the QK norms and RoPE, writes the new K/V row into the ring in place in
the pool's type (i8 codes with their scales, bf16 or f32; the garbage row
for invalid slots), attends over the ring and returns the att_w GEMM's
bf16 A-row [B, heads*D].  On CUDA tensors it launches the kernel of
csrc/decode_attention.cu (K4) for the pool's type at every ring length;
on CPU tensors it runs the plain version below.
"""

from __future__ import annotations

import torch

from gemma_tpu_torch.ops import _cuda
from gemma_tpu_torch.ops import ops
from gemma_tpu_torch.ops.attention import (attention_mask,
                                           dot_softmax_weighted_sum,
                                           dot_softmax_weighted_sum_q)
from gemma_tpu_torch.ops.kv_quant import quantize_rows

DECODE_ATTENTION_I8 = _cuda.Kernel(
    "decode_attention_i8", "decode_attention.cu", "gemma_decode_attention_i8",
    [_cuda.P] * 9 + [_cuda.I] * 10 + [_cuda.F, _cuda.F])
# bf16 and f32 pools: the same entry without the scales pointer.
DECODE_ATTENTION_BF16 = _cuda.Kernel(
    "decode_attention_bf16", "decode_attention.cu",
    "gemma_decode_attention_bf16",
    [_cuda.P] * 8 + [_cuda.I] * 10 + [_cuda.F, _cuda.F])
DECODE_ATTENTION_F32 = _cuda.Kernel(
    "decode_attention_f32", "decode_attention.cu",
    "gemma_decode_attention_f32",
    [_cuda.P] * 8 + [_cuda.I] * 10 + [_cuda.F, _cuda.F])
_KERNELS = {torch.int8: DECODE_ATTENTION_I8,
            torch.bfloat16: DECODE_ATTENTION_BF16,
            torch.float32: DECODE_ATTENTION_F32}


class RopeSpec:
    """In-kernel position encoding: inverse timescales, PostQKType int,
    query scale folded into q, optional (1 + w) QK norm weights [D]."""

    def __init__(self, inv_timescale: torch.Tensor, post_qk: int,
                 query_scale: float, key_norm=None, query_norm=None):
        self.inv_timescale = inv_timescale
        self.post_qk = int(post_qk)
        self.query_scale = float(query_scale)
        self.key_norm = key_norm
        self.query_norm = query_norm

    def encode(self, x, positions, mul):
        pe = ops.half_rope if self.post_qk == 1 else ops.rope
        return pe(x, positions, self.inv_timescale, mul)


def decode_attention_write_packed_plain(cache, layer_idx, qkv_all, positions,
                                        window, heads, att_cap=0.0,
                                        valid=None, rope: RopeSpec = None):
    """K4's function in plain PyTorch (writes the cache in place)."""
    pool, idx, ring = cache.pool(layer_idx)
    sc = cache.pool_scale(layer_idx)
    b = qkv_all.shape[0]
    kvh, d = pool.shape[3], pool.shape[5]
    q = qkv_all[:, :heads * d].reshape(b, 1, heads, d).float()
    kvp = qkv_all[:, heads * d:].reshape(b, 1, kvh, 2, d).float()
    k, v = kvp[..., 0, :], kvp[..., 1, :]
    if rope.key_norm is not None:
        k = ops.rms_norm(k, rope.key_norm)
    if rope.query_norm is not None:
        q = ops.rms_norm(q, rope.query_norm)
    pos = positions[..., None]  # broadcast over heads
    k = rope.encode(k, pos, 1.0)
    q = rope.encode(q, pos, rope.query_scale)

    rows = torch.remainder(positions[:, 0].long(), ring)
    if valid is not None:  # invalid slots write the garbage row
        rows = torch.where(valid[:, 0], rows, torch.full_like(rows, ring))
    new = torch.stack([k[:, 0], v[:, 0]], dim=1)  # [B, 2, KVH, D]
    if sc is not None:
        new, scale = quantize_rows(new)
    bi = torch.arange(b, device=pool.device)
    for kv in range(2):
        # The row is cast to the pool's type before it is used (:636-638).
        pool[:, idx, kv].permute(0, 2, 1, 3)[bi, rows] = \
            new[:, kv].to(pool.dtype)
        if sc is not None:
            sc[:, idx, kv, :, 0].permute(0, 2, 1)[bi, rows] = scale[:, kv]

    s_alloc = pool.shape[4]
    mask = attention_mask(positions, ring, window, 0)
    mask = torch.cat([mask, torch.zeros(b, 1, s_alloc - ring, dtype=torch.bool,
                                        device=mask.device)], dim=-1)
    if sc is None:
        out = dot_softmax_weighted_sum(q, pool[:, idx, 0], pool[:, idx, 1],
                                       mask, att_cap=att_cap)
    else:
        out = dot_softmax_weighted_sum_q(
            q, pool[:, idx, 0], pool[:, idx, 1], sc[:, idx, 0, :, 0],
            sc[:, idx, 1, :, 0], mask, att_cap=att_cap)
    return out.reshape(b, heads * d).to(torch.bfloat16)


def decode_attention_write_packed(cache, layer_idx, qkv_all, positions,
                                  window, heads, att_cap=0.0, valid=None,
                                  rope: RopeSpec = None):
    """Write the new K/V row and attend (decode_attention.py:1427-1528).

    qkv_all [B, (heads + 2*kv_heads)*D] f32; positions [B, 1] int;
    valid [B, 1] bool or None.  Returns bf16 [B, heads*D]; the cache's
    pool and scales are updated in place."""
    if rope is None:
        raise ValueError("packed decode requires a RopeSpec")
    if not qkv_all.is_cuda:
        return decode_attention_write_packed_plain(
            cache, layer_idx, qkv_all, positions, window, heads, att_cap,
            valid, rope)
    pool, idx, ring = cache.pool(layer_idx)
    sc = cache.pool_scale(layer_idx)
    b, n_layers, _, kvh, s_alloc, d = pool.shape
    _cuda.check(qkv_all, "qkv_all", torch.float32, (b, (heads + 2 * kvh) * d))
    kernel = _KERNELS.get(pool.dtype)
    if kernel is None:
        raise ValueError(f"no decode attention kernel for a {pool.dtype} pool")
    _cuda.check(pool, "pool", pool.dtype)
    if kernel is DECODE_ATTENTION_I8:
        _cuda.check(sc, "pool_scale", torch.float32,
                    (b, n_layers, 2, kvh, 1, s_alloc))
    its = rope.inv_timescale
    _cuda.check(its, "inv_timescale", torch.float32,
                (d // 4 if rope.post_qk == 1 else d // 2,))
    for name, w in (("key_norm", rope.key_norm),
                    ("query_norm", rope.query_norm)):
        if w is not None:
            _cuda.check(w, name, torch.float32, (d,))
    # The kernel derives the ring row (pos % ring, or the garbage row) from
    # the positions and the valid mask itself: no per-layer index ops.
    pos = positions if positions.dtype == torch.int32 \
        else positions.to(torch.int32)
    pos = pos.contiguous()
    _cuda.check(pos, "positions", torch.int32, (b, 1))
    if valid is not None:
        valid = valid.to(torch.bool).contiguous()
        _cuda.check(valid, "valid", torch.bool, (b, 1))
    out = torch.empty(b, heads * d, dtype=torch.bfloat16, device=pool.device)
    scales = () if sc is None else (sc.data_ptr(),)
    kernel.launch(
        qkv_all.data_ptr(), its.data_ptr(), _cuda.ptr(rope.key_norm),
        _cuda.ptr(rope.query_norm), pool.data_ptr(), *scales,
        pos.data_ptr(), _cuda.ptr(valid), out.data_ptr(),
        b, n_layers, idx, kvh, heads, s_alloc, d, ring, int(window),
        rope.post_qk, rope.query_scale, float(att_cap))
    return out
