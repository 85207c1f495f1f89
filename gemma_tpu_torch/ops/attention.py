"""Attention over the ring KV cache, dense (counterpart of
gemma_tpu/ops/attention.py; reference gemma/attention.cc).

These are the plain references for the two attention kernels
(ops/decode_attention.py, ops/flash_attention.py):
  - GQA: `heads` query heads share `kv_heads` KV heads (attention.cc:184).
  - Sliding window: keys pos - min(window-1, pos) .. pos (attention.cc:167-170).
  - Prefix-LM: the last attendable position extends to prefix_end - 1
    (attention.cc:207-211).
  - Soft cap on scores, then an exact f32 softmax (attention.cc:156-159).
  - Ring: cache row = pos % ring; a row holds the newest absolute
    position mapping to it (attention.cc:60-72).
"""

from __future__ import annotations

import torch

from gemma_tpu_torch.ops.ops import soft_cap as soft_cap_op

NEG_INF = -2.3819763e38  # HWY LowestValue<float> scale of masking


def ring_key_positions(q_pos: torch.Tensor, seq_len: int) -> torch.Tensor:
    """Absolute position held by each ring row, given the newest position.

    q_pos: [...] int; returns [..., seq_len] with key_abs[..., s] the
    position whose ring row is s and that is <= q_pos."""
    s = torch.arange(seq_len, dtype=torch.int64, device=q_pos.device)
    q = q_pos[..., None].long()
    return q - torch.remainder(torch.remainder(q, seq_len) - s, seq_len)


def attention_mask(q_pos: torch.Tensor, seq_len: int, window: int,
                   prefix_end: torch.Tensor | int = 0) -> torch.Tensor:
    """Boolean [B, T, S] mask of attendable ring rows.

    q_pos: [B, T]; the ring rows are reconstructed from the newest
    position of the step (all of the step's K/V are written first)."""
    q_pos = q_pos.long()
    newest = q_pos.amax(dim=-1)
    key_abs = ring_key_positions(newest, seq_len)[:, None, :]
    start = q_pos - torch.clamp(q_pos, max=window - 1)
    last = q_pos
    if not (isinstance(prefix_end, int) and prefix_end == 0):
        pe = torch.as_tensor(prefix_end, device=q_pos.device).long()
        pe = pe[..., None] if pe.ndim == 1 else pe
        last = torch.maximum(last, pe - 1)
    ok = (key_abs >= start[..., None]) & (key_abs <= last[..., None])
    return ok & (key_abs >= 0)


def _softmax_rows(scores: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Masked exact softmax over the last axis; a fully masked row gives 0
    (the kernels' contract) instead of a uniform row."""
    scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    m = scores.amax(dim=-1, keepdim=True)
    e = torch.where(mask, torch.exp(scores - m), torch.zeros_like(scores))
    den = e.sum(dim=-1, keepdim=True)
    return e / torch.where(den > 0, den, torch.ones_like(den))


def dot_softmax_weighted_sum(q, k_cache, v_cache, mask, att_cap: float = 0.0):
    """DotSoftmaxWeightedSum (attention.cc:131-163), batched.

    q [B, T, H, D] (RoPE'd and scaled); k_cache, v_cache [B, KVH, S, D];
    mask [B, T, S] bool.  Operands are rounded to the cache dtype (bf16
    in production), products accumulate in f32.  Returns [B, T, H, D] f32."""
    b, t, heads, d = q.shape
    kvh = k_cache.shape[1]
    cdt = k_cache.dtype
    qg = q.reshape(b, t, kvh, heads // kvh, d).to(cdt).float()
    scores = torch.einsum("btkgd,bksd->btkgs", qg, k_cache.float())
    if att_cap:
        scores = soft_cap_op(att_cap, scores)
    probs = _softmax_rows(scores, mask[:, :, None, None, :])
    probs = probs.to(cdt).float()
    out = torch.einsum("btkgs,bksd->btkgd", probs, v_cache.float())
    return out.reshape(b, t, heads, d)


def dot_softmax_weighted_sum_q(q, k_codes, v_codes, scale_k, scale_v, mask,
                               att_cap: float = 0.0):
    """dot_softmax_weighted_sum over an int8 KV cache.

    k_codes, v_codes [B, KVH, S, D] i8; scale_k, scale_v [B, KVH, S] f32.
    Scores pick up scale_k per key after the raw-code dot; scale_v folds
    into the probabilities, which round to bf16 before the V dot (the
    kernels' MXU/tensor-core operand type)."""
    b, t, heads, d = q.shape
    kvh = k_codes.shape[1]
    qg = q.reshape(b, t, kvh, heads // kvh, d).to(torch.bfloat16).float()
    scores = torch.einsum("btkgd,bksd->btkgs", qg, k_codes.float())
    scores = scores * scale_k[:, None, :, None, :]
    if att_cap:
        scores = soft_cap_op(att_cap, scores)
    probs = _softmax_rows(scores, mask[:, :, None, None, :])
    probs = (probs * scale_v[:, None, :, None, :]).to(torch.bfloat16).float()
    out = torch.einsum("btkgs,bksd->btkgd", probs, v_codes.float())
    return out.reshape(b, t, heads, d)
