"""Prefill attention over the ring KV cache (counterpart of
gemma_tpu/ops/flash_attention.py:flash_prefill_attention; reference
gemma/flash_attention.{h,cc}).

On CUDA tensors it launches the kernel of csrc/flash_attention.cu (K5)
for the pool's type (i8, bf16 or f32); on CPU tensors it runs the plain
dense version (ops/attention.py) over the same mask.  Positions must be
contiguous per query (positions[b, i] == positions[b, 0] + i), which
chunked prefill guarantees.  The kernel reads q and writes the output in
the caller's [B, T, heads, D] layout; `flash_tile_plan` is the walk of
ring tiles each of its blocks makes.
"""

from __future__ import annotations

import torch

from gemma_tpu_torch.ops import _cuda
from gemma_tpu_torch.ops.attention import (attention_mask,
                                           dot_softmax_weighted_sum,
                                           dot_softmax_weighted_sum_q)

# q, pool, [scales,] base, newest, prefix_end, out; batch, n_layers, layer,
# kvh, t, groups, s_alloc, d, ring, window, q_bs, q_ts, q_hs, rows, keys;
# att_cap.
FLASH_ATTENTION_I8 = _cuda.Kernel(
    "flash_attention_i8", "flash_attention.cu", "gemma_flash_attention_i8",
    [_cuda.P] * 7 + [_cuda.I] * 15 + [_cuda.F])
# bf16 and f32 pools: the same entry without the scales pointer.
FLASH_ATTENTION_BF16 = _cuda.Kernel(
    "flash_attention_bf16", "flash_attention.cu",
    "gemma_flash_attention_bf16", [_cuda.P] * 6 + [_cuda.I] * 15 + [_cuda.F])
FLASH_ATTENTION_F32 = _cuda.Kernel(
    "flash_attention_f32", "flash_attention.cu",
    "gemma_flash_attention_f32", [_cuda.P] * 6 + [_cuda.I] * 15 + [_cuda.F])
_KERNELS = {torch.int8: FLASH_ATTENTION_I8,
            torch.bfloat16: FLASH_ATTENTION_BF16,
            torch.float32: FLASH_ATTENTION_F32}

# The kernel's tiles: query rows (t-major, row = t * G + g) a block by pool
# type, ring rows a key tile.  The entries refuse any other.
FLASH_ROWS = {torch.int8: 128, torch.bfloat16: 64, torch.float32: 64}
FLASH_KEYS = 32


def flash_tile_plan(base: int, newest: int, prefix_end: int, tg: int,
                    groups: int, ring: int, window: int, rows: int,
                    keys: int = FLASH_KEYS) -> list[list[int]]:
    """The ring tiles (`keys` ring rows each, tile j = rows j*keys ..) that
    each row tile (`rows` query rows) of one batch slot visits, in the
    order the kernel visits them: oldest position first.

    A row tile's attendable positions form one range, [max(qlo -
    min(window-1, qlo), newest - ring + 1, 0), min(max(qhi, pe-1),
    newest)], and every position in it is attendable by some row of the
    tile; in ring rows it is one run or, where it wraps, two, and the plan
    is the tiles those runs touch, each once.  Every other tile is
    skipped."""
    plan = []
    nt = -(-ring // keys)
    for r0 in range(0, tg, rows):
        rlast = min(r0 + rows, tg) - 1
        qlo, qhi = base + r0 // groups, base + rlast // groups
        a_lo = max(qlo - min(window - 1, qlo), newest - ring + 1, 0)
        a_hi = min(max(qhi, prefix_end - 1), newest)
        if a_lo > a_hi:
            plan.append([])
            continue
        t_lo, t_hi = (a_lo % ring) // keys, (a_hi % ring) // keys
        if a_lo % ring <= a_hi % ring:
            plan.append(list(range(t_lo, t_hi + 1)))
        else:
            plan.append(list(range(t_lo, nt))
                        + list(range(min(t_hi + 1, t_lo))))
    return plan


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


def _q_operand(q: torch.Tensor) -> torch.Tensor:
    """q as the kernel reads it: f32, unit d stride, the other strides and
    the start on 16 bytes; a copy only where q is not so already."""
    q = q.float()
    if (q.stride(3) != 1 or any(s % 4 for s in q.stride()[:3])
            or q.data_ptr() % 16):
        q = q.contiguous()
    return q


def flash_prefill_attention(cache, layer_idx, q, positions, window,
                            att_cap=0.0, prefix_end=0):
    """Prefill attention (flash_attention.py:205-259).  Returns f32
    [B, T, heads, D]."""
    if not q.is_cuda:
        return flash_prefill_attention_plain(cache, layer_idx, q, positions,
                                             window, att_cap, prefix_end)
    return _flash_cuda(cache, layer_idx, q, positions, window, att_cap,
                       prefix_end)


def _flash_cuda(cache, layer_idx, q, positions, window, att_cap, prefix_end):
    """K5's launch: q read through its strides, the output allocated in
    the caller's layout, the tile geometry of the pool's type."""
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
    q = _q_operand(q)
    base = positions[:, 0].to(torch.int32).contiguous()
    newest = positions.amax(dim=-1).to(torch.int32).contiguous()
    pe = _prefix(prefix_end, b, q.device).contiguous()
    out = torch.empty(b, t, heads, d, dtype=torch.float32, device=q.device)
    scales = () if sc is None else (sc.data_ptr(),)
    kernel.launch(
        q.data_ptr(), pool.data_ptr(), *scales, base.data_ptr(),
        newest.data_ptr(), pe.data_ptr(), out.data_ptr(), b, n_layers, idx,
        kvh, t, groups, s_alloc, d, ring, int(window), q.stride(0),
        q.stride(1), q.stride(2), FLASH_ROWS[pool.dtype], FLASH_KEYS,
        float(att_cap))
    return out
