"""Decode attention over the KV ring (counterpart of
gemma_tpu/ops/decode_attention.py): five entry points, each a kernel of
csrc/decode_attention.cu on CUDA tensors and its plain version below on
CPU tensors.

  - `decode_attention_write_packed` (K4): the fused qkv GEMM's f32 row
    per batch slot (q heads kv-major, then per-KV-head interleaved K, V);
    QK norms, RoPE, the new K/V row written into the ring in place in the
    pool's type (i8 codes with their scales, bf16 or f32; the garbage row
    for invalid slots), attention over the ring; returns the att_w GEMM's
    bf16 A-row [B, heads*D].
  - `decode_attention_write` (K8): the same from the split q / kv GEMMs,
    q [B, 1, heads, D] and new K, V [B, 1, KVH, D]; with a RopeSpec the
    norms, RoPE and the i8 quantization run in the kernel, without one q
    and the rows come pre-encoded.  The new row's score and value come
    from the kernel's registers, not the pool.  Returns f32
    [B, 1, heads, D].  With GEMMA_SBLOCK_DECODE=1, and a block from
    `pick_s_block`, it runs K11 instead: the same split over runs of the
    live positions (`sblock_split`), one block a run, their softmax
    partials merged by the last block to finish.
  - `kv_write_decode` (K9): the row write alone, from the raw f32 or
    bf16 rows through their strides; the kernel encodes them (i8 codes
    and scales, bf16 rounding) where the JAX package quantizes outside
    its kernel.
  - `decode_attention` (K10): single-token attention, no write.

GEMMA_FUSED_DECODE=0 sends `decode_attention_write` to the composed pair
(RoPE and the QK norms in torch ops, then K9 and K10), and
GEMMA_FUSED_DECODE=0, GEMMA_PACKED_DECODE=0 or GEMMA_SBLOCK_DECODE=1 send
the packed call to the split one.  They are the JAX package's own
switches, read where it reads them, with its defaults.  Its TPU-only exits
do not carry over: no VMEM panel budget (no move to flash attention), no
d % 128 rule, no compile probes; the kernels serve every ring length.
The pool and its scales are updated in place.
"""

from __future__ import annotations

import functools
import os

import torch

from gemma_tpu_torch.ops import _cuda
from gemma_tpu_torch.ops import ops
from gemma_tpu_torch.ops.attention import (NEG_INF, attention_mask,
                                           dot_softmax_weighted_sum,
                                           dot_softmax_weighted_sum_q)
from gemma_tpu_torch.ops.kv_quant import quantize_rows

_P, _I, _F = _cuda.P, _cuda.I, _cuda.F
_KINDS = {torch.int8: "i8", torch.bfloat16: "bf16", torch.float32: "f32"}

DECODE_ATTENTION_I8 = _cuda.Kernel(
    "decode_attention_i8", "decode_attention.cu", "gemma_decode_attention_i8",
    [_P] * 9 + [_I] * 10 + [_F, _F])
# bf16 and f32 pools: the same entry without the scales pointer.
DECODE_ATTENTION_BF16 = _cuda.Kernel(
    "decode_attention_bf16", "decode_attention.cu",
    "gemma_decode_attention_bf16",
    [_P] * 8 + [_I] * 10 + [_F, _F])
DECODE_ATTENTION_F32 = _cuda.Kernel(
    "decode_attention_f32", "decode_attention.cu",
    "gemma_decode_attention_f32",
    [_P] * 8 + [_I] * 10 + [_F, _F])
_KERNELS = {torch.int8: DECODE_ATTENTION_I8,
            torch.bfloat16: DECODE_ATTENTION_BF16,
            torch.float32: DECODE_ATTENTION_F32}


def _per_kind(name: str, argtypes: list) -> dict:
    """One Kernel per pool type; every kind's C entry has the same
    parameters (the scale pointers are null for bf16 and f32 pools)."""
    return {dt: _cuda.Kernel(f"{name}_{kind}", "decode_attention.cu",
                             f"gemma_{name}_{kind}", argtypes)
            for dt, kind in _KINDS.items()}


# K8: q, knew, vnew, new_bs, new_hs, nsc, inv_ts, knorm, qnorm, pool,
# scales, pos, valid, out; batch, n_layers, layer, kvh, heads, s_alloc, d,
# ring, window, q_bs, pe_mode; qscale, att_cap.
_WRITE_ARGS = ([_P, _P, _P, _I, _I] + [_P] * 9 + [_I] * 11 + [_F, _F])
DECODE_WRITE_ATTEND = _per_kind("decode_write_attend", _WRITE_ARGS)
# K11: K8's parameters, then the partials, their capacity in floats and
# the tickets.
DECODE_SBLOCKED = _per_kind("decode_sblocked", _WRITE_ARGS + [_P, _I, _P])
# K9: k, v; k_bs, k_hs, v_bs, v_hs, in_bf16; pool, scales, pos, valid;
# batch, n_layers, layer, kvh, s_alloc, d, ring.
KV_WRITE = _per_kind("kv_write", [_P] * 2 + [_I] * 5 + [_P] * 4 + [_I] * 7)
# K9 reads 8 elements of a row at a time, 16 bytes for f32 rows, and up to
# 512 elements a row.
KV_WRITE_MAX_D = 512
# K10: q, pool, scales, pos, out; batch, n_layers, layer, kvh, heads,
# s_alloc, d, ring, window, q_bs; att_cap.
DECODE_ATTEND = _per_kind("decode_attend", [_P] * 5 + [_I] * 10 + [_F])

# The most live rows one block of K4 / K8 / K10 keeps scores for: rings up
# to 2048 times the cluster (the entries refuse longer ones).
DECODE_MAX_ROWS = 2048


def decode_cluster(kv_heads: int) -> int:
    """Blocks of the thread-block cluster per (batch, KV head): 8 up to 4
    KV heads (Gemma2-2B), else 4 (9B's 8, 27B's 16), so batch 4 runs in
    one wave.  From the head count alone, never the batch, so a slot's
    sums are taken in one order at every batch size."""
    return 8 if kv_heads <= 4 else 4


def decode_row_split(pos: int, ring: int, window: int,
                     cluster: int) -> list[range]:
    """The live positions each block of a K4 / K8 / K10 cluster takes:
    max(pos - window + 1, pos - ring + 1, 0) .. pos cut into `cluster`
    contiguous runs, rank r from p_lo + r*n // cluster (n live positions).
    The kernel computes the same split; the newest position, whose ring
    row the step writes, falls to the last rank with rows."""
    p_lo = max(pos - window + 1, pos - ring + 1, 0)
    n = pos - p_lo + 1
    return [range(p_lo + r * n // cluster, p_lo + (r + 1) * n // cluster)
            for r in range(cluster)]


# K11's split (csrc/decode_attention.cu: sb_split): runs of the live
# positions, a multiple of DECODE_CHUNK rows and at least SBLOCK_MIN_RUN,
# as short as lets batch 1 fill SBLOCK_TARGET blocks (two 256-thread
# blocks on each of an H100's 132 SMs) over the longest live span
# min(ring, window).  The kernel refuses runs past SBLOCK_MAX_RUN rows and
# more than SBLOCK_MAX_RUNS runs.
DECODE_CHUNK = 32
SBLOCK_TARGET = 264
SBLOCK_MIN_RUN = 128
SBLOCK_MAX_RUN = 2048
SBLOCK_MAX_RUNS = 512


def sblock_split(ring: int, window: int, kv_heads: int) -> tuple[int, int]:
    """(runs, run): K11's blocks per (batch, KV head) and the live
    positions each takes, from the shapes alone, never the batch or the
    positions, so that a slot's sums are taken in one order at every batch
    size and the launch is the same at every step."""
    live = min(ring, window)
    span = -(-live // -(-SBLOCK_TARGET // kv_heads))
    run = max(SBLOCK_MIN_RUN, -(-span // DECODE_CHUNK) * DECODE_CHUNK)
    return -(-live // run), run


def sblock_row_split(pos: int, ring: int, window: int,
                     kv_heads: int) -> list[range]:
    """The live positions each block of K11 takes: run j is p_lo + j*run
    up to p_lo + (j + 1)*run, clipped to pos (p_lo = max(pos - window + 1,
    pos - ring + 1, 0)); runs past the frontier are empty and their blocks
    return at once.  The kernel computes the same split from the device
    positions."""
    runs, run = sblock_split(ring, window, kv_heads)
    p_lo = max(pos - window + 1, pos - ring + 1, 0)
    return [range(min(p_lo + j * run, pos + 1),
                  min(p_lo + (j + 1) * run, pos + 1)) for j in range(runs)]


# K11's per-(batch, KV head) arrival counters, zero between launches (the
# last block of each pair re-zeroes its own).
_sblocked_tickets: dict[torch.device, torch.Tensor] = {}


def _sblocked_scratch(b, kv_heads, heads, d, ring, window, device):
    """K11's partials, per (slot, KV head, run, query head) m, s, er, a
    pad and the D partial sums (the same runs for every slot at every
    batch), and the device's tickets, at least one per (slot, KV head)."""
    runs, _ = sblock_split(ring, window, kv_heads)
    part = torch.empty(b * kv_heads * runs * (heads // kv_heads) * (d + 4),
                       dtype=torch.float32, device=device)
    ticket = _sblocked_tickets.get(device)
    if ticket is None or ticket.numel() < b * kv_heads:
        ticket = _sblocked_tickets[device] = torch.zeros(
            b * kv_heads, dtype=torch.int32, device=device)
    return part, ticket


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

    def apply_host(self, q, k, positions):
        """The QK norms and RoPE as torch ops (the composed path's
        encoding): (q, k) for q [B, 1, heads, D], k [B, 1, KVH, D]."""
        if self.key_norm is not None:
            k = ops.rms_norm(k, self.key_norm)
        if self.query_norm is not None:
            q = ops.rms_norm(q, self.query_norm)
        pos = positions[..., None]  # broadcast over heads
        return self.encode(q, pos, self.query_scale), self.encode(k, pos, 1.0)


def _sublane(dtype: torch.dtype) -> int:
    """The TPU's native sublane tile height for a pool dtype, which sizes
    `pick_s_block`'s candidates (decode_attention.py:51)."""
    return {2: 16, 1: 32, 4: 8}[dtype.itemsize]


@functools.lru_cache(maxsize=None)
def pick_s_block(s_alloc: int, sublane: int, row_bytes: int,
                 min_dma: int = 64 << 10,
                 lane_multiple: int | None = None) -> int | None:
    """The S block of K11: a divisor of s_alloc, a multiple of `sublane`
    (of `lane_multiple` for quantized pools), leaving at least 2 blocks;
    the smallest whose K panel reaches `min_dma` bytes (row_bytes =
    kv_heads * qkv_dim * itemsize), else the largest; None when there is
    no such divisor.  The JAX package's rule (decode_attention.py:713-736),
    kept so that both packages pick K11 or the one-shot K8 for the same
    pool.  Cached: the JAX package computes it once per trace, the port
    on every decode layer."""
    step = lane_multiple or sublane
    cands = [bs for bs in range(step, s_alloc, step)
             if s_alloc % bs == 0 and s_alloc // bs >= 2]
    if not cands:
        return None
    good = [bs for bs in cands if bs * row_bytes >= min_dma]
    return min(good) if good else max(cands)


def _s_block(cache, layer_idx: int) -> int | None:
    pool = cache.pool(layer_idx)[0]
    row_bytes = pool.shape[3] * pool.shape[5] * pool.dtype.itemsize
    return pick_s_block(pool.shape[4], _sublane(pool.dtype), row_bytes,
                        lane_multiple=128 if cache.quantized else None)


def _fused() -> bool:
    return os.environ.get("GEMMA_FUSED_DECODE", "1") != "0"


def _sblocked() -> bool:
    return os.environ.get("GEMMA_SBLOCK_DECODE", "0") == "1"


# --- plain versions ---------------------------------------------------------


def _ring_rows(positions, ring: int, valid) -> torch.Tensor:
    """[B] ring row of each slot's new token; invalid slots get the
    garbage row `ring`."""
    rows = torch.remainder(positions[:, 0].long(), ring)
    if valid is not None:
        rows = torch.where(valid[:, 0], rows, torch.full_like(rows, ring))
    return rows


def _pool_rows(cache, new: torch.Tensor):
    """[B, 2, KVH, D] rows -> (the rows in the pool's type, or i8 codes
    with their f32 scales [B, 2, KVH]; None for unquantized pools)."""
    if cache.quantized:
        return quantize_rows(new)
    return new.to(cache.kv.dtype), None


def _write_rows_plain(cache, layer_idx, new, scale, rows) -> None:
    """Write new [B, 2, KVH, D] (pool-typed) and scale [B, 2, KVH] at ring
    row rows[b] of each batch slot, in place."""
    pool, idx, _ = cache.pool(layer_idx)
    sc = cache.pool_scale(layer_idx)
    bi = torch.arange(new.shape[0], device=pool.device)
    for kv in range(2):
        pool[:, idx, kv].permute(0, 2, 1, 3)[bi, rows] = \
            new[:, kv].to(pool.dtype)
        if sc is not None:
            sc[:, idx, kv, :, 0].permute(0, 2, 1)[bi, rows] = scale[:, kv]


def _decode_mask(positions, ring: int, window: int, s_alloc: int):
    """[B, 1, s_alloc] attendable rows of a decode step: the ring's
    window, none of the garbage or padding rows."""
    mask = attention_mask(positions, ring, window, 0)
    return torch.cat([mask, torch.zeros(mask.shape[0], 1, s_alloc - ring,
                                        dtype=torch.bool,
                                        device=mask.device)], dim=-1)


def decode_attention_plain(cache, layer_idx, q, positions, window,
                           att_cap=0.0):
    """K10's function in plain PyTorch: f32 [B, 1, heads, D]."""
    pool, idx, ring = cache.pool(layer_idx)
    sc = cache.pool_scale(layer_idx)
    mask = _decode_mask(positions, ring, window, pool.shape[4])
    if sc is None:
        return dot_softmax_weighted_sum(q.float(), pool[:, idx, 0],
                                        pool[:, idx, 1], mask,
                                        att_cap=att_cap)
    return dot_softmax_weighted_sum_q(
        q.float(), pool[:, idx, 0], pool[:, idx, 1], sc[:, idx, 0, :, 0],
        sc[:, idx, 1, :, 0], mask, att_cap=att_cap)


def decode_attention_write_packed_plain(cache, layer_idx, qkv_all, positions,
                                        window, heads, att_cap=0.0,
                                        valid=None, rope: RopeSpec = None):
    """K4's function in plain PyTorch (writes the cache in place): K8's
    on the row's q, k and v, as bf16 [B, heads*D]."""
    pool = cache.pool(layer_idx)[0]
    b = qkv_all.shape[0]
    kvh, d = pool.shape[3], pool.shape[5]
    q = qkv_all[:, :heads * d].reshape(b, 1, heads, d)
    kvp = qkv_all[:, heads * d:].reshape(b, 1, kvh, 2, d)
    out = decode_attention_write_plain(
        cache, layer_idx, q, positions, kvp[..., 0, :], kvp[..., 1, :],
        window, att_cap, valid, rope)
    return out.reshape(b, heads * d).to(torch.bfloat16)


def kv_write_decode_plain(cache, layer_idx, positions, k, v, valid=None):
    """K9's function in plain PyTorch: the rows in the pool's type (i8:
    quantized, with their scales) at each slot's ring row, in place."""
    new, scale = _pool_rows(cache, torch.stack([k[:, 0], v[:, 0]], dim=1))
    _write_rows_plain(cache, layer_idx, new, scale,
                      _ring_rows(positions, cache.pool(layer_idx)[2], valid))


def decode_attention_write_plain(cache, layer_idx, q, positions, k, v,
                                 window, att_cap=0.0, valid=None,
                                 rope: RopeSpec | None = None):
    """K8's function in plain PyTorch: encode, write, attend.  The kernel
    substitutes the new row's score and value in-compute instead of
    reading the pool back; the numbers differ only by the order of f32
    sums (the JAX suite holds the two to 2e-5)."""
    if rope is not None:
        q, k = rope.apply_host(q.float(), k.float(), positions)
    kv_write_decode_plain(cache, layer_idx, positions, k, v, valid)
    return decode_attention_plain(cache, layer_idx, q, positions, window,
                                 att_cap)


def decode_attention_write_sblocked_plain(cache, layer_idx, q, positions, k,
                                          v, window, s_block: int,
                                          att_cap=0.0, valid=None,
                                          rope: RopeSpec | None = None):
    """K11's function in plain PyTorch (decode_attention.py:739-928):
    the row written as K8 writes it, then an online softmax over S blocks
    of `s_block` rows up to the live frontier min(pos, ring - 1) //
    s_block.  Per block, from the running max m: alpha = 0 while m is
    -inf, exp weights of the ok rows, the new row's share `er` kept apart
    from the panel rows (its score an f32 multiply-and-sum of q and the
    new K), scale_v on the panel rows only, the panel weights rounded to
    the compute type before the V product; one normalization at the end
    by max(s, 1e-30), plus the new row's V times its rounded share."""
    if rope is not None:
        q, k = rope.apply_host(q.float(), k.float(), positions)
    pool, idx, ring = cache.pool(layer_idx)
    sc = cache.pool_scale(layer_idx)
    new, scale = _pool_rows(cache, torch.stack([k[:, 0], v[:, 0]], dim=1))
    rows = _ring_rows(positions, ring, valid)
    _write_rows_plain(cache, layer_idx, new, scale, rows)

    b, _, heads, d = q.shape
    kvh = pool.shape[3]
    g = heads // kvh
    cdt = torch.float32 if pool.dtype == torch.float32 else torch.bfloat16
    qh = q.reshape(b, kvh, g, d).float().to(cdt).float()
    nk = new[:, 0].to(cdt).float()  # [B, KVH, D]
    nv = new[:, 1].to(cdt).float()
    new_score = (qh * nk[:, :, None, :]).sum(-1)  # [B, KVH, G]
    pos = positions[:, 0].long()
    start = torch.clamp(pos - (window - 1), min=0)
    hi = torch.clamp(pos, max=ring - 1) // s_block
    dev = q.device
    m = torch.full((b, kvh, g), -torch.inf, device=dev)
    s = torch.zeros(b, kvh, g, device=dev)
    er = torch.zeros(b, kvh, g, device=dev)
    acc = torch.zeros(b, kvh, g, d, device=dev)
    # Every block in turn, those past a slot's frontier masked out (no
    # host sync: the plain version is graph-captured on the card too).
    for j in range(pool.shape[4] // s_block):
        blk = slice(j * s_block, (j + 1) * s_block)
        live = (j <= hi)[:, None, None]
        sa = torch.arange(j * s_block, (j + 1) * s_block, device=dev)
        key_abs = pos[:, None] - torch.remainder(
            torch.remainder(pos, ring)[:, None] - sa, ring)
        ok = ((key_abs >= start[:, None]) & (key_abs <= pos[:, None])
              & (sa < ring))[:, None, None, :]  # [B, 1, 1, bs]
        at = (sa[None] == rows[:, None])[:, None, None, :]
        scores = torch.einsum("bkgd,bksd->bkgs", qh,
                              pool[:, idx, 0, :, blk].to(cdt).float())
        scores = torch.where(at, new_score[..., None], scores)
        if sc is not None:
            sck = torch.where(at[:, :, 0], scale[:, 0, :, None],
                              sc[:, idx, 0, :, 0, blk])  # [B, KVH, bs]
            scores = scores * sck[:, :, None, :]
        if att_cap:
            scores = ops.soft_cap(att_cap, scores)
        scores = torch.where(ok, scores, torch.full_like(scores, NEG_INF))
        m_new = torch.maximum(m, scores.amax(-1))
        safe_m = torch.where(torch.isinf(m_new), torch.zeros_like(m_new),
                             m_new)
        alpha = torch.where(torch.isinf(m), torch.zeros_like(m),
                            torch.exp(m - safe_m))
        e = torch.where(ok, torch.exp(scores - safe_m[..., None]),
                        torch.zeros_like(scores))
        er_j = torch.where(at, e, torch.zeros_like(e)).sum(-1)
        e_z = torch.where(at, torch.zeros_like(e), e)
        if sc is not None:
            e_z = e_z * sc[:, idx, 1, :, 0, blk][:, :, None, :]
        part = torch.einsum("bkgs,bksd->bkgd", e_z.to(cdt).float(),
                            pool[:, idx, 1, :, blk].to(cdt).float())
        s = torch.where(live, alpha * s + e.sum(-1), s)
        er = torch.where(live, alpha * er + er_j, er)
        acc = torch.where(live[..., None], alpha[..., None] * acc + part, acc)
        m = torch.where(live, m_new, m)
    s_tot = torch.clamp(s, min=1e-30)
    p_row = er / s_tot
    if sc is not None:
        p_row = p_row * scale[:, 1, :, None]
    out = acc / s_tot[..., None] + p_row.to(cdt).float()[..., None] \
        * nv[:, :, None, :]
    return out.reshape(b, 1, heads, d)


def decode_attention_write_sblocked_emulated(cache, layer_idx, q, positions,
                                             k, v, window, att_cap=0.0,
                                             valid=None,
                                             rope: RopeSpec | None = None):
    """K11 in its own split, in plain PyTorch (the CPU tests hold it against
    the JAX kernel and the plain version; no serving path calls it): the
    row written as K8 writes it; per run of `sblock_row_split`, the run's
    max m of its scores, s = sum exp(score - m) over its rows, the new
    row's exp weight er apart, and acc = the other rows' exp weights (times
    scale_v) rounded to the compute type, times V; then the merge, with
    run weights w_j = exp(m_j - M): O / max(S, 1e-30) + cdt(ER / max(S,
    1e-30) * scale_v) * V_new, S, ER and O the w_j-weighted sums.  Its f32
    sums are not taken in the kernel's order."""
    if rope is not None:
        q, k = rope.apply_host(q.float(), k.float(), positions)
    pool, idx, ring = cache.pool(layer_idx)
    sc = cache.pool_scale(layer_idx)
    new, scale = _pool_rows(cache, torch.stack([k[:, 0], v[:, 0]], dim=1))
    rows = _ring_rows(positions, ring, valid)
    _write_rows_plain(cache, layer_idx, new, scale, rows)

    b, _, heads, d = q.shape
    kvh = pool.shape[3]
    cdt = torch.float32 if pool.dtype == torch.float32 else torch.bfloat16
    qh = q.reshape(b, kvh, heads // kvh, d).float().to(cdt).float()
    nv = new[:, 1].to(cdt).float()  # [B, KVH, D]
    out = torch.empty(b, kvh, heads // kvh, d, device=q.device)
    for bi in range(b):
        pos = int(positions[bi, 0])
        parts = []
        for run in sblock_row_split(pos, ring, int(window), kvh):
            if not len(run):
                break
            srow = torch.tensor([p % ring for p in run], device=q.device)
            kk = pool[bi, idx, 0][:, srow].to(cdt).float()  # [KVH, R, D]
            vv = pool[bi, idx, 1][:, srow].to(cdt).float()
            scores = torch.einsum("kgd,krd->kgr", qh[bi], kk)
            if sc is not None:
                scores = scores * sc[bi, idx, 0, :, 0][:, srow][:, None, :]
            if att_cap:
                scores = ops.soft_cap(att_cap, scores)
            m = scores.amax(-1)
            e = torch.exp(scores - m[..., None])
            at = srow == int(rows[bi])  # the new row, when the slot is valid
            er = torch.where(at, e, torch.zeros_like(e)).sum(-1)
            w = torch.where(at, torch.zeros_like(e), e)
            if sc is not None:
                w = w * sc[bi, idx, 1, :, 0][:, srow][:, None, :]
            acc = torch.einsum("kgr,krd->kgd", w.to(cdt).float(), vv)
            parts.append((m, e.sum(-1), er, acc))
        mx = torch.stack([pt[0] for pt in parts]).amax(0)
        wj = [torch.exp(pt[0] - mx) for pt in parts]
        s_tot = sum(pt[1] * w for pt, w in zip(parts, wj)).clamp(min=1e-30)
        er_tot = sum(pt[2] * w for pt, w in zip(parts, wj))
        o = sum(pt[3] * w[..., None] for pt, w in zip(parts, wj))
        p_row = er_tot / s_tot
        if sc is not None:
            p_row = p_row * scale[bi, 1][:, None]
        out[bi] = o / s_tot[..., None] \
            + p_row.to(cdt).float()[..., None] * nv[bi][:, None, :]
    return out.reshape(b, 1, heads, d)


# --- the kernels' wrappers --------------------------------------------------


def _pos_valid(positions, valid, b):
    """positions [B, 1] -> contiguous int32; valid [B, 1] -> bool or None."""
    pos = positions if positions.dtype == torch.int32 \
        else positions.to(torch.int32)
    pos = pos.contiguous()
    _cuda.check(pos, "positions", torch.int32, (b, 1))
    if valid is not None:
        valid = valid.to(torch.bool).contiguous()
        _cuda.check(valid, "valid", torch.bool, (b, 1))
    return pos, valid


def _q_operand(q, b, heads, d):
    """q [B, 1, heads, D] f32 -> (q, its batch stride): any batch stride,
    each slot's heads*D values contiguous (a column slice of the qkv row
    is taken as it is)."""
    if q.dtype != torch.float32:
        q = q.float()
    if tuple(q.shape) != (b, 1, heads, d):
        raise ValueError(f"q must have shape {(b, 1, heads, d)}, "
                         f"got {tuple(q.shape)}")
    if q.stride(3) != 1 or q.stride(2) != d:
        q = q.contiguous()
    if not q.is_cuda:
        raise ValueError("q must be a CUDA tensor")
    return q, q.stride(0)


def _pool_operands(cache, layer_idx, kernels):
    pool, idx, ring = cache.pool(layer_idx)
    sc = cache.pool_scale(layer_idx)
    kernel = kernels.get(pool.dtype)
    if kernel is None:
        raise ValueError(f"no decode kernel for a {pool.dtype} pool")
    _cuda.check(pool, "pool", pool.dtype)
    b, n_layers, _, kvh, s_alloc, d = pool.shape
    if pool.dtype == torch.int8:
        _cuda.check(sc, "pool_scale", torch.float32,
                    (b, n_layers, 2, kvh, 1, s_alloc))
    return kernel, pool, sc, idx, ring


def _rope_operands(rope, d):
    if rope is None:
        return None, None, None, -1, 1.0
    its = rope.inv_timescale
    _cuda.check(its, "inv_timescale", torch.float32,
                (d // 4 if rope.post_qk == 1 else d // 2,))
    for name, w in (("key_norm", rope.key_norm),
                    ("query_norm", rope.query_norm)):
        if w is not None:
            _cuda.check(w, name, torch.float32, (d,))
    return its, rope.key_norm, rope.query_norm, rope.post_qk, \
        rope.query_scale


def decode_attention_write_packed(cache, layer_idx, qkv_all, positions,
                                  window, heads, att_cap=0.0, valid=None,
                                  rope: RopeSpec = None):
    """Write the new K/V row and attend (decode_attention.py:1427-1528).

    qkv_all [B, (heads + 2*kv_heads)*D] f32; positions [B, 1] int;
    valid [B, 1] bool or None.  Returns bf16 [B, heads*D]; the cache's
    pool and scales are updated in place.  Under GEMMA_FUSED_DECODE=0,
    GEMMA_PACKED_DECODE=0 or GEMMA_SBLOCK_DECODE=1 the row is sliced into
    q, k, v and goes to `decode_attention_write` (:1452-1474)."""
    if rope is None:
        raise ValueError("packed decode requires a RopeSpec")
    if (not _fused() or _sblocked()
            or os.environ.get("GEMMA_PACKED_DECODE", "1") == "0"):
        pool = cache.pool(layer_idx)[0]
        kvh, d = pool.shape[3], pool.shape[5]
        b = qkv_all.shape[0]
        q = qkv_all[:, :heads * d].reshape(b, 1, heads, d)
        kvp = qkv_all[:, heads * d:].reshape(b, 1, kvh, 2, d)
        out = decode_attention_write(
            cache, layer_idx, q, positions, kvp[..., 0, :], kvp[..., 1, :],
            window, att_cap=att_cap, valid=valid, rope=rope)
        return out.reshape(b, heads * d).to(torch.bfloat16)
    if not qkv_all.is_cuda:
        return decode_attention_write_packed_plain(
            cache, layer_idx, qkv_all, positions, window, heads, att_cap,
            valid, rope)
    kernel, pool, sc, idx, ring = _pool_operands(cache, layer_idx, _KERNELS)
    b, n_layers, _, kvh, s_alloc, d = pool.shape
    _cuda.check(qkv_all, "qkv_all", torch.float32, (b, (heads + 2 * kvh) * d))
    its, kn, qn, pe_mode, qscale = _rope_operands(rope, d)
    # The kernel derives the ring row (pos % ring, or the garbage row) from
    # the positions and the valid mask itself: no per-layer index ops.
    pos, valid = _pos_valid(positions, valid, b)
    out = torch.empty(b, heads * d, dtype=torch.bfloat16, device=pool.device)
    scales = () if sc is None else (sc.data_ptr(),)
    kernel.launch(
        qkv_all.data_ptr(), its.data_ptr(), _cuda.ptr(kn), _cuda.ptr(qn),
        pool.data_ptr(), *scales, pos.data_ptr(), _cuda.ptr(valid),
        out.data_ptr(), b, n_layers, idx, kvh, heads, s_alloc, d, ring,
        int(window), pe_mode, qscale, float(att_cap))
    return out


def _raw_rows(k, v, b, kvh, d):
    """k, v [B, 1, KVH, D] as K9 reads them: f32 or bf16 (both of one
    type, else both f32), each through its own batch and head strides;
    a row whose units of 8 elements are not 16-byte aligned is copied
    contiguous.  Returns (k, v, in_bf16)."""
    if k.dtype != v.dtype or k.dtype not in (torch.float32, torch.bfloat16):
        k, v = k.float(), v.float()
    if d % 8 or d > KV_WRITE_MAX_D:
        raise ValueError(f"K9 takes rows of a multiple of 8 up to "
                         f"{KV_WRITE_MAX_D} elements, got D={d}")
    out = []
    for name, t in (("k", k), ("v", v)):
        if not t.is_cuda or tuple(t.shape) != (b, 1, kvh, d):
            raise ValueError(f"{name} must be a CUDA [{b}, 1, {kvh}, {d}] "
                             f"tensor, got {tuple(t.shape)} on {t.device}")
        if (t.stride(3) != 1 or t.data_ptr() % 16
                or (t.stride(0) * t.element_size()) % 16
                or (t.stride(2) * t.element_size()) % 16):
            t = t.contiguous()
        out.append(t)
    return out[0], out[1], int(k.dtype == torch.bfloat16)


def kv_write_decode(cache, layer_idx, positions, k, v, valid=None):
    """Write one ring row per batch slot, in place (decode_attention.py:
    176-204).  positions [B, 1]; k, v [B, 1, KVH, D] f32 or bf16, any
    batch and head strides: K9 reads them raw and writes them in the
    pool's type (i8: codes and scales as `quantize_rows` makes them) in
    one launch.  Invalid slots write the garbage row."""
    if not k.is_cuda:
        return kv_write_decode_plain(cache, layer_idx, positions, k, v, valid)
    kernel, pool, sc, idx, ring = _pool_operands(cache, layer_idx, KV_WRITE)
    b, n_layers, _, kvh, s_alloc, d = pool.shape
    k, v, in_bf16 = _raw_rows(k, v, b, kvh, d)
    pos, valid = _pos_valid(positions, valid, b)
    kernel.launch(k.data_ptr(), v.data_ptr(), k.stride(0), k.stride(2),
                  v.stride(0), v.stride(2), in_bf16, pool.data_ptr(),
                  _cuda.ptr(sc), pos.data_ptr(), _cuda.ptr(valid), b,
                  n_layers, idx, kvh, s_alloc, d, ring)


def decode_attention(cache, layer_idx, q, positions, window,
                     att_cap=0.0) -> torch.Tensor:
    """Single-token attention over the ring (decode_attention.py:
    1713-1769), K10.  q [B, 1, heads, D] (RoPE'd and scaled); positions
    [B, 1].  Returns f32 [B, 1, heads, D]."""
    if not q.is_cuda:
        return decode_attention_plain(cache, layer_idx, q, positions, window,
                                      att_cap)
    kernel, pool, sc, idx, ring = _pool_operands(cache, layer_idx,
                                                 DECODE_ATTEND)
    b, n_layers, _, kvh, s_alloc, d = pool.shape
    heads = q.shape[2]
    q, q_bs = _q_operand(q, b, heads, d)
    pos, _ = _pos_valid(positions, None, b)
    out = torch.empty(b, 1, heads, d, dtype=torch.float32, device=q.device)
    kernel.launch(q.data_ptr(), pool.data_ptr(), _cuda.ptr(sc),
                  pos.data_ptr(), out.data_ptr(), b, n_layers, idx, kvh,
                  heads, s_alloc, d, ring, int(window), q_bs,
                  float(att_cap))
    return out


def decode_attention_write(cache, layer_idx, q, positions, k, v, window,
                           att_cap=0.0, valid=None,
                           rope: RopeSpec | None = None) -> torch.Tensor:
    """KV row write + single-token attention (decode_attention.py:
    1595-1704).  q [B, 1, heads, D]; k, v [B, 1, KVH, D]; positions
    [B, 1].  With `rope`, q and k arrive raw and the QK norms, RoPE and
    the i8 row quantization run in the kernel; without it they come
    pre-encoded.  Returns f32 [B, 1, heads, D] (heads kv-major); the
    pool is updated in place.

    GEMMA_FUSED_DECODE=0: RoPE in torch ops, then K9 and K10.
    GEMMA_SBLOCK_DECODE=1 with a block from `pick_s_block`: K11 (on the
    CPU, its plain version over those S blocks).  Else the one-shot K8."""
    if not _fused():
        if rope is not None:
            q, k = rope.apply_host(q, k, positions)
        kv_write_decode(cache, layer_idx, positions, k, v, valid=valid)
        return decode_attention(cache, layer_idx, q, positions, window,
                                att_cap=att_cap)
    s_block = _s_block(cache, layer_idx) if _sblocked() else None
    if not q.is_cuda:
        if s_block is None:
            return decode_attention_write_plain(
                cache, layer_idx, q, positions, k, v, window, att_cap, valid,
                rope)
        return decode_attention_write_sblocked_plain(
            cache, layer_idx, q, positions, k, v, window, s_block, att_cap,
            valid, rope)

    kernels = DECODE_WRITE_ATTEND if s_block is None else DECODE_SBLOCKED
    kernel, pool, sc, idx, ring = _pool_operands(cache, layer_idx, kernels)
    b, n_layers, _, kvh, s_alloc, d = pool.shape
    heads = q.shape[2]
    q, q_bs = _q_operand(q, b, heads, d)
    its, kn, qn, pe_mode, qscale = _rope_operands(rope, d)
    if rope is not None:
        # Raw f32 rows as the kv GEMM left them: k and v may be views that
        # interleave per KV head, read through their strides.
        k, v = k.float(), v.float()
        if k.stride() != v.stride():
            k, v = k.contiguous(), v.contiguous()
        for name, t in (("k", k), ("v", v)):
            if not t.is_cuda or tuple(t.shape) != (b, 1, kvh, d) \
                    or t.stride(3) != 1:
                raise ValueError(f"{name} must be a CUDA [B, 1, KVH, D] "
                                 "tensor with unit inner stride")
        knew, vnew, nsc = k, v, None
        new_bs, new_hs = k.stride(0), k.stride(2)
    else:
        new, nsc = _pool_rows(cache, torch.stack([k[:, 0], v[:, 0]], dim=1))
        _cuda.check(new, "k, v", pool.dtype, (b, 2, kvh, d))
        knew, vnew = new[:, 0], new[:, 1]
        new_bs, new_hs = 2 * kvh * d, d
    pos, valid = _pos_valid(positions, valid, b)
    out = torch.empty(b, 1, heads, d, dtype=torch.float32, device=q.device)
    args = [q.data_ptr(), knew.data_ptr(), vnew.data_ptr(), new_bs, new_hs,
            _cuda.ptr(nsc), _cuda.ptr(its), _cuda.ptr(kn), _cuda.ptr(qn),
            pool.data_ptr(), _cuda.ptr(sc), pos.data_ptr(), _cuda.ptr(valid),
            out.data_ptr(), b, n_layers, idx, kvh, heads, s_alloc, d, ring,
            int(window), q_bs, pe_mode, qscale, float(att_cap)]
    if s_block is not None:
        part, ticket = _sblocked_scratch(b, kvh, heads, d, ring, int(window),
                                         q.device)
        args += [part.data_ptr(), part.numel(), ticket.data_ptr()]
    kernel.launch(*args)
    return out
