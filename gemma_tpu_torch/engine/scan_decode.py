"""Scan-over-layers decode (counterpart of gemma_tpu/engine/scan_decode.py).

The per-layer weights are stacked once into P period-position layers whose
tensors carry a leading [T] dim (`build_scan_params`), and the decode step
(T == 1) runs one period body T times (`forward_scan`): layer t*P + p is
position p's body at iteration t.  Its GEMMs take `layer=t`, which on
CUDA runs the stacked K1 / K2 kernels (K12): each reads the layer index
from the device and its blocks read that layer out of the [T, N, K]
weight, so no layer is copied; the norm vectors are views of their [T, K]
rows.  Attention goes through `decode_attention_write` on a single-pool
view of the cache, at pool index off_p + stride_p * t (`_pool_affine`):
K8, or K11 or K9 + K10 under the JAX package's decode switches.

The period (`detect_period`) groups the config's repeating layer pattern:
Gemma2 alternates local and global attention, P = 2.  Each position has
one window, ring, pool and RoPE base.

Numerics are the unrolled `models/gemma.py:forward`'s decode step: the
same GEMMs, norms and attention, in the same order.  The one difference
is a bf16 weight's tensor scale, which stacking folds into the weights
(one more rounding).

The T loop is a Python loop over the period body; the JAX package's
`lax.scan` has no counterpart the port needs (capturing the step as a
CUDA graph is later work).
"""

from __future__ import annotations

import dataclasses

import torch

from gemma_tpu_torch.models.configs import (LayerAttentionType, ModelConfig,
                                            PostNormType, PostQKType, is_vlm)
from gemma_tpu_torch.models.gemma import (LayerParams, Params, _absolute_pe,
                                          _inv_timescale, embed_tokens)
from gemma_tpu_torch.models.kv_cache import KVCache
from gemma_tpu_torch.ops import ops
from gemma_tpu_torch.ops.decode_attention import (RopeSpec,
                                                  decode_attention_write)
from gemma_tpu_torch.ops.matmul import (QuantTensor, gated_ffn, matmul,
                                        matmul_top1, matmul_topk,
                                        stack_quant_tensors)


_NORMS = ("pre_att_norm", "pre_ffw_norm", "post_att_norm", "post_ffw_norm",
          "key_norm", "query_norm")


def detect_period(config: ModelConfig) -> int | None:
    """Smallest P dividing L with layer signatures repeating mod P, or
    None when a layer is not of type GEMMA (scan_decode.py:51-72)."""
    lcs = config.layer_configs
    n = len(lcs)

    def sig(i):
        lc = lcs[i]
        if lc.type != LayerAttentionType.GEMMA:
            return None
        return (config.attention_window_sizes[i], config.is_global_layer(i),
                lc.heads, lc.kv_heads, lc.qkv_dim, lc.ff_hidden_dim,
                lc.post_norm, lc.post_qk, lc.use_qk_norm)

    sigs = [sig(i) for i in range(n)]
    if any(s is None for s in sigs):
        return None
    for p in range(1, n + 1):
        if n % p == 0 and all(sigs[i] == sigs[i % p] for i in range(n)):
            return p
    return n


def build_scan_params(params: Params, config: ModelConfig) -> Params | None:
    """params.layers stacked into P period-position LayerParams whose
    tensors lead with [T] (scan_decode.py:75-114): weights through
    `stack_quant_tensors`, norm vectors through torch.stack.

    None when the model cannot scan: a layer not of type GEMMA, a
    non-periodic pattern, T == 1, or weights that will not stack (tensor
    scales that differ per layer: load with kind_override "i8" or
    "i4")."""
    period = detect_period(config)
    if period is None:
        return None
    t_iters = len(params.layers) // period
    if t_iters <= 1:
        return None

    def stack_leaf(leaves):
        if all(x is None for x in leaves):
            return None
        if any(x is None for x in leaves):
            raise ValueError("mixed None / tensor leaf across layers")
        if isinstance(leaves[0], QuantTensor):
            return stack_quant_tensors(list(leaves))
        return torch.stack(leaves)

    stacks = []
    try:
        for p in range(period):
            group = [params.layers[t * period + p] for t in range(t_iters)]
            stacks.append(LayerParams(**{
                f.name: stack_leaf([getattr(lp, f.name) for lp in group])
                for f in dataclasses.fields(LayerParams)}))
    except ValueError:
        return None
    return Params(embedding=params.embedding, final_norm=params.final_norm,
                  layers=stacks)


def _pool_affine(cache: KVCache, period: int, t_iters: int):
    """Per period position, (is_local, off, stride) such that layer
    t*P + p sits at index off + stride*t of its pool (scan_decode.py:
    117-135); None when the cache's layer_map is not periodic-affine (a
    cache built for another config), which the unrolled step serves."""
    out = []
    for p in range(period):
        if not cache.layer_map:
            out.append((False, p, period))
            continue
        entries = [cache.layer_map[t * period + p] for t in range(t_iters)]
        is_local = entries[0][0]
        if any(e[0] != is_local for e in entries):
            return None
        idxs = [e[1] for e in entries]
        stride = idxs[1] - idxs[0] if t_iters > 1 else 0
        if any(idxs[t] != idxs[0] + stride * t for t in range(t_iters)):
            return None
        out.append((is_local, idxs[0], stride))
    return out


def scan_layout(sparams: Params, cache: KVCache):
    """_pool_affine of `cache` for stacked params, or None."""
    t_iters = sparams.layers[0].pre_att_norm.shape[0]
    return _pool_affine(cache, len(sparams.layers), t_iters)


@dataclasses.dataclass(frozen=True)
class ScanPlan:
    """What forward_scan's period bodies keep from step to step for one
    (stacked params, cache) pair: per period position its stacked layer,
    config, pool (a single-pool view; with no layer_map the pool index
    passes straight through to the kernels, and the pools update in
    place), pool index off + stride * t, [T, K] norm vectors as T row
    views each, RoPE inverse timescales and window."""
    cache: KVCache
    t_iters: int
    bodies: tuple


def scan_plan(sparams: Params, cache: KVCache,
              config: ModelConfig) -> ScanPlan | None:
    """The ScanPlan of `cache` for stacked sparams, made once per decode
    chunk; None when the cache's layer_map is not periodic-affine."""
    affine = scan_layout(sparams, cache)
    if affine is None:
        return None
    lc0 = config.layer_configs[0]
    half_rope = lc0.post_qk == PostQKType.HALF_ROPE
    inv_ts = _inv_timescale(lc0.qkv_dim, half_rope, 10000.0, sparams.device)
    inv_ts_g = inv_ts
    if is_vlm(config.model):
        inv_ts_g = _inv_timescale(lc0.qkv_dim, half_rope, 1e6,
                                  sparams.device)
    bodies = []
    for p, layer in enumerate(sparams.layers):
        lci = config.layer_configs[p]  # layer t*P + p: periodic
        is_local, off, stride = affine[p]
        view = KVCache(
            kv=cache.kv_local if is_local else cache.kv,
            seq_len=cache.seq_len_local if is_local else cache.seq_len,
            kv_scale=cache.kv_local_scale if is_local else cache.kv_scale)
        norms = {name: None if getattr(layer, name) is None
                 else getattr(layer, name).unbind(0)
                 for name in _NORMS}
        bodies.append((layer, lci, view, off, stride, norms,
                       inv_ts_g if config.is_global_layer(p) else inv_ts,
                       config.attention_window_sizes[p]))
    return ScanPlan(cache, sparams.layers[0].pre_att_norm.shape[0],
                    tuple(bodies))


def forward_scan(sparams: Params, tokens: torch.Tensor,
                 positions: torch.Tensor, cache: KVCache,
                 config: ModelConfig, return_logits: str = "last",
                 valid: torch.Tensor | None = None,
                 top1_mask: torch.Tensor | None = None, top_k_n: int = 0,
                 top1_need_prob: bool = True, plan: ScanPlan | None = None):
    """The T == 1 decode step of models/gemma.py:forward over stacked
    sparams (build_scan_params), one period body per iteration
    (scan_decode.py:145-281).  return_logits: "last", "top1", "topk" or
    "none", as `forward`'s.  The cache is updated in place; one whose
    layer_map is not periodic-affine raises (the engine routes it to
    `forward` before any launch).  plan: `scan_plan(sparams, cache,
    config)`, which a caller decoding several steps makes once; made
    here when None."""
    b, t = tokens.shape
    if t != 1:
        raise ValueError("forward_scan is the decode (T == 1) step")
    if return_logits == "topk" and top_k_n < 1:
        raise ValueError("return_logits='topk' needs top_k_n >= 1")
    if plan is None:
        plan = scan_plan(sparams, cache, config)
        if plan is None:
            raise ValueError("the cache's layer_map is not periodic-affine: "
                             "decode it with models/gemma.py:forward")
    elif plan.cache is not cache:
        raise ValueError("plan was made for another cache")
    model_dim = config.model_dim

    x = embed_tokens(sparams.embedding, tokens, model_dim)
    if config.absolute_pe:
        x = x + _absolute_pe(positions, model_dim)
    x_flat = x.reshape(b, model_dim)
    query_scale = config.query_scale_value()

    for ti in range(plan.t_iters):
        for layer, lci, view, off, stride, norms, ts, window in plan.bodies:
            heads, kv_heads, qkv_dim = lci.heads, lci.kv_heads, lci.qkv_dim
            pre_att = norms["pre_att_norm"][ti]
            if layer.qkv_cat is not None:
                qkv_all = matmul(x_flat, layer.qkv_cat,
                                 out_dtype=torch.float32,
                                 prologue_norm=pre_att, layer=ti)
                q = qkv_all[:, :heads * qkv_dim]
                kvp = qkv_all[:, heads * qkv_dim:]
            else:
                q = matmul(x_flat, layer.qkv1, out_dtype=torch.float32,
                           prologue_norm=pre_att, layer=ti)
                kvp = matmul(x_flat, layer.qkv2, out_dtype=torch.float32,
                             prologue_norm=pre_att, layer=ti)
            q = q.reshape(b, 1, heads, qkv_dim)
            # qkv2's rows interleave K and V per KV head.
            kvp = kvp.reshape(b, 1, kv_heads, 2, qkv_dim)
            k, v = kvp[..., 0, :], kvp[..., 1, :]

            use_qk = lci.use_qk_norm
            spec = RopeSpec(
                ts, int(lci.post_qk), query_scale,
                key_norm=norms["key_norm"][ti] if use_qk else None,
                query_norm=norms["query_norm"][ti] if use_qk else None)
            att = decode_attention_write(
                view, off + stride * ti, q, positions, k, v, window,
                att_cap=config.att_cap, valid=valid, rope=spec)
            att2 = att.reshape(b, heads * qkv_dim).to(torch.bfloat16)

            scaled = lci.post_norm == PostNormType.SCALE
            x_flat = matmul(att2, layer.att_w, out_dtype=torch.float32,
                            epilogue_norm=norms["post_att_norm"][ti]
                            if scaled else None, add=x_flat, layer=ti)
            activated = gated_ffn(x_flat, layer.gating1, layer.gating2,
                                  out_dtype=torch.bfloat16,
                                  prologue_norm=norms["pre_ffw_norm"][ti],
                                  layer=ti)
            x_flat = matmul(activated, layer.linear, out_dtype=torch.float32,
                            epilogue_norm=norms["post_ffw_norm"][ti]
                            if scaled else None, add=x_flat, layer=ti)

    if return_logits == "none":
        return None, cache
    if return_logits == "top1":
        head = matmul_top1(x_flat, sparams.embedding,
                           final_cap=config.final_cap,
                           prologue_norm=sparams.final_norm,
                           allowed_mask=top1_mask, need_prob=top1_need_prob)
        return head, cache
    if return_logits == "topk":
        head = matmul_topk(x_flat, sparams.embedding, top_k_n,
                           final_cap=config.final_cap,
                           prologue_norm=sparams.final_norm,
                           allowed_mask=top1_mask)
        return head, cache
    if return_logits != "last":
        raise ValueError(return_logits)
    logits = matmul(x_flat, sparams.embedding, out_dtype=torch.float32,
                    prologue_norm=sparams.final_norm)
    return ops.soft_cap(config.final_cap, logits), cache
