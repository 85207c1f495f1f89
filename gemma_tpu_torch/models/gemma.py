"""The Gemma transformer forward pass (counterpart of
gemma_tpu/models/gemma.py; reference gemma/gemma.cc TransformerLayer and
gemma/attention.cc).

`forward(params, tokens, positions, cache, config, ...)` runs a [B, T]
token step and returns (logits, (token, prob) or None; cache); the cache
is updated in place.  Decode (T == 1) runs the fused layer: the pre-norms
ride the GEMM prologues, the post-norms and residual adds the K1 epilogue
pass, and QK norms + RoPE + the row write + attention run in the K4
kernel over the fused qkv GEMM's row, or, for split q / kv weights (two
GEMMs), in K8 (K11, or K9 + K10, under the JAX package's switches:
ops/decode_attention.py).  The greedy head (return_logits="top1") is K3
and the top-k head of sampled decode (return_logits="topk") is K6, each
with the final norm as its prologue.
Prefill keeps the composed path: plain-torch norms, RoPE and the cache
scatter around the K1/K2 GEMMs and the K5 attention kernel.

Numerics follow the reference:
  embed: decompress(embedding[token]) * bf16(sqrt(model_dim)) * scale
  layer: x += postnorm(att(RMSNorm(x))); x += postnorm(ffn(RMSNorm(x)))
  final: logits = softcap(RMSNorm(x) -> bf16 . embedding^T)
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from gemma_tpu_torch.models.configs import LayerAttentionType, ModelConfig, \
    PostNormType, PostQKType, is_vlm
from gemma_tpu_torch.models.kv_cache import KVCache
from gemma_tpu_torch.ops import ops
from gemma_tpu_torch.ops.decode_attention import (
    RopeSpec, decode_attention_write, decode_attention_write_packed)
from gemma_tpu_torch.ops.flash_attention import flash_prefill_attention
from gemma_tpu_torch.ops.matmul import (QuantTensor, concat_rows, gated_ffn,
                                        matmul, matmul_top1, matmul_topk,
                                        nuq4_gather, quant_tensor_from_packed,
                                        quant_tensor_i4, sfp_decode,
                                        unknown_kind, unpack_nuq4)
from gemma_tpu_torch.utils.basics import resolve_device


@dataclasses.dataclass
class LayerParams:
    """One layer's weights (gemma/weights.h:93-269, post-Fixup).

    The q and kv projections live either row-concatenated in `qkv_cat`
    [(heads + 2*kv_heads) * qkv_dim, model_dim], one GEMM per layer, with
    qkv1 and qkv2 None (the weights exist once), or split in qkv1 and
    qkv2 with qkv_cat None: when they differ in kind, K or tensor scale,
    or when the caller asks for the split layout."""

    qkv1: QuantTensor | None  # [heads * qkv_dim, model_dim]
    qkv2: QuantTensor | None  # [2 * kv_heads * qkv_dim, model_dim]
    att_w: QuantTensor      # [model_dim, heads * qkv_dim]
    gating1: QuantTensor    # [ff_hidden, model_dim]
    gating2: QuantTensor    # [ff_hidden, model_dim]
    linear: QuantTensor     # [model_dim, ff_hidden]
    pre_att_norm: torch.Tensor
    pre_ffw_norm: torch.Tensor
    post_att_norm: torch.Tensor | None = None
    post_ffw_norm: torch.Tensor | None = None
    key_norm: torch.Tensor | None = None
    query_norm: torch.Tensor | None = None
    qkv_cat: QuantTensor | None = None


@dataclasses.dataclass
class Params:
    embedding: QuantTensor  # [vocab, model_dim]
    final_norm: torch.Tensor
    layers: list[LayerParams]

    @property
    def device(self) -> torch.device:
        return self.final_norm.device


def embed_tokens(embedding: QuantTensor, tokens: torch.Tensor,
                 model_dim: int) -> torch.Tensor:
    """EmbedMMToken (gemma.cc:135-183): rows * bf16(sqrt(dim)) * scale, f32."""
    emb_scale = ops.embedding_scaling(model_dim) * float(embedding.scale)
    tok = tokens.long()
    if embedding.kind in ("bf16", "f32"):
        rows = embedding.arrays["w"][tok].float()
    elif embedding.kind in ("sfp", "nuq"):
        rows = sfp_decode(embedding.arrays["codes"][tok])
    elif embedding.kind == "i8":
        codes = embedding.arrays["codes"][tok].float()
        inv = embedding.arrays["inv_scales"][tok]
        zp = embedding.arrays["zeropoints"][tok]
        g = inv.shape[-1]
        shaped = codes.reshape(*codes.shape[:-1], g, codes.shape[-1] // g)
        rows = (inv[..., None] * (shaped - zp[..., None])).reshape(codes.shape)
    elif embedding.kind == "i4":
        # The token's packed row with its scales and mins, decoded on the
        # fly and cut to model_dim.
        codes = unpack_nuq4(embedding.arrays["codes"][tok]).float()
        sc = embedding.arrays["scales"][tok]
        mn = embedding.arrays["mins"][tok]
        g = sc.shape[-1]
        shaped = codes.reshape(*codes.shape[:-1], g, codes.shape[-1] // g)
        rows = (sc[..., None] * shaped + mn[..., None]).reshape(
            codes.shape)[..., :model_dim]
    elif embedding.kind == "nuq4":
        codes = unpack_nuq4(embedding.arrays["codes"][tok])[..., :model_dim]
        rows = nuq4_gather(sfp_decode(embedding.arrays["tables"][tok]), codes)
    else:
        raise unknown_kind(embedding.kind)
    return rows * emb_scale


def transformer_layer(layer: LayerParams, layer_idx: int, x: torch.Tensor,
                      positions: torch.Tensor, cache: KVCache,
                      config: ModelConfig, prefix_end=0,
                      inv_timescale=None, inv_timescale_global=None,
                      valid=None) -> torch.Tensor:
    """One TransformerLayer (gemma.cc:83-116). x: [B, T, model_dim] f32."""
    lc = config.layer_configs[layer_idx]
    b, t, model_dim = x.shape
    heads, kv_heads, qkv_dim = lc.heads, lc.kv_heads, lc.qkv_dim
    fuse = t == 1
    x_flat = x.reshape(b * t, model_dim)
    if fuse:
        a_in, pro = x_flat.contiguous(), layer.pre_att_norm
    else:
        a_in = ops.rms_norm(x, layer.pre_att_norm).reshape(
            b * t, model_dim).to(torch.bfloat16)
        pro = None
    ts = inv_timescale_global if (config.is_global_layer(layer_idx) and
                                  inv_timescale_global is not None) \
        else inv_timescale
    query_scale = config.query_scale_value()
    window = config.attention_window_sizes[layer_idx]
    is_decode = t == 1 and isinstance(prefix_end, int) and prefix_end == 0

    rope = RopeSpec(ts, int(lc.post_qk), query_scale,
                    key_norm=layer.key_norm if lc.use_qk_norm else None,
                    query_norm=layer.query_norm if lc.use_qk_norm else None)
    att_flat = None  # [bt, heads*D] bf16 once attention ran
    if layer.qkv_cat is not None:
        qkv_all = matmul(a_in, layer.qkv_cat, out_dtype=torch.float32,
                         prologue_norm=pro)
        if is_decode:
            att_flat = decode_attention_write_packed(
                cache, layer_idx, qkv_all, positions, window, heads=heads,
                att_cap=config.att_cap, valid=valid, rope=rope)
        else:
            q = qkv_all[:, :heads * qkv_dim]
            kv = qkv_all[:, heads * qkv_dim:]
    else:
        # Split q and kv weights: two GEMMs, each with the pre-attention
        # norm as its prologue (gemma.py:205-209).
        q = matmul(a_in, layer.qkv1, out_dtype=torch.float32,
                   prologue_norm=pro)
        kv = matmul(a_in, layer.qkv2, out_dtype=torch.float32,
                    prologue_norm=pro)
    if att_flat is None:
        q = q.reshape(b, t, heads, qkv_dim)
        # qkv2's rows interleave K and V per KV head.
        kv = kv.reshape(b, t, kv_heads, 2, qkv_dim)
        k, v = kv[..., 0, :], kv[..., 1, :]
        if is_decode:
            # K8 (or K11, or K9 + K10 under the JAX package's switches).
            att = decode_attention_write(
                cache, layer_idx, q, positions, k, v, window,
                att_cap=config.att_cap, valid=valid, rope=rope)
        else:
            q, k = rope.apply_host(q, k, positions)
            cache.update(layer_idx, positions, k, v, valid=valid)
            att = flash_prefill_attention(cache, layer_idx, q, positions,
                                          window, att_cap=config.att_cap,
                                          prefix_end=prefix_end)
        att_flat = att.reshape(b * t, heads * qkv_dim).to(torch.bfloat16)

    post_att = layer.post_att_norm \
        if lc.post_norm == PostNormType.SCALE else None
    post_ffw = layer.post_ffw_norm \
        if lc.post_norm == PostNormType.SCALE else None
    if fuse:
        # x + postnorm(att . W), then the FFN with its norm as prologue.
        x_flat = matmul(att_flat, layer.att_w, out_dtype=torch.float32,
                        epilogue_norm=post_att, add=x_flat.contiguous())
        activated = gated_ffn(x_flat, layer.gating1, layer.gating2,
                              out_dtype=torch.bfloat16,
                              prologue_norm=layer.pre_ffw_norm)
        out = matmul(activated, layer.linear, out_dtype=torch.float32,
                     epilogue_norm=post_ffw, add=x_flat)
        return out.reshape(b, t, model_dim)
    att_sums = matmul(att_flat, layer.att_w, out_dtype=torch.float32)
    att_sums = att_sums.reshape(b, t, model_dim)
    if post_att is not None:
        att_sums = ops.rms_norm(att_sums, post_att)
    x = x + att_sums
    y = ops.rms_norm(x, layer.pre_ffw_norm).reshape(b * t, model_dim)
    activated = gated_ffn(y.to(torch.bfloat16), layer.gating1, layer.gating2,
                          out_dtype=torch.bfloat16)
    ffw_out = matmul(activated, layer.linear, out_dtype=torch.float32)
    ffw_out = ffw_out.reshape(b, t, model_dim)
    if post_ffw is not None:
        ffw_out = ops.rms_norm(ffw_out, post_ffw)
    return x + ffw_out


@functools.lru_cache(maxsize=None)
def _inv_timescale(qkv_dim: int, half: bool, base: float,
                   device: torch.device) -> torch.Tensor:
    """RoPE inverse timescales on `device`, made once: a host-to-device
    copy per step would synchronize the host with the card."""
    return torch.from_numpy(ops.create_inv_timescale(
        qkv_dim, half, base_frequency=base)).to(device)


def _absolute_pe(positions: torch.Tensor, model_dim: int) -> torch.Tensor:
    """AddAbsolutePositionalEmbeddings (ops-inl.h:316-330; the JAX
    package's gemma.py:418-424): [..., model_dim] f32, sin then cos of
    position * 10000^(-i / (half - 1))."""
    half = model_dim // 2
    log_inc = float(np.log(10000.0) / max(half - 1, 1))
    inv = torch.exp(torch.arange(half, dtype=torch.float32,
                                 device=positions.device) * -log_inc)
    theta = positions[..., None].float() * inv
    return torch.cat([torch.sin(theta), torch.cos(theta)], dim=-1)


def forward(params: Params, tokens: torch.Tensor, positions: torch.Tensor,
            cache: KVCache, config: ModelConfig, prefix_end=0,
            return_logits: str = "all", valid: torch.Tensor | None = None,
            top1_mask: torch.Tensor | None = None,
            top_k_n: int = 0, top1_need_prob: bool = True):
    """Run the stack over a [B, T] token step (gemma.py:289-381).

    return_logits: "all" -> [B, T, vocab]; "last" -> [B, vocab] for the
    final token (final norm as the head GEMM's prologue); "top1" ->
    (token int32 [B], prob f32 [B]), the greedy head fused into the logits
    GEMM (K3), constrained by top1_mask [vocab] bool when given;
    top1_need_prob=False returns the raw-logits argmax with prob 1.0;
    "topk" -> (values f32 [B, top_k_n], indices int32 [B, top_k_n]), the
    top-k head of sampled decode fused into the logits GEMM (K6), under
    the same mask; "none" -> None.  Returns (that, cache); the cache is
    updated in place."""
    if return_logits == "topk" and top_k_n < 1:
        raise ValueError("return_logits='topk' needs top_k_n >= 1")
    lc = config.layer_configs[0]
    device = params.device
    x = embed_tokens(params.embedding, tokens, config.model_dim)
    if config.absolute_pe:
        x = x + _absolute_pe(positions, config.model_dim)
    half = lc.post_qk == PostQKType.HALF_ROPE
    inv_ts = _inv_timescale(lc.qkv_dim, half, 10000.0, device)
    inv_ts_g = None
    if is_vlm(config.model):
        inv_ts_g = _inv_timescale(lc.qkv_dim, half, 1e6, device)
    for layer_idx, layer in enumerate(params.layers):
        x = transformer_layer(layer, layer_idx, x, positions, cache, config,
                              prefix_end, inv_ts, inv_ts_g, valid)
    if return_logits == "none":
        return None, cache
    if return_logits == "top1":
        head = matmul_top1(x[:, -1, :].contiguous(), params.embedding,
                           final_cap=config.final_cap,
                           prologue_norm=params.final_norm,
                           allowed_mask=top1_mask, need_prob=top1_need_prob)
        return head, cache
    if return_logits == "topk":
        head = matmul_topk(x[:, -1, :].contiguous(), params.embedding,
                           top_k_n, final_cap=config.final_cap,
                           prologue_norm=params.final_norm,
                           allowed_mask=top1_mask)
        return head, cache
    if return_logits == "last":
        x1 = x[:, -1, :].contiguous()
        logits = matmul(x1, params.embedding, out_dtype=torch.float32,
                        prologue_norm=params.final_norm)
        return ops.soft_cap(config.final_cap, logits), cache
    if return_logits != "all":
        raise ValueError(return_logits)
    x_bf = ops.rms_norm(x, params.final_norm).to(torch.bfloat16)
    b, t, _ = x_bf.shape
    logits = matmul(x_bf.reshape(b * t, -1), params.embedding,
                    out_dtype=torch.float32)
    return ops.soft_cap(config.final_cap, logits).reshape(b, t, -1), cache


# ---------------------------------------------------------------------------
# Weights loading (gemma_tpu/models/gemma.py:load_params; the reference's
# gemma/weights.cc ReadFromBlobs + Fixup).
# ---------------------------------------------------------------------------


def _slice_rows(qt: QuantTensor, lo: int, hi: int) -> QuantTensor:
    """Split stacked tensors by rows at the device-layout level (the
    SplitW1/SplitAttW1 analog, weights.cc:90-170): every layout stores
    per-element or per-(row, group) arrays, so row slicing is exact."""
    arrays = {k: v[lo:hi] for k, v in qt.arrays.items()}
    return QuantTensor(qt.kind, (hi - lo, qt.k), qt.scale, arrays)


def _fixup_att_weights(qt: QuantTensor, heads: int, model_dim: int,
                       qkv_dim: int) -> QuantTensor:
    """att_ein [heads*model_dim, qkv] -> att_w [model_dim, heads*qkv]
    (InitAttWeights, weights.cc:46-87).  Pure permutation of the
    per-element arrays; i8 group scales permute along (128-sized) blocks."""
    def permute(a):
        # reshape may return a strided view (one i8 group a row does):
        # the kernels read contiguous arrays.
        return (a.reshape(heads, model_dim, *a.shape[1:]).transpose(0, 1)
                .reshape(model_dim, -1, *a.shape[2:]).contiguous())

    arrays = {k: permute(v) for k, v in qt.arrays.items()}
    return QuantTensor(qt.kind, (model_dim, heads * qkv_dim), qt.scale, arrays)


def load_params(store, kind_override: str | None = None,
                device=None, fuse_qkv: bool = True) -> Params:
    """Params on `device` (CUDA unless the caller names one) from an
    io.model_store.ModelStore, tensor for tensor as the JAX loader builds
    them.  kind_override transcodes every weight at load: "i8", "i4",
    "bf16" from any stream type, "nuq4" from NUQ streams.  Under "nuq4"
    `att_ein` loads as kind "nuq": its per-256 blocks do not survive the
    permutation to att_w when qkv_dim < 256, while the per-element byte
    layout always does, so such a model mixes kinds per tensor.  With
    fuse_qkv the q and kv projections are row-concatenated into `qkv_cat`
    where they can be (same kind, K and tensor scale: `concat_rows`);
    otherwise, or without fuse_qkv, they stay split in qkv1 / qkv2, as
    the JAX loader keeps them (gemma.py:524-528)."""
    config: ModelConfig = store.config
    device = resolve_device(device)

    def qt(name: str, kind=None) -> QuantTensor | None:
        pt = store.read_tensor(name)
        if pt is None:
            return None
        return quant_tensor_from_packed(pt, kind or kind_override, device)

    def norm(name: str) -> torch.Tensor | None:
        pt = store.read_tensor(name)
        if pt is None:
            return None
        return torch.from_numpy(pt.to_f32().reshape(-1)).to(device)

    embedding = qt("c_embedding")
    final_norm = norm("c_final_norm")
    layers = []
    for i, lc in enumerate(config.layer_configs):
        if lc.type != LayerAttentionType.GEMMA:
            continue
        s = f"_{i}"
        heads, kv_heads, qkv_dim = lc.heads, lc.kv_heads, lc.qkv_dim

        q1 = qt("qkv1_w" + s)
        q2 = qt("qkv2_w" + s)
        if q1 is None:
            stacked = qt("qkv_ein" + s)
            w1_rows = heads * qkv_dim
            q1 = _slice_rows(stacked, 0, w1_rows)
            q2 = _slice_rows(stacked, w1_rows,
                             w1_rows + 2 * kv_heads * qkv_dim)
        g1 = qt("gating1_w" + s)
        g2 = qt("gating2_w" + s)
        if g1 is None:
            stacked = qt("gating_ein" + s)
            g1 = _slice_rows(stacked, 0, lc.ff_hidden_dim)
            g2 = _slice_rows(stacked, lc.ff_hidden_dim, 2 * lc.ff_hidden_dim)

        att_w = qt("att_w" + s)
        if att_w is None:
            if kind_override == "i4":
                # i4 is a load-time transcode anyway, so permute the f32
                # values on the host and encode the PERMUTED matrix: groups
                # land on the final layout for every qkv_dim.
                pt = store.read_tensor("att_ein" + s)
                vals = (pt.to_f32().reshape(heads, config.model_dim, qkv_dim)
                        .swapaxes(0, 1).reshape(config.model_dim, -1))
                att_w = quant_tensor_i4(np.ascontiguousarray(vals), device)
            else:
                ein_kind = "nuq" if kind_override == "nuq4" else kind_override
                att_ein = qt("att_ein" + s, kind=ein_kind)
                att_w = _fixup_att_weights(att_ein, heads, config.model_dim,
                                           qkv_dim)

        cat = concat_rows(q1, q2) if fuse_qkv else None
        if cat is not None:
            q1 = q2 = None
        layers.append(LayerParams(
            qkv1=q1, qkv2=q2, qkv_cat=cat, att_w=att_w, gating1=g1,
            gating2=g2,
            linear=qt("linear_w" + s),
            pre_att_norm=norm("pre_att_ns" + s),
            pre_ffw_norm=norm("pre_ff_ns" + s),
            post_att_norm=norm("post_att_ns" + s),
            post_ffw_norm=norm("post_ff_ns" + s),
            key_norm=norm("key_norm" + s),
            query_norm=norm("query_norm" + s)))
    return Params(embedding=embedding, final_norm=final_norm, layers=layers)
