"""Synthetic model parameters made on the target device (counterpart of
gemma_tpu/utils/synth.py, whose weight layouts it follows), in every
weight kind: i8, sfp, nuq, bf16, f32, i4 and nuq4.

Weights come from a seeded `torch.Generator` on `device`, so a full-size
Gemma2-2B (2.6 GB of one-byte codes) is built on the card in well under a
second instead of a numpy loop on the host.  The numbers differ from the
JAX synth for the same seed; tests that compare the two packages carry
one set of weights across with models/bridge.py instead.

The layout and byte counts are the JAX synth's, but the weights are
scaled to rms ~1/sqrt(K) (embedding rows: EMBEDDING_RMS): through the
group scales for i8 and i4, through the tensor's `scale` for sfp, nuq and
nuq4 (random SFP bytes decode to rms 0.42, `sfp_rms`), in the values for
bf16 and f32.
The JAX synth's i8 scales of |N(0, 0.05)| + 0.01 give weights of rms
~3.7, which saturate every soft cap at Gemma2 width, so checks of the
logits (decode vs prefill, card vs CPU) would compare ties.
"""

from __future__ import annotations

import torch

from gemma_tpu_torch.models.configs import LayerAttentionType, ModelConfig
from gemma_tpu_torch.models.gemma import LayerParams, Params, _slice_rows
from gemma_tpu_torch.ops.matmul import QuantTensor, sfp_decode, unknown_kind
from gemma_tpu_torch.utils.basics import resolve_device, round_up

# The (tied) embedding rows' rms: the logits spread about EMBEDDING_RMS *
# sqrt(model_dim), 2.4 at Gemma2-2B width.  At 0.25 (a spread of 12) the
# largest logits crowd the final soft cap of 30, which squeezes their gaps
# below the tolerances of the checks that compare greedy tokens.
EMBEDDING_RMS = 0.05


def sfp_rms() -> float:
    """The rms of the values of uniformly random SFP bytes."""
    every = sfp_decode(torch.arange(256, dtype=torch.uint8))
    return float(every.square().mean().sqrt())


def synth_quant(gen: torch.Generator, n: int, k: int, device,
                kind: str = "i8", rms: float | None = None) -> QuantTensor:
    """Random [n, k] weights of rms `rms` (1/sqrt(k) by default).

    i8: codes uniform in [-128, 127) (std ~74), group inverse scales
    U(0.5, 1.5) * rms / 74 and zero points N(0, 2) in code units, per 128
    K.  sfp / nuq: uniformly random bytes (every byte is a valid SFP
    code), tensor scale rms / sfp_rms().  bf16 / f32: N(0, rms), scale 1.
    i4: uniformly random packed bytes (codes 0..15, std 4.61 about 7.5),
    group scales U(0.5, 1.5) * rms / 4.64 and mins -(7.5 + N(0, 0.5)) *
    scale, per 128 K.  nuq4: the same codes; each 256-block's table is 16
    random SFP bytes (7 random bits and a sign) sorted by value, as cluster
    centres are, rows zero-padded to a multiple of 128 bytes; tensor scale
    rms over the tables' own rms."""
    rms = 1.0 / k ** 0.5 if rms is None else rms
    if kind in ("bf16", "f32"):
        w = torch.randn(n, k, generator=gen, device=device).mul_(rms)
        return QuantTensor(kind, (n, k), 1.0, {"w": w.to(
            torch.bfloat16 if kind == "bf16" else torch.float32)})
    if kind in ("sfp", "nuq"):
        codes = torch.randint(0, 256, (n, k), generator=gen, device=device,
                              dtype=torch.uint8)
        return QuantTensor(kind, (n, k), rms / sfp_rms(), {"codes": codes})
    if kind in ("i4", "nuq4"):
        blocks = -(-k // 256)
        codes = torch.randint(0, 256, (n, blocks * 128), generator=gen,
                              device=device, dtype=torch.uint8)
        if kind == "i4":
            sc = torch.rand(n, blocks * 2, generator=gen, device=device)
            sc.add_(0.5).mul_(rms / 4.64)
            off = torch.randn(n, blocks * 2, generator=gen, device=device)
            mins = off.mul_(0.5).add_(7.5).mul_(sc).neg_()
            return QuantTensor("i4", (n, k), 1.0,
                               {"codes": codes, "scales": sc, "mins": mins})
        entries = torch.randint(0, 256, (n, blocks, 16), generator=gen,
                                device=device, dtype=torch.uint8)
        values = sfp_decode(entries)
        entries = entries.gather(-1, values.argsort(dim=-1))
        tables = torch.zeros(n, round_up(blocks * 16, 128), dtype=torch.uint8,
                             device=device)
        tables[:, :blocks * 16] = entries.reshape(n, -1)
        table_rms = float(values.square().mean().sqrt())
        return QuantTensor("nuq4", (n, k), rms / table_rms,
                           {"codes": codes, "tables": tables})
    if kind != "i8":
        raise unknown_kind(kind)
    g = k // 128
    codes = torch.randint(-128, 127, (n, k), generator=gen, device=device,
                          dtype=torch.int8)
    inv = torch.rand(n, g, generator=gen, device=device).add_(0.5)
    inv.mul_(rms / 74.0)
    zp = torch.randn(n, g, generator=gen, device=device).mul_(2.0)
    return QuantTensor("i8", (n, k), 1.0,
                       {"codes": codes, "inv_scales": inv, "zeropoints": zp})


def synth_params(config: ModelConfig, kind: str = "i8", seed: int = 0,
                 device=None, embedding_rms: float = EMBEDDING_RMS,
                 fuse_qkv: bool = True) -> Params:
    """Full Params with synthetic weights on `device` (CUDA unless the
    caller names one): the q and kv projections row-concatenated in
    qkv_cat, or with fuse_qkv=False split into qkv1 / qkv2 (the rows of
    the same draw, so both layouts hold the same weights).

    embedding_rms: the (tied) embedding rows' rms.  At the default the
    last prompt token's own logit leads every other by ~10, so decode
    repeats it whatever the sampler; about 0.012 at Gemma2-2B width puts
    the top few hundred logits within ~1 of each other, which is what a
    check of sampled decode wants."""
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    d = config.model_dim

    def norm(n):
        return torch.randn(n, generator=gen, device=device).mul_(0.05)

    layers = []
    for lc in config.layer_configs:
        if lc.type != LayerAttentionType.GEMMA:
            continue
        h, kvh, q, ff = lc.heads, lc.kv_heads, lc.qkv_dim, lc.ff_hidden_dim
        cat = synth_quant(gen, (h + 2 * kvh) * q, d, device, kind)
        q1 = q2 = None
        if not fuse_qkv:
            q1, q2 = _slice_rows(cat, 0, h * q), _slice_rows(
                cat, h * q, (h + 2 * kvh) * q)
            cat = None
        layers.append(LayerParams(
            qkv1=q1, qkv2=q2, qkv_cat=cat,
            att_w=synth_quant(gen, d, h * q, device, kind),
            gating1=synth_quant(gen, ff, d, device, kind),
            gating2=synth_quant(gen, ff, d, device, kind),
            linear=synth_quant(gen, d, ff, device, kind),
            pre_att_norm=norm(d), pre_ffw_norm=norm(d),
            post_att_norm=norm(d) if lc.post_norm else None,
            post_ffw_norm=norm(d) if lc.post_norm else None,
            key_norm=norm(q) if lc.use_qk_norm else None,
            query_norm=norm(q) if lc.use_qk_norm else None,
        ))
    return Params(embedding=synth_quant(gen, config.vocab_size, d, device,
                                        kind, rms=embedding_rms),
                  final_norm=norm(d), layers=layers)
