"""Synthetic i8 model parameters made on the target device (counterpart of
gemma_tpu/utils/synth.py, whose weight layout it follows).

Weights come from a seeded `torch.Generator` on `device`, so a full-size
Gemma2-2B (2.6 GB of i8 codes) is built on the card in well under a
second instead of a numpy loop on the host.  The numbers differ from the
JAX synth for the same seed; tests that compare the two packages carry
one set of weights across with models/bridge.py instead.

The layout and byte counts are the JAX synth's, but the group scales are
set so the dequantized weights have rms ~1/sqrt(K) (embedding rows:
EMBEDDING_RMS): the JAX synth's |N(0, 0.05)| + 0.01 scales give weights
of rms ~3.7, which saturate every soft cap at Gemma2 width, so checks of
the logits (decode vs prefill, card vs CPU) would compare ties.
"""

from __future__ import annotations

import torch

from gemma_tpu_torch.models.configs import LayerAttentionType, ModelConfig
from gemma_tpu_torch.models.gemma import LayerParams, Params
from gemma_tpu_torch.ops.matmul import QuantTensor
from gemma_tpu_torch.utils.basics import resolve_device

# The (tied) embedding rows' rms: the logits spread about EMBEDDING_RMS *
# sqrt(model_dim), 2.4 at Gemma2-2B width.  At 0.25 (a spread of 12) the
# largest logits crowd the final soft cap of 30, which squeezes their gaps
# below the tolerances of the checks that compare greedy tokens.
EMBEDDING_RMS = 0.05


def synth_quant(gen: torch.Generator, n: int, k: int, device,
                kind: str = "i8", rms: float | None = None) -> QuantTensor:
    """Random i8 weights: codes uniform in [-128, 127) (std ~74), group
    inverse scales U(0.5, 1.5) * rms / 74 with rms = 1/sqrt(k) by default,
    and zero points N(0, 2) in code units, per 128 K."""
    if kind != "i8":
        raise NotImplementedError(f"synth kind {kind}: this slice serves i8")
    g = k // 128
    rms = 1.0 / k ** 0.5 if rms is None else rms
    codes = torch.randint(-128, 127, (n, k), generator=gen, device=device,
                          dtype=torch.int8)
    inv = torch.rand(n, g, generator=gen, device=device).add_(0.5)
    inv.mul_(rms / 74.0)
    zp = torch.randn(n, g, generator=gen, device=device).mul_(2.0)
    return QuantTensor("i8", (n, k), 1.0,
                       {"codes": codes, "inv_scales": inv, "zeropoints": zp})


def synth_params(config: ModelConfig, kind: str = "i8", seed: int = 0,
                 device=None) -> Params:
    """Full Params with synthetic weights, qkv row-concatenated, on
    `device` (CUDA unless the caller names one)."""
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
        layers.append(LayerParams(
            qkv_cat=synth_quant(gen, (h + 2 * kvh) * q, d, device, kind),
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
                                        kind, rms=EMBEDDING_RMS),
                  final_norm=norm(d), layers=layers)
