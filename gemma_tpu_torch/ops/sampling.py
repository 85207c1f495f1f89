"""Greedy token selection (counterpart of gemma_tpu/ops/sampling.py:top1;
reference Top1OfSoftmax, ops/ops-inl.h:1228-1257).

Top-k / temperature sampling is a later slice together with its fused
head kernel (the TPU's _topk_kernel)."""

from __future__ import annotations

import torch

# Large-negative filler for masked-out logits (finite, so the softmax of
# a fully masked row cannot NaN); ops/attention.py's mask value.
NEG_INF = -2.3819763e38


def top1(logits: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(token, prob) per row of [B, V] logits: the argmax (ties go to the
    lowest index, as jnp.argmax) and its softmax probability."""
    lf = logits.float()
    token = torch.argmax(lf, dim=-1)
    m = lf.amax(dim=-1, keepdim=True)
    e = torch.exp(lf - m)
    prob = e.gather(-1, token[:, None])[:, 0] / e.sum(dim=-1)
    return token.to(torch.int32), prob
