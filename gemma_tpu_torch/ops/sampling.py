"""Token selection (counterpart of gemma_tpu/ops/sampling.py; reference
ops/ops-inl.h:1180-1398 and gemma/gemma.cc:459-485).

Greedy `top1`, and top-k / temperature sampling: softmax over the k
largest logits, the probabilities raised to 1/T and renormalised
(create_distribution, ops-inl.h:1314-1334; T = 0 is the argmax), and a
categorical draw by Gumbel-max over the stream of (seed, query, position)
(utils/basics.py:sample_key), so a draw does not depend on the batch, the
chunk size or the path that makes it.  The returned prob is the chosen
entry's softmax prob before the temperature.

`sample_stream` is what decode chunks call.  For CUDA tensors it launches
one small kernel of this port (csrc/sampling.cu, one warp per row: the
softmax, the Threefry stream and the Gumbel argmax), which has no TPU
counterpart: the JAX package leaves the draw to XLA.  Its plain version
is `sample_stream_plain`, the torch ops below.  The stream's key words
and uniforms equal JAX's bit for bit; the tokens need not, because log,
exp and pow round differently between libraries.
"""

from __future__ import annotations

import torch

from gemma_tpu_torch.ops import _cuda
from gemma_tpu_torch.utils.basics import sample_key, stream_uniform

# Large-negative filler for masked-out logits (finite, so the softmax of
# a fully masked row cannot NaN); ops/attention.py's mask value.
NEG_INF = -2.3819763e38
_TINY = float(torch.finfo(torch.float32).tiny)
MAX_DRAW_K = 128  # the draw kernel's row: the fused top-k head's limit

DRAW_TOPK = _cuda.Kernel(
    "draw_topk", "sampling.cu", "gemma_draw_topk",
    [_cuda.P] * 4 + [_cuda.I] * 3 + [_cuda.F] + [_cuda.I] + [_cuda.P] * 2)


def top1(logits: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(token, prob) per row of [B, V] logits: the argmax (ties go to the
    lowest index, as jnp.argmax) and its softmax probability."""
    lf = logits.float()
    token = torch.argmax(lf, dim=-1)
    m = lf.amax(dim=-1, keepdim=True)
    e = torch.exp(lf - m)
    prob = e.gather(-1, token[:, None])[:, 0] / e.sum(dim=-1)
    return token.to(torch.int32), prob


def top_k_sorted(logits: torch.Tensor, k: int):
    """(values, indices) [..., k] of the k largest entries, descending,
    ties to the lower index (jax.lax.top_k's order; torch.topk leaves the
    order of ties unspecified, a stable sort does not)."""
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def gumbel(key: torch.Tensor, n: int) -> torch.Tensor:
    """n standard Gumbel draws of the stream `key` [..., 2], f32 [..., n]
    (jax.random.gumbel's default mode: -log(-log(max(tiny, u))))."""
    u = stream_uniform(key, n).clamp_min(_TINY)
    return -torch.log(-torch.log(u))


def _draw_from_topk(topk_logits, topk_idx, key, temperature: float):
    """Categorical draw over pre-selected top-k rows [..., k] (descending)
    with stream keys [..., 2]: the back half of FusedSoftmaxAndSampleTopK
    (ops-inl.h:1375-1398).  Returns (token int32, prob f32) [...]."""
    lf = topk_logits.float()
    e = torch.exp(lf - lf.amax(dim=-1, keepdim=True))
    probs = e / e.sum(dim=-1, keepdim=True)
    if temperature == 0.0:
        choice = torch.zeros(probs.shape[:-1], dtype=torch.long,
                             device=probs.device)
    else:
        adj = probs
        if temperature != 1.0:
            adj = torch.pow(probs, 1.0 / temperature)
            adj = adj / adj.sum(dim=-1, keepdim=True)
        score = torch.log(adj) + gumbel(key, probs.shape[-1])
        choice = torch.argmax(score, dim=-1)
    token = topk_idx.gather(-1, choice[..., None])[..., 0]
    prob = probs.gather(-1, choice[..., None])[..., 0]
    return token.to(torch.int32), prob


def sample_from_topk(vals, idxs, keys, temperature: float):
    """Batched draw from the fused top-k head's output: vals/idxs [B, k]
    descending, keys [B, 2] per-(query, position) streams."""
    return _draw_from_topk(vals, idxs, keys, temperature)


def sample_top_k(logits, key, top_k: int, temperature: float):
    """Top-k sampling over the last axis of full logits; (token, prob)."""
    vals, idxs = top_k_sorted(logits.float(), top_k)
    return _draw_from_topk(vals, idxs, key, temperature)


def make_sampler(top_k: int, temperature: float):
    """sample(logits [B, V], keys [B, 2]) -> (tokens [B], probs [B])
    (ChooseSampleFunc, gemma/gemma.cc:459-485): top_k == 1 is the argmax."""
    if top_k == 1:
        return lambda logits, keys: top1(logits)
    return lambda logits, keys: sample_top_k(logits, keys, top_k, temperature)


def sample_stream_plain(vals, idxs, seed: int, qi, pos, temperature: float):
    """The draw kernel's function in plain PyTorch: `sample_from_topk`
    with the keys of (seed, qi[b], pos[b])."""
    return sample_from_topk(vals, idxs, sample_key(seed, qi, pos),
                            temperature)


def sample_stream(vals, idxs, seed: int, qi, pos, temperature: float):
    """(token int32 [B], prob f32 [B]) drawn from top-k rows vals f32 /
    idxs int32 [B, k] with the streams of (seed, qi[b], pos[b]); qi, pos:
    int32 [B] on the rows' device.  One kernel launch on CUDA for
    k <= 128, no host sync; the plain version on the CPU."""
    if not vals.is_cuda:
        return sample_stream_plain(vals, idxs, seed, qi, pos, temperature)
    b, k = vals.shape
    if k > MAX_DRAW_K:
        # Past the fused head's k_top the selection is composed torch ops
        # (ops/matmul.py:matmul_topk), and so is the draw on its result.
        return sample_from_topk(vals, idxs, sample_key(seed, qi, pos),
                                temperature)
    _cuda.check(vals, "vals", torch.float32, (b, k))
    _cuda.check(idxs, "idxs", torch.int32, (b, k))
    _cuda.check(qi, "qi", torch.int32, (b,))
    _cuda.check(pos, "pos", torch.int32, (b,))
    tok = torch.empty(b, dtype=torch.int32, device=vals.device)
    prob = torch.empty(b, dtype=torch.float32, device=vals.device)
    seed = int(seed)
    DRAW_TOPK.launch(vals.data_ptr(), idxs.data_ptr(), qi.data_ptr(),
                     pos.data_ptr(), _i32((seed >> 32) & 0xFFFFFFFF),
                     _i32(seed & 0xFFFFFFFF), b, float(temperature), k,
                     tok.data_ptr(), prob.data_ptr())
    return tok, prob


def _i32(word: int) -> int:
    """A 32-bit word as the signed int a C `int` parameter takes."""
    return word - (1 << 32) if word >= 1 << 31 else word
