"""I4: groupwise affine 4-bit serving codec (device layout only).

The reference's 4.5-bit format is NUQ (compression/nuq-inl.h:52-250):
per-256-group k-means tables + 4-bit indices, which needs a table lookup
in the GEMM inner loop.  This module is the lookup-free alternative at the
same 4.5 bits/value: per-128-group *affine* quantization

    w = scale_g * code + min_g,  code in 0..15,

dequantized like the i8 layout: the raw codes feed the tensor cores and the
group affine distributes over the dot at the *output*:

    out += scale_g * dot(A_g, C_g) + min_g * sum(A_g)

(ops/matmul.py kind "i4"), so per-element work is a nibble unpack and
nothing else.  A copy of gemma_tpu/compression/int4.py (numpy only).  There is no stream format: like
`--kind i8`, any stream codec (SFP/NUQ/I8/BF16) is transcoded to this
layout at load time; the `.sbs` file at rest stays bit-exact.

Footprint: 4 bits of codes + 2 f32 per 128 values = exactly 4.5 bits.

Encoder: per-group min/max grid, then 2 rounds of alternating
re-fit/re-round — with codes fixed, the SNR-optimal (scale, min) is the
least-squares line through (code, value), which typically buys ~1 dB over
the plain min/max grid.  Fully vectorized, deterministic.
"""

from __future__ import annotations

import numpy as np

from gemma_tpu_torch.utils.basics import round_up

GROUP_SIZE = 128
# Codes pack two-per-byte in the split-halves layout shared with nuq4
# (ops/matmul.py:pack_nuq4): byte chunk c holds elements c*256+j (lo
# nibble) and c*256+128+j (hi), so one 128-byte chunk unpacks into the
# two 128-wide quant groups 2c and 2c+1.
PACK_BLOCK = 2 * GROUP_SIZE


def _fit_groups(x: np.ndarray, codes: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Per-group least-squares (scale, min) for fixed codes.

    x, codes: [..., G, GROUP_SIZE] f32.  Degenerate groups (all codes
    equal) keep scale=0 and take the group mean as the offset — exact for
    constant groups.
    """
    c = codes
    n = np.float32(x.shape[-1])
    sc = c.sum(-1)
    sx = x.sum(-1)
    scc = (c * c).sum(-1)
    scx = (c * x).sum(-1)
    den = n * scc - sc * sc
    safe = den > 0
    scale = np.where(safe, (n * scx - sc * sx) / np.where(safe, den, 1.0), 0.0)
    mins = (sx - scale * sc) / n
    return scale.astype(np.float32), mins.astype(np.float32)


def encode_affine(
    values: np.ndarray, refine_iters: int = 2
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """f32 [N, K] -> (codes u8 [N, Kp] UNPACKED, scales f32 [N, G], mins).

    Kp = round_up(K, 256); G = Kp / 128.  Padding columns encode as 0s and
    never contribute (the matmul zero-pads A there).
    """
    v = np.ascontiguousarray(values, np.float32)
    n, k = v.shape
    kp = round_up(k, PACK_BLOCK)
    x = np.zeros((n, kp), np.float32)
    x[:, :k] = v
    g = kp // GROUP_SIZE
    xg = x.reshape(n, g, GROUP_SIZE)

    lo = xg.min(-1)
    hi = xg.max(-1)
    scale = (hi - lo) / np.float32(15.0)
    mins = lo

    def _round(scale, mins):
        s = np.where(scale != 0.0, scale, 1.0)[..., None]
        q = np.rint((xg - mins[..., None]) / s)
        return np.clip(q, 0.0, 15.0).astype(np.float32)

    codes = _round(scale, mins)
    for _ in range(refine_iters):
        scale, mins = _fit_groups(xg, codes)
        codes = _round(scale, mins)
    # Final fit so (scale, min) are optimal for the SHIPPED codes.
    scale, mins = _fit_groups(xg, codes)
    return (codes.reshape(n, kp).astype(np.uint8), scale.astype(np.float32),
            mins.astype(np.float32))


def decode_affine(
    codes: np.ndarray, scales: np.ndarray, mins: np.ndarray, k: int
) -> np.ndarray:
    """(codes u8 [N, Kp] unpacked, scales/mins [N, G]) -> f32 [N, k]."""
    n, kp = codes.shape
    g = scales.shape[1]
    c = codes.reshape(n, g, kp // g).astype(np.float32)
    out = scales[:, :, None] * c + mins[:, :, None]
    return out.reshape(n, kp)[:, :k]
