"""I8: groupwise asymmetric int8 codec.

Stream format (compression/types.h:92-110, int-inl.h:51-330): values are
grouped in chunks of GROUP_SIZE=128 along the flat element order; each group
occupies 132 bytes:

    [2 bytes] bf16 inv_scale
    [2 bytes] bf16 zeropoint
    [128 bytes] int8 quantized values

Quantize (int-inl.h:232-330 `QuantizeGroup`):
    range     = max - min   (1.0 if zero)
    scale_f   = 255 / range
    zeropoint = float(int32(-scale_f * min - 128))
    q         = sat_i8(round_nearest(bf16(scale_f) * x + bf16(zeropoint)))
with the bf16-rounded scale/zeropoint used for the quantization itself.

Dequantize (int-inl.h:63-146): x = inv_scale * q - zeropoint * inv_scale,
computed in f32 with inv_scale/zeropoint promoted from bf16.

A copy of gemma_tpu/compression/int8.py (numpy only).
"""

from __future__ import annotations

import numpy as np

from gemma_tpu_torch.utils.bf16 import bf16_bits_to_f32, f32_to_bf16_round

GROUP_SIZE = 128
GROUP_BYTES = 4 + GROUP_SIZE  # 132


def packed_end(num_values: int) -> int:
    """Total stream bytes (types.h:101-106)."""
    num_groups = -(-num_values // GROUP_SIZE)
    return 2 * 2 * num_groups + num_values


def _round_half_away_like_nearestint(x: np.ndarray) -> np.ndarray:
    # hn::NearestInt rounds to nearest, ties to even (x86 default mode).
    return np.rint(x)


def encode(values: np.ndarray) -> np.ndarray:
    """Encode flat f32 values into an I8 byte stream."""
    flat = np.ascontiguousarray(values, dtype=np.float32).reshape(-1)
    num = flat.shape[0]
    num_groups = -(-num // GROUP_SIZE)
    out = np.zeros(num_groups * GROUP_BYTES, dtype=np.uint8)
    # The stream is laid out group-contiguously but the final group may be
    # short; match the reference, which still reserves header+g_num bytes.
    write_pos = 0
    for g in range(num_groups):
        seg = flat[g * GROUP_SIZE : min((g + 1) * GROUP_SIZE, num)]
        min_v = float(seg.min())
        max_v = float(seg.max())
        rng = max_v - min_v
        if rng == 0.0:
            rng = 1.0
        scale_f = np.float32(255.0 / rng)
        zeropoint_f = np.float32(np.int32(-scale_f * np.float32(min_v) - 128.0))

        scale_bf = f32_to_bf16_round(np.array([scale_f]))
        inv_scale_bf = f32_to_bf16_round(np.array([1.0 / scale_f], np.float32))
        zp_bf = f32_to_bf16_round(np.array([zeropoint_f]))

        mul = bf16_bits_to_f32(scale_bf)[0]
        add = bf16_bits_to_f32(zp_bf)[0]
        q = _round_half_away_like_nearestint(mul * seg + add)
        q = np.clip(q, -128, 127).astype(np.int8)

        base = g * GROUP_BYTES
        out[base : base + 2] = inv_scale_bf.view(np.uint8)
        out[base + 2 : base + 4] = zp_bf.view(np.uint8)
        out[base + 4 : base + 4 + seg.shape[0]] = q.view(np.uint8)
        write_pos = base + 4 + seg.shape[0]
    return out[:write_pos] if num % GROUP_SIZE else out


def decode(stream: np.ndarray, num_values: int) -> np.ndarray:
    """Decode an I8 byte stream back to f32 values."""
    stream = np.asarray(stream, dtype=np.uint8)
    num_groups = -(-num_values // GROUP_SIZE)
    out = np.empty(num_values, dtype=np.float32)
    for g in range(num_groups):
        base = g * GROUP_BYTES
        inv_scale = bf16_bits_to_f32(stream[base : base + 2].view(np.uint16))[0]
        zp = bf16_bits_to_f32(stream[base + 2 : base + 4].view(np.uint16))[0]
        g_num = min(num_values - g * GROUP_SIZE, GROUP_SIZE)
        q = stream[base + 4 : base + 4 + g_num].view(np.int8).astype(np.float32)
        out[g * GROUP_SIZE : g * GROUP_SIZE + g_num] = inv_scale * q - zp * inv_scale
    return out


def to_device_layout(
    stream: np.ndarray, rows: int, cols: int
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Convert an I8 stream into the GEMMs' device layout.

    Returns (codes, inv_scales, zeropoints):
      codes:       i8  [rows, cols]
      inv_scales:  f32 [rows, ceil(cols/128)]  (bf16-exact values)
      zeropoints:  f32 [rows, ceil(cols/128)]  (bf16-exact values)

    In-kernel dequant: x = inv_scale * (codes - zeropoint), matching the
    reference's x = inv*q - zp*inv (int-inl.h:85-89).  Both scalars are
    bf16 in the stream, so they survive bf16-precision broadcast matmuls
    exactly.  cols % 128 == 0 holds for all Gemma configs; otherwise groups
    span rows and we re-encode per aligned block.
    """
    num = rows * cols
    if cols % GROUP_SIZE == 0:
        stream = np.asarray(stream, dtype=np.uint8)
        g_per_row = cols // GROUP_SIZE
        grp = stream[: rows * g_per_row * GROUP_BYTES].reshape(
            rows, g_per_row, GROUP_BYTES
        )
        inv_scales = bf16_bits_to_f32(
            grp[:, :, 0:2].copy().view(np.uint16)[..., 0]
        ).astype(np.float32)
        zp = bf16_bits_to_f32(grp[:, :, 2:4].copy().view(np.uint16)[..., 0]).astype(
            np.float32
        )
        codes = grp[:, :, 4:].reshape(rows, cols).view(np.int8)
        return codes, inv_scales, zp

    values = decode(stream, num).reshape(rows, cols)
    padded_cols = -(-cols // GROUP_SIZE) * GROUP_SIZE
    tmp = np.zeros((rows, padded_cols), np.float32)
    tmp[:, :cols] = values
    restream = encode(tmp.reshape(-1))
    codes, inv_scales, zp = to_device_layout(restream, rows, padded_cols)
    return codes[:, :cols], inv_scales, zp
