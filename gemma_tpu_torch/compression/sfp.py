"""SFP8 "switching floating point" codec.

Re-derived from the reference's semantics (compression/sfp-inl.h, types.h:62-90):
an 8-bit hybrid of e4m3/e5m2 with

  - sign bit in the MSB, 7-bit magnitude code v,
  - v == 0        => +0        (0x80, i.e. -0, is reserved/invalid),
  - v in [1, 64)  => 2-bit mantissa, bf16 bits = 0x3400 + (v << 5),
  - v in [64,128) => 3-bit mantissa, bf16 bits = 0x3800 + (v << 4),

which gives a 24-bit dynamic range (2^-23 .. 1.875) with max value
SfpStream::kMax = 1.875 (types.h:86), no subnormals and no per-block side
information.  Magnitudes >= 2^-7 keep 3 mantissa bits, smaller ones 2.

Values above kMax are handled by a *per-tensor* scale stored next to the
tensor (util/mat.h:206-207, compression/compress.h:107-111); see
`scale_weights`.

The encoder mirrors compression/sfp-inl.h:60-159 (`EncBytes`) bit-for-bit:
truncate f32 inputs to bf16 (sfp-inl.h:478-480), then round-to-nearest-even
onto the SFP grid with carry into the exponent.  The golden vectors from
compression/sfp_test.cc:223-262 are reproduced in tests/test_sfp.py.

These numpy paths are the host (encode/convert) implementation, a copy of
gemma_tpu/compression/sfp.py's; the tensor decoder is
ops/matmul.py:sfp_decode, and the same bit arithmetic runs inside the CUDA
GEMMs (csrc/matmul.cu) on B tiles in registers.
"""

from __future__ import annotations

import numpy as np

from gemma_tpu_torch.utils.bf16 import bf16_bits_to_f32, f32_to_bf16_truncate

# Largest representable magnitude (reference types.h:86).
SFP_MAX = 1.875


def _encode_bf16_bits(bits: np.ndarray) -> np.ndarray:
    """bf16 bit patterns (uint16) -> SFP bytes (uint8).

    Bit-exact mirror of SfpCodec::EncBytes (compression/sfp-inl.h:60-159),
    operating on the hi/lo bytes of each bf16 value with 8-bit arithmetic.
    """
    bits = np.asarray(bits, dtype=np.uint16)
    hi = (bits >> 8).astype(np.uint8)
    lo = (bits & 0xFF).astype(np.uint8)

    sign = hi & 0x80
    # Biased exponent: low 7 bits of hi and the MSB of lo.
    biased_e = ((hi.astype(np.uint16) * 2 + (lo >> 7)) & 0xFF).astype(np.uint8)
    if np.any(biased_e >= 0x80):
        raise ValueError("SFP encode: input magnitude exceeds 1.875 "
                         "(apply a per-tensor scale first)")

    # Top 6 of the 7 mantissa bits (the lowest bit is deliberately dropped,
    # matching the reference's m6; sfp-inl.h:75).
    m6 = (((lo.astype(np.uint16) * 2) & 0xFF) >> 2).astype(np.uint8)

    # >= 2^-7 after considering that 1.1111*2^-8 rounds up to 1.0*2^-7.
    k_min_large_e = np.uint8(127 - 8)
    is_large_before = (biased_e > k_min_large_e) | (
        (biased_e == k_min_large_e) & (m6 > 0x3B)
    )

    m_shl4 = np.where(is_large_before, (m6.astype(np.uint16) * 2) & 0xFF, m6).astype(
        np.uint8
    )

    # Round to nearest even; +7 (not +8) compensates the dropped mantissa bit.
    odd_bit = (m_shl4 >> 4) & 1
    rounded = ((m_shl4.astype(np.uint16) + odd_bit + 7) & 0xFF).astype(np.uint8)
    carry_bit = np.where(is_large_before, np.uint8(0x80), np.uint8(0x40))
    carry_clear = rounded & ~carry_bit
    overflow = carry_clear != rounded
    biased_e = ((biased_e.astype(np.uint16) + overflow) & 0xFF).astype(np.uint8)

    k_min_normal = np.uint8(127 - 23)
    is_zero = biased_e < k_min_normal
    is_min = biased_e == k_min_normal
    is_large = biased_e > np.uint8(127 - 8)  # after rounding

    m = carry_clear >> 4
    # 1.0 * 2^-23 would encode as zero; bump to 1.01 (sfp-inl.h:141-142).
    m = np.where(is_min, np.maximum(m, 1), m).astype(np.uint8)

    e_bias = np.where(is_large, np.uint8((15 - 127) & 0xFF), np.uint8((23 - 127) & 0xFF))
    e = ((biased_e.astype(np.uint16) + e_bias) & 0xFF).astype(np.uint8)

    e_shifted = np.where(is_large, (e.astype(np.uint16) * 2) & 0xFF, e).astype(np.uint8)
    em = (m | ((e_shifted.astype(np.uint16) << 2) & 0xFF)).astype(np.uint8)
    encoded = (em & 0x7F) | sign
    return np.where(is_zero, np.uint8(0), encoded).astype(np.uint8)


def encode(values: np.ndarray) -> np.ndarray:
    """Encode f32/bf16 values (|x| <= 1.875) to SFP bytes, preserving shape."""
    values = np.asarray(values)
    if values.dtype == np.uint16:
        bits = values
    else:
        bits = f32_to_bf16_truncate(values.astype(np.float32))
    return _encode_bf16_bits(bits)


def decode_bits(codes: np.ndarray) -> np.ndarray:
    """SFP bytes -> bf16 bit patterns (uint16); numpy host path."""
    codes = np.asarray(codes, dtype=np.uint8)
    sign = (codes.astype(np.uint16) & 0x80) << 8
    v = (codes & 0x7F).astype(np.uint16)
    small = v < 64
    mag = np.where(
        v == 0,
        np.uint16(0),
        np.where(small, 0x3400 + (v << 5), 0x3800 + (v << 4)),
    ).astype(np.uint16)
    return mag | sign


def decode(codes: np.ndarray) -> np.ndarray:
    """SFP bytes -> f32 values; numpy host path."""
    return bf16_bits_to_f32(decode_bits(codes))


def scale_weights(values: np.ndarray) -> tuple[np.ndarray, float]:
    """Per-tensor scaling for inputs exceeding SFP_MAX.

    Maps `ScaleWeights` (compression/compress.h:107-111): if max |x| > kMax,
    divide by scale = max/kMax and remember the scale in the tensor metadata;
    the GEMM multiplies it back in.
    """
    max_abs = float(np.max(np.abs(values))) if values.size else 0.0
    if max_abs <= SFP_MAX:
        return np.asarray(values, dtype=np.float32), 1.0
    # Keep the scale f32-exact: it is serialized as f32 (util/mat.h:277).
    scale = float(np.float32(max_abs / SFP_MAX))
    scaled = np.asarray(values, dtype=np.float32) / np.float32(scale)
    if np.abs(scaled).max() > SFP_MAX:  # guard against f32 rounding up
        scale = float(np.nextafter(np.float32(scale), np.float32(np.inf)))
        scaled = np.asarray(values, dtype=np.float32) / np.float32(scale)
    return scaled, scale
