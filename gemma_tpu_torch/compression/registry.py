"""Type enum + codec dispatch (maps compression/types.h + compress-inl.h).

`Type` values and names are the reference's serialization ABI
(compression/types.h:222-228) and must not change.

`PackedTensor` is the host-side container for one compressed tensor: the raw
packed bytes plus (rows, cols, scale).  It replaces the reference's
type-erased MatPtr + CompressTraits pair: `compress`/`decompress` convert
between f32 and any packed type, and ops/matmul.py:quant_tensor_from_packed
turns PackedTensors into device arrays (dense, or the quantized layouts
the CUDA GEMMs read).  A copy of gemma_tpu/compression/registry.py.
"""

from __future__ import annotations

import dataclasses
import enum

import numpy as np

from gemma_tpu_torch.compression import int8, nuq, sfp
from gemma_tpu_torch.utils.bf16 import bf16_bits_to_f32, f32_to_bf16_round


class Type(enum.IntEnum):
    """Tensor storage types; values match compression/types.h:222."""

    UNKNOWN = 0
    F32 = 1
    BF16 = 2
    SFP = 3
    NUQ = 4
    F64 = 5
    U32 = 6
    U64 = 7
    I8 = 8


# Serialization names (types.h:225-226). Index = Type value.
TYPE_NAMES = ("unknown", "f32", "bf16", "sfp", "nuq", "f64", "u32", "u64", "i8")

# Bits per element (types.h:229-239). NUQ is listed as 4 (actually 4.5).
TYPE_BITS = (0, 32, 16, 8, 4, 64, 32, 64, 8)


def type_from_name(name: str) -> Type:
    return Type(TYPE_NAMES.index(name))


def packed_nbytes(type_: Type, rows: int, cols: int, stride: int | None = None) -> int:
    """Bytes of packed storage for a [rows, cols] tensor.

    NUQ/I8 are never padded (stride == cols); other types may have a row
    stride for padding (util/mat.h:96-101).
    """
    stride = cols if stride is None else stride
    num = rows * stride
    if type_ == Type.NUQ:
        assert stride == cols, "NUQ tensors must be packed"
        return nuq.packed_end(num)
    if type_ == Type.I8:
        assert stride == cols, "I8 tensors must be packed"
        return int8.packed_end(num)
    return num * TYPE_BITS[type_] // 8


@dataclasses.dataclass
class PackedTensor:
    """One compressed tensor: packed bytes + metadata (maps util/mat.h MatPtr)."""

    name: str
    type: Type
    rows: int
    cols: int
    data: np.ndarray  # uint8, the packed stream (row-major, stride == cols)
    scale: float = 1.0

    @property
    def shape(self) -> tuple[int, int]:
        return (self.rows, self.cols)

    def to_f32(self) -> np.ndarray:
        """Decode to f32 [rows, cols] (scale applied)."""
        out = decompress(self.type, self.data, self.rows * self.cols)
        out = out.reshape(self.rows, self.cols)
        if self.scale != 1.0:
            out = out * np.float32(self.scale)
        return out


def compress(type_: Type, values: np.ndarray) -> np.ndarray:
    """f32 values -> packed uint8 stream (flat)."""
    flat = np.ascontiguousarray(values, dtype=np.float32).reshape(-1)
    if type_ == Type.F32:
        return flat.view(np.uint8)
    if type_ == Type.BF16:
        return f32_to_bf16_round(flat).view(np.uint8)
    if type_ == Type.SFP:
        return sfp.encode(flat)
    if type_ == Type.NUQ:
        return nuq.encode(flat)
    if type_ == Type.I8:
        return int8.encode(flat)
    if type_ == Type.F64:
        return flat.astype(np.float64).view(np.uint8)
    raise ValueError(f"cannot compress to {type_!r}")


def decompress(type_: Type, stream: np.ndarray, num_values: int) -> np.ndarray:
    """Packed uint8 stream -> f32 values (flat, unscaled)."""
    stream = np.asarray(stream, dtype=np.uint8)
    if type_ == Type.F32:
        return stream[: num_values * 4].view(np.float32).copy()
    if type_ == Type.BF16:
        return bf16_bits_to_f32(stream[: num_values * 2].view(np.uint16))
    if type_ == Type.SFP:
        return sfp.decode(stream[:num_values])
    if type_ == Type.NUQ:
        return nuq.decode(stream, num_values)
    if type_ == Type.I8:
        return int8.decode(stream, num_values)
    if type_ == Type.F64:
        return stream[: num_values * 8].view(np.float64).astype(np.float32)
    if type_ == Type.U32:
        return stream[: num_values * 4].view(np.uint32).astype(np.float32)
    raise ValueError(f"cannot decompress {type_!r}")


def compress_tensor(
    type_: Type, name: str, values: np.ndarray, with_scale: bool = True
) -> PackedTensor:
    """Compress a 2-D f32 array, applying a per-tensor scale for SFP/NUQ.

    SFP/NUQ clamp at |x| <= 1.875, so out-of-range tensors are pre-divided by
    a scale remembered in the metadata (compress.h:107-111).  The reference
    applies this to the tensors listed in `scale_base_names`; scanning is
    equivalent and simpler.
    """
    values = np.asarray(values, dtype=np.float32)
    if values.ndim == 1:
        values = values.reshape(1, -1)
    scale = 1.0
    if with_scale and type_ in (Type.SFP, Type.NUQ):
        values, scale = sfp.scale_weights(values)
    data = compress(type_, values)
    return PackedTensor(
        name=name,
        type=type_,
        rows=values.shape[0],
        cols=values.shape[1],
        data=data,
        scale=scale,
    )
