"""Single-file model format: config + tokenizer + tensor TOC + tensor blobs.

Wire-compatible with gemma/model_store.{h,cc}: a `.sbs` BlobStore holding

  "config":    serialized ModelConfig (io/fields format)
  "tokenizer": raw sentencepiece model proto bytes ("unavailable" for tests)
  "toc":       back-to-back serialized MatPtr records (name, type,
               element_bytes, num_elements, rows, cols, scale, stride)
  <name>:      one blob per tensor, keyed by the suffixed tensor name

Also reads the pre-2025 multi-blob format, where tensor keys carry a 1-char
type prefix and there is no config/toc (model deduced from layer count,
per-tensor scales in a "scales" f32 blob) (model_store.cc:350-439).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from gemma_tpu_torch.compression import (
    TYPE_BITS,
    PackedTensor,
    Type,
    packed_nbytes,
)
from gemma_tpu_torch.io.blob_store import BlobReader, BlobWriter
from gemma_tpu_torch.io.fields import Fields, ReadResult, Visitor, read_fields, write_fields
from gemma_tpu_torch.models.configs import (
    Model,
    ModelConfig,
    PromptWrapping,
    config_from_model,
    deduce_model,
)
from gemma_tpu_torch.models.tensor_info import TensorInfoRegistry

CONFIG_KEY = "config"
TOKENIZER_KEY = "tokenizer"
TOC_KEY = "toc"
MOCK_TOKENIZER = "unavailable"

# Pre-2025 type prefixes (model_store.cc TypePrefix).
_TYPE_PREFIX = {
    "F": Type.F32,
    "B": Type.BF16,
    "$": Type.SFP,
    "2": Type.NUQ,
    "I": Type.I8,
}


class MatPtrFields(Fields):
    """Serialized tensor metadata (util/mat.h:218-228)."""

    def __init__(self, name="", type_=Type.UNKNOWN, rows=0, cols=0, scale=1.0,
                 stride=None):
        self.name = name
        self.type = type_
        self.rows = rows
        self.cols = cols
        self.scale = scale
        self.stride = cols if stride is None else stride

    @property
    def element_bytes(self) -> int:
        # Bytes per packed element; NUQ is 1 (byte stream).
        bits = TYPE_BITS[self.type]
        return max(1, bits // 8)

    @property
    def num_elements(self) -> int:
        """Packed element count incl. NUQ/I8 group tables (mat.h:237-248)."""
        if self.type in (Type.NUQ, Type.I8):
            return packed_nbytes(self.type, self.rows, self.cols)
        return self.rows * self.stride

    def visit(self, v: Visitor) -> None:
        self.name = v.string(self.name)
        self.type = v.enum(self.type, Type)
        v.u32(self.element_bytes)
        v.u32(self.num_elements)
        self.rows = v.u32(self.rows)
        self.cols = v.u32(self.cols)
        self.scale = v.f32(self.scale)
        self.stride = v.u32(self.stride)


@dataclasses.dataclass
class TensorRecord:
    meta: MatPtrFields
    key: str  # blob key in the file


class ModelStore:
    """Reads config/tokenizer/TOC from a BlobReader (gemma/model_store.h:50)."""

    def __init__(self, reader: BlobReader,
                 wrapping: PromptWrapping | None = None,
                 tokenizer_path: str | None = None):
        self.reader = reader
        self.tokenizer_path = tokenizer_path
        self.config = self._read_config(wrapping)
        self.tensors: dict[str, TensorRecord] = {}
        if not self._read_toc():
            self._synthesize_toc()

    # --- config ---

    def _read_config(self, wrapping) -> ModelConfig:
        if CONFIG_KEY in self.reader:
            span = self.reader.read(CONFIG_KEY, np.uint32)
            config = ModelConfig()
            result = read_fields(config, span)
            if result.pos == 0:
                raise ValueError("Failed to deserialize model config")
            return config
        # Pre-2025: deduce from blob names.
        layers = set()
        has_vit = False
        for key in self.reader.keys:
            if key[:1] in _TYPE_PREFIX and "_" in key:
                try:
                    layers.add(int(key.rsplit("_", 1)[1]))
                except ValueError:
                    pass
            if "img" in key or "enc_norm" in key:
                has_vit = True
        num_layers = (max(layers) + 1) if layers else 0
        model = deduce_model(num_layers, has_vit=has_vit)
        if model == Model.UNKNOWN:
            raise ValueError(f"Cannot deduce model ({num_layers} layers)")
        weight = Type.SFP  # refined when reading tensors
        config = config_from_model(model, weight)
        if wrapping is not None:
            config.wrapping = wrapping
        return config

    # --- tokenizer ---

    def tokenizer_bytes(self) -> bytes:
        if TOKENIZER_KEY in self.reader:
            return self.reader.read(TOKENIZER_KEY).tobytes()
        if self.tokenizer_path:  # pre-2025: separate tokenizer file
            with open(self.tokenizer_path, "rb") as f:
                return f.read()
        return MOCK_TOKENIZER.encode()

    # --- TOC ---

    def _read_toc(self) -> bool:
        if TOC_KEY not in self.reader:
            return False
        span = self.reader.read(TOC_KEY, np.uint32)
        pos = 0
        while pos < len(span):
            meta = MatPtrFields()
            result: ReadResult = read_fields(meta, span, pos)
            if result.pos == 0:
                raise ValueError(f"Corrupt TOC at word {pos}")
            pos = result.pos + result.extra_u32
            if meta.name not in self.reader:
                raise ValueError(f"TOC tensor {meta.name!r} has no blob")
            self.tensors[meta.name] = TensorRecord(meta=meta, key=meta.name)
        return True

    def _synthesize_toc(self) -> None:
        """Pre-2025: derive metadata from type-prefixed blob names."""
        registry = TensorInfoRegistry(self.config)
        scales = self._read_scales()
        scale_idx = 0
        scale_bases = set(self.config.scale_base_names)
        min_bits = 1 << 30
        weight = Type.UNKNOWN
        for key in self.reader.keys:
            type_ = _TYPE_PREFIX.get(key[:1])
            if type_ is None:
                continue
            name = key[1:]
            if name == "scales":
                continue
            info = registry.find(name)
            if info is None:
                raise ValueError(f"Unknown tensor {name!r}")
            rows, cols = info.extents
            meta = MatPtrFields(name=name, type_=type_, rows=rows, cols=cols)
            base = name.rsplit("_", 1)[0] if name[-1].isdigit() else name
            if scales is not None and base in scale_bases:
                meta.scale = float(scales[scale_idx])
                scale_idx += 1
            self.tensors[name] = TensorRecord(meta=meta, key=key)
            if TYPE_BITS[type_] < min_bits:
                min_bits = TYPE_BITS[type_]
                weight = type_
        if weight != Type.UNKNOWN:
            self.config.weight = weight

    def _read_scales(self) -> np.ndarray | None:
        for key in self.reader.keys:
            if key.endswith("scales") and key[:1] in _TYPE_PREFIX:
                return self.reader.read(key, np.float32)
        return None

    # --- tensor data ---

    def read_tensor(self, name: str) -> PackedTensor | None:
        rec = self.tensors.get(name)
        if rec is None:
            return None
        data = self.reader.read(rec.key)
        m = rec.meta
        return PackedTensor(name=name, type=m.type, rows=m.rows, cols=m.cols,
                            data=data, scale=m.scale)


def write_model(path: str, config: ModelConfig,
                tensors: list[PackedTensor],
                tokenizer_proto: bytes | None = None) -> None:
    """Write a single-file `.sbs` model (maps WriteSingleFile,
    model_store.cc:449-466 + weights.cc AddTensorDataToWriter)."""
    with BlobWriter(path) as writer:
        writer.add(CONFIG_KEY, write_fields(config))
        writer.add(
            TOKENIZER_KEY,
            tokenizer_proto if tokenizer_proto else MOCK_TOKENIZER.encode(),
        )
        toc = []
        for t in tensors:
            meta = MatPtrFields(name=t.name, type_=t.type, rows=t.rows,
                                cols=t.cols, scale=t.scale)
            toc.append(write_fields(meta))
        writer.add(TOC_KEY, np.concatenate(toc))
        for t in tensors:
            writer.add(t.name, t.data)
