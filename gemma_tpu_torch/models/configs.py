"""Model configurations the serving path reads (counterpart of
gemma_tpu/models/configs.py, itself transcribed from gemma/configs.{h,cc}).

Only the fields and helpers the forward pass and the engine read are
kept; the `.sbs` serialization visitors belong to a later slice.
"""

from __future__ import annotations

import dataclasses
import enum
import math

VOCAB_SIZE_GEMMA2 = 256_000


class Model(enum.IntEnum):
    """configs.h:163-181; values are the serialization ABI."""

    UNKNOWN = 0
    GEMMA2_9B = 3
    GEMMA2_27B = 4
    GEMMA2_2B = 7
    GEMMA3_4B = 14
    GEMMA3_1B = 15
    GEMMA3_12B = 16
    GEMMA3_27B = 17


class LayerAttentionType(enum.IntEnum):
    GEMMA = 0
    VIT = 1


class PostNormType(enum.IntEnum):
    NONE = 0
    SCALE = 1


class PostQKType(enum.IntEnum):
    ROPE = 0
    HALF_ROPE = 1


class QueryScaleType(enum.IntEnum):
    SQRT_KEY_SIZE = 0
    SQRT_MODEL_DIM_DIV_NUM_HEADS = 1


def is_vlm(model: Model) -> bool:
    """Gemma3 VLM-family models use a 1e6 RoPE base on global layers."""
    return model in (Model.GEMMA3_4B, Model.GEMMA3_1B, Model.GEMMA3_12B,
                     Model.GEMMA3_27B)


@dataclasses.dataclass
class LayerConfig:
    """Per-layer configuration (configs.h:240-290)."""

    model_dim: int = 0
    ff_hidden_dim: int = 0
    heads: int = 0
    kv_heads: int = 0
    qkv_dim: int = 0
    post_norm: PostNormType = PostNormType.NONE
    type: LayerAttentionType = LayerAttentionType.GEMMA
    post_qk: PostQKType = PostQKType.ROPE
    use_qk_norm: bool = False


@dataclasses.dataclass
class ModelConfig:
    """configs.h:336-484, restricted to what the serving path reads."""

    model: Model = Model.UNKNOWN
    num_layers: int = 0
    model_dim: int = 0
    vocab_size: int = 0
    max_seq_len: int = 0
    att_cap: float = 0.0
    final_cap: float = 0.0
    query_scale: QueryScaleType = QueryScaleType.SQRT_KEY_SIZE
    layer_configs: list[LayerConfig] = dataclasses.field(default_factory=list)
    attention_window_sizes: list[int] = dataclasses.field(default_factory=list)
    eos_id: int = 1
    secondary_eos_id: int = 1

    def is_global_layer(self, layer_idx: int) -> bool:
        return self.attention_window_sizes[layer_idx] == self.max_seq_len

    def is_eos(self, token: int) -> bool:
        return token in (self.eos_id, self.secondary_eos_id)

    def query_scale_value(self) -> float:
        """AttentionActivations::ChooseQueryScale (gemma/activations.h:37-44)."""
        lc = self.layer_configs[0]
        if self.query_scale == QueryScaleType.SQRT_MODEL_DIM_DIV_NUM_HEADS:
            return 1.0 / math.sqrt(self.model_dim // lc.heads)
        return 1.0 / math.sqrt(lc.qkv_dim)


def config_gemma2_2b() -> ModelConfig:
    """configs.cc Gemma2-2B: 26 layers, windows 4096/8192 alternating."""
    lc = LayerConfig(model_dim=2304, ff_hidden_dim=9216, heads=8, kv_heads=4,
                     qkv_dim=256, post_norm=PostNormType.SCALE)
    return ModelConfig(
        model=Model.GEMMA2_2B, num_layers=26, model_dim=2304,
        vocab_size=VOCAB_SIZE_GEMMA2, max_seq_len=8192, att_cap=50.0,
        final_cap=30.0, layer_configs=[dataclasses.replace(lc)
                                       for _ in range(26)],
        attention_window_sizes=[4096 if i % 2 == 0 else 8192
                                for i in range(26)],
        eos_id=1, secondary_eos_id=107)
