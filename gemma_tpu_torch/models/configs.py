"""Model configurations, wire-compatible with gemma/configs.{h,cc}
(counterpart of gemma_tpu/models/configs.py, whose enums, fields, tables
and serialization order these are).

The `visit` methods reproduce the exact serialization field order of the
reference (configs.h:244-266, 297-305, 352-387) so `ModelConfig` round-trips
against `.sbs` files written by gemma.cpp or by the JAX package.  The
canonical per-model tables are transcribed from configs.cc:43-431.  The
structs are dataclasses, so a test or a benchmark cuts a model's depth with
`dataclasses.replace`.  The ViT sub-config is carried as data: the port has
no image encoder yet.
"""

from __future__ import annotations

import dataclasses
import enum
import math

from gemma_tpu_torch.compression import TYPE_NAMES, Type
from gemma_tpu_torch.io.fields import Fields, Visitor

VOCAB_SIZE_GEMMA2 = 256_000
VOCAB_SIZE_GEMMA3 = 262_144
VOCAB_SIZE_PALIGEMMA = 256_000 + 1024 + 128  # = 257152

class PromptWrapping(enum.IntEnum):
    """configs.h:44-50."""

    GEMMA_IT = 0
    GEMMA_PT = 1
    GEMMA_VLM = 2
    PALIGEMMA = 3


class LayerAttentionType(enum.IntEnum):
    GEMMA = 0
    VIT = 1


class PostNormType(enum.IntEnum):
    NONE = 0
    SCALE = 1


class PostQKType(enum.IntEnum):
    ROPE = 0
    HALF_ROPE = 1


class ActivationType(enum.IntEnum):
    GELU = 0


class QueryScaleType(enum.IntEnum):
    SQRT_KEY_SIZE = 0
    SQRT_MODEL_DIM_DIV_NUM_HEADS = 1


class ResidualType(enum.IntEnum):
    ADD = 0


class Model(enum.IntEnum):
    """configs.h:163-181; values are the serialization ABI."""

    UNKNOWN = 0
    GEMMA2_9B = 3
    GEMMA2_27B = 4
    GEMMA2_2B = 7
    PALIGEMMA2_3B_224 = 10
    PALIGEMMA2_3B_448 = 11
    PALIGEMMA2_10B_224 = 12
    PALIGEMMA2_10B_448 = 13
    GEMMA3_4B = 14
    GEMMA3_1B = 15
    GEMMA3_12B = 16
    GEMMA3_27B = 17
    GEMMA3_270M = 18


MODEL_PREFIX = {
    Model.UNKNOWN: "unknown",
    Model.GEMMA2_2B: "gemma2-2b",
    Model.GEMMA2_9B: "9b",
    Model.GEMMA2_27B: "27b",
    Model.PALIGEMMA2_3B_224: "paligemma2-3b-224",
    Model.PALIGEMMA2_3B_448: "paligemma2-3b-448",
    Model.PALIGEMMA2_10B_224: "paligemma2-10b-224",
    Model.PALIGEMMA2_10B_448: "paligemma2-10b-448",
    Model.GEMMA3_4B: "gemma3-4b",
    Model.GEMMA3_1B: "gemma3-1b",
    Model.GEMMA3_12B: "gemma3-12b",
    Model.GEMMA3_27B: "gemma3-27b",
    Model.GEMMA3_270M: "gemma3-270m",
}

WRAPPING_SUFFIX = {
    PromptWrapping.GEMMA_IT: "-it",
    PromptWrapping.GEMMA_PT: "-pt",
    PromptWrapping.GEMMA_VLM: "-vlm",
    PromptWrapping.PALIGEMMA: "-pg",
}


def is_vlm(model: Model) -> bool:
    return model in (
        Model.GEMMA3_4B,
        Model.GEMMA3_1B,
        Model.GEMMA3_12B,
        Model.GEMMA3_27B,
    )


def is_paligemma(model: Model) -> bool:
    return model in (
        Model.PALIGEMMA2_3B_224,
        Model.PALIGEMMA2_3B_448,
        Model.PALIGEMMA2_10B_224,
        Model.PALIGEMMA2_10B_448,
    )


class InternalLayerConfig(Fields):
    def visit(self, v: Visitor) -> None:
        pass


@dataclasses.dataclass
class LayerConfig(Fields):
    """Per-layer configuration (configs.h:240-290)."""

    model_dim: int = 0
    ff_hidden_dim: int = 0
    heads: int = 0
    kv_heads: int = 0
    qkv_dim: int = 0
    ff_biases: bool = False
    optimized_gating: bool = True
    post_norm: PostNormType = PostNormType.NONE
    type: LayerAttentionType = LayerAttentionType.GEMMA
    activation: ActivationType = ActivationType.GELU
    post_qk: PostQKType = PostQKType.ROPE
    use_qk_norm: bool = False
    internal: InternalLayerConfig = dataclasses.field(
        default_factory=InternalLayerConfig)

    def visit(self, v: Visitor) -> None:
        # Field order is the serialization ABI (configs.h:244-266); the
        # unused_* fields were formerly for Griffin.
        self.model_dim = v.u32(self.model_dim)
        v.u32(0)  # unused_griffin_dim
        self.ff_hidden_dim = v.u32(self.ff_hidden_dim)
        self.heads = v.u32(self.heads)
        self.kv_heads = v.u32(self.kv_heads)
        self.qkv_dim = v.u32(self.qkv_dim)
        v.u32(0)  # unused_conv1d_width
        self.ff_biases = v.boolean(self.ff_biases)
        v.boolean(False)  # unused_softmax_attn_output_biases
        self.optimized_gating = v.boolean(self.optimized_gating)
        self.post_norm = v.enum(self.post_norm, PostNormType)
        self.type = v.enum(self.type, LayerAttentionType)
        self.activation = v.enum(self.activation, ActivationType)
        self.post_qk = v.enum(self.post_qk, PostQKType)
        self.use_qk_norm = v.boolean(self.use_qk_norm)
        self.internal.visit(v)

    @property
    def is_mha(self) -> bool:
        return self.heads == self.kv_heads

    def cache_layer_size(self) -> int:
        return self.kv_heads * self.qkv_dim * 2


@dataclasses.dataclass
class VitConfig(Fields):
    """configs.h:293-318."""

    model_dim: int = 0
    seq_len: int = 0
    num_scales: int = 0
    patch_width: int = 14
    image_size: int = 224
    pool_dim: int = 1
    layer_configs: list[LayerConfig] = dataclasses.field(default_factory=list)

    def visit(self, v: Visitor) -> None:
        self.model_dim = v.u32(self.model_dim)
        self.seq_len = v.u32(self.seq_len)
        self.num_scales = v.u32(self.num_scales)
        self.patch_width = v.u32(self.patch_width)
        self.image_size = v.u32(self.image_size)
        self.layer_configs = v.vector(self.layer_configs, LayerConfig)
        self.pool_dim = v.u32(self.pool_dim)


class InternalModelConfig(Fields):
    def visit(self, v: Visitor) -> None:
        pass


@dataclasses.dataclass
class ModelConfig(Fields):
    """configs.h:336-484."""

    model_family_version: int = 1
    display_name: str = ""
    model: Model = Model.UNKNOWN
    wrapping: PromptWrapping = PromptWrapping.GEMMA_PT
    weight: Type = Type.UNKNOWN
    num_layers: int = 0
    model_dim: int = 0
    vocab_size: int = 0
    max_seq_len: int = 0
    att_cap: float = 0.0
    final_cap: float = 0.0
    absolute_pe: bool = False
    query_scale: QueryScaleType = QueryScaleType.SQRT_KEY_SIZE
    layer_configs: list[LayerConfig] = dataclasses.field(default_factory=list)
    attention_window_sizes: list[int] = dataclasses.field(default_factory=list)
    norm_num_groups: int = 1
    vit_config: VitConfig = dataclasses.field(default_factory=VitConfig)
    pool_dim: int = 1
    eos_id: int = 1
    secondary_eos_id: int = 1
    scale_base_names: list[str] = dataclasses.field(default_factory=list)
    internal: InternalModelConfig = dataclasses.field(
        default_factory=InternalModelConfig)

    def visit(self, v: Visitor) -> None:
        self.model_family_version = v.u32(self.model_family_version)
        self.display_name = v.string(self.display_name)
        self.model = v.enum(self.model, Model)
        self.wrapping = v.enum(self.wrapping, PromptWrapping)
        self.weight = v.enum(self.weight, Type)
        self.num_layers = v.u32(self.num_layers)
        self.model_dim = v.u32(self.model_dim)
        self.vocab_size = v.u32(self.vocab_size)
        self.max_seq_len = v.u32(self.max_seq_len)
        v.u32(0)  # unused_num_tensor_scales
        self.att_cap = v.f32(self.att_cap)
        self.final_cap = v.f32(self.final_cap)
        self.absolute_pe = v.boolean(self.absolute_pe)
        v.boolean(False)  # unused_use_local_attention
        self.query_scale = v.enum(self.query_scale, QueryScaleType)
        self.layer_configs = v.vector(self.layer_configs, LayerConfig)
        self.attention_window_sizes = v.vector(self.attention_window_sizes, "u32")
        self.norm_num_groups = v.u32(self.norm_num_groups)
        v.fields(self.vit_config)
        self.pool_dim = v.u32(self.pool_dim)
        self.eos_id = v.i32(self.eos_id)
        self.secondary_eos_id = v.i32(self.secondary_eos_id)
        self.scale_base_names = v.vector(self.scale_base_names, "string")
        self.internal.visit(v)

    # --- derived helpers (configs.h:409-438) ---

    def is_global_layer(self, layer_idx: int) -> bool:
        return self.attention_window_sizes[layer_idx] == self.max_seq_len

    def is_eos(self, token: int) -> bool:
        return token in (self.eos_id, self.secondary_eos_id)

    def kv_cache_cols(self) -> int:
        return len(self.layer_configs) * self.layer_configs[0].cache_layer_size()

    def query_scale_value(self) -> float:
        """AttentionActivations::ChooseQueryScale (gemma/activations.h:37-44)."""
        lc = self.layer_configs[0]
        if self.query_scale == QueryScaleType.SQRT_MODEL_DIM_DIV_NUM_HEADS:
            return 1.0 / math.sqrt(self.model_dim // lc.heads)
        return 1.0 / math.sqrt(lc.qkv_dim)

    def specifier(self) -> str:
        """configs.cc:577-593; stable model-file naming."""
        name = MODEL_PREFIX[self.model] + "-" + TYPE_NAMES[self.weight]
        if self.wrapping not in (PromptWrapping.GEMMA_VLM, PromptWrapping.PALIGEMMA):
            name += WRAPPING_SUFFIX[self.wrapping]
        return name


# --- canonical model tables (configs.cc:35-431) ---


def _repeat_window(n: int, pattern: list[int]) -> list[int]:
    return [pattern[i % len(pattern)] for i in range(n)]


def _config_no_ssm(**kw) -> ModelConfig:
    return ModelConfig(
        scale_base_names=[
            "att_ein",
            "qkv_ein",
            "gr_lin_x_w",
            "gr_lin_y_w",
            "gr_lin_out_w",
            "gr_gate_w",
            "gating_ein",
            "linear_w",
        ],
        **kw,
    )


def _base_gemma2(**kw) -> ModelConfig:
    return _config_no_ssm(att_cap=50.0, final_cap=30.0, eos_id=1,
                          secondary_eos_id=107, **kw)


def _base_gemma3(**kw) -> ModelConfig:
    return _config_no_ssm(att_cap=0.0, final_cap=0.0, eos_id=1,
                          secondary_eos_id=106, **kw)


def _gemma2_layer(model_dim, ff, heads, kv_heads, qkv_dim) -> LayerConfig:
    return LayerConfig(
        model_dim=model_dim,
        ff_hidden_dim=ff,
        heads=heads,
        kv_heads=kv_heads,
        qkv_dim=qkv_dim,
        optimized_gating=False,
        post_norm=PostNormType.SCALE,
    )


def _gemma3_layer(model_dim, ff, heads, kv_heads, qkv_dim) -> LayerConfig:
    return LayerConfig(
        model_dim=model_dim,
        ff_hidden_dim=ff,
        heads=heads,
        kv_heads=kv_heads,
        qkv_dim=qkv_dim,
        optimized_gating=True,
        post_norm=PostNormType.SCALE,
        use_qk_norm=True,
    )


def _make(config: ModelConfig, layer: LayerConfig, num_layers: int) -> ModelConfig:
    config.num_layers = num_layers
    config.layer_configs = [
        dataclasses.replace(layer, internal=InternalLayerConfig())
        for _ in range(num_layers)]
    return config


def config_gemma2_2b() -> ModelConfig:
    c = _base_gemma2(display_name="Gemma2_2B", model=Model.GEMMA2_2B,
                     model_dim=2304, vocab_size=VOCAB_SIZE_GEMMA2,
                     max_seq_len=8192)
    _make(c, _gemma2_layer(2304, 9216, 8, 4, 256), 26)
    c.attention_window_sizes = _repeat_window(26, [4096, c.max_seq_len])
    return c


def config_gemma2_9b() -> ModelConfig:
    c = _base_gemma2(display_name="Gemma2_9B", model=Model.GEMMA2_9B,
                     model_dim=3584, vocab_size=VOCAB_SIZE_GEMMA2,
                     max_seq_len=8192)
    _make(c, _gemma2_layer(3584, 14336, 16, 8, 256), 42)
    c.attention_window_sizes = _repeat_window(42, [4096, c.max_seq_len])
    return c


def config_gemma2_27b() -> ModelConfig:
    c = _base_gemma2(display_name="Gemma2_27B", model=Model.GEMMA2_27B,
                     model_dim=4608, vocab_size=VOCAB_SIZE_GEMMA2,
                     max_seq_len=8192,
                     query_scale=QueryScaleType.SQRT_MODEL_DIM_DIV_NUM_HEADS)
    _make(c, _gemma2_layer(4608, 36864, 32, 16, 128), 46)
    c.attention_window_sizes = _repeat_window(46, [4096, c.max_seq_len])
    return c


def _vit_layer() -> LayerConfig:
    """configs.cc:136-146."""
    return LayerConfig(
        model_dim=1152,
        ff_hidden_dim=4304,
        heads=16,
        kv_heads=16,
        qkv_dim=72,
        ff_biases=True,
        type=LayerAttentionType.VIT,
    )


def _add_vit_config(c: ModelConfig, image_size: int = 224) -> None:
    """configs.cc:148-163."""
    c.vit_config.model_dim = 1152
    c.vocab_size = VOCAB_SIZE_PALIGEMMA
    c.vit_config.image_size = image_size
    c.vit_config.patch_width = 14
    num_patches = image_size // 14
    c.vit_config.seq_len = num_patches * num_patches
    for lc in c.layer_configs:
        lc.optimized_gating = False
    c.vit_config.layer_configs = [_vit_layer() for _ in range(27)]
    c.vit_config.num_scales = 4 * 27


def config_paligemma2_3b_224() -> ModelConfig:
    c = config_gemma2_2b()
    c.display_name = "PaliGemma2_3B_224"
    c.model = Model.PALIGEMMA2_3B_224
    c.wrapping = PromptWrapping.PALIGEMMA
    _add_vit_config(c)
    return c


def config_paligemma2_3b_448() -> ModelConfig:
    c = config_gemma2_2b()
    c.display_name = "PaliGemma2_3B_448"
    c.model = Model.PALIGEMMA2_3B_448
    c.wrapping = PromptWrapping.PALIGEMMA
    _add_vit_config(c, 448)
    return c


def config_paligemma2_10b_224() -> ModelConfig:
    c = config_gemma2_9b()
    c.display_name = "PaliGemma2_10B_224"
    c.model = Model.PALIGEMMA2_10B_224
    c.wrapping = PromptWrapping.PALIGEMMA
    _add_vit_config(c)
    return c


def config_paligemma2_10b_448() -> ModelConfig:
    c = config_gemma2_9b()
    c.display_name = "PaliGemma2_10B_448"
    c.model = Model.PALIGEMMA2_10B_448
    c.wrapping = PromptWrapping.PALIGEMMA
    _add_vit_config(c, 448)
    return c


def config_gemma3_270m() -> ModelConfig:
    c = _base_gemma3(display_name="Gemma3_270M", model=Model.GEMMA3_270M,
                     wrapping=PromptWrapping.GEMMA_IT, model_dim=640,
                     vocab_size=VOCAB_SIZE_GEMMA3, max_seq_len=32 * 1024)
    _make(c, _gemma3_layer(640, 2048, 4, 1, 256), 18)
    c.attention_window_sizes = _repeat_window(18, [512] * 5 + [c.max_seq_len])
    return c


def config_gemma3_1b() -> ModelConfig:
    c = _base_gemma3(display_name="Gemma3_1B", model=Model.GEMMA3_1B,
                     wrapping=PromptWrapping.GEMMA_VLM, model_dim=1152,
                     vocab_size=VOCAB_SIZE_GEMMA3, max_seq_len=32 * 1024)
    _make(c, _gemma3_layer(1152, 6912, 4, 1, 256), 26)
    c.attention_window_sizes = _repeat_window(26, [512] * 5 + [c.max_seq_len])
    return c


def _gemma3_with_vit(c: ModelConfig) -> ModelConfig:
    """configs.cc:286-302: Gemma3 >= 4B attach an 896px ViT with 4x4 pooling."""
    _add_vit_config(c, image_size=896)
    c.vocab_size = VOCAB_SIZE_GEMMA3
    c.vit_config.pool_dim = 4
    num_patches = c.vit_config.image_size // c.vit_config.patch_width
    c.vit_config.seq_len = num_patches * num_patches
    for lc in c.layer_configs:
        lc.optimized_gating = True
    return c


def config_gemma3_4b() -> ModelConfig:
    c = _base_gemma3(display_name="Gemma3_4B", model=Model.GEMMA3_4B,
                     wrapping=PromptWrapping.GEMMA_VLM, model_dim=2560,
                     vocab_size=VOCAB_SIZE_GEMMA3, max_seq_len=32 * 1024)
    _make(c, _gemma3_layer(2560, 10240, 8, 4, 256), 34)
    c.attention_window_sizes = _repeat_window(34, [1024] * 5 + [c.max_seq_len])
    return _gemma3_with_vit(c)


def config_gemma3_12b() -> ModelConfig:
    c = _base_gemma3(display_name="Gemma3_12B", model=Model.GEMMA3_12B,
                     wrapping=PromptWrapping.GEMMA_VLM, model_dim=3840,
                     vocab_size=VOCAB_SIZE_GEMMA3, max_seq_len=32 * 1024)
    _make(c, _gemma3_layer(3840, 15360, 16, 8, 256), 48)
    c.attention_window_sizes = _repeat_window(48, [1024] * 5 + [c.max_seq_len])
    return _gemma3_with_vit(c)


def config_gemma3_27b() -> ModelConfig:
    c = _base_gemma3(display_name="Gemma3_27B", model=Model.GEMMA3_27B,
                     wrapping=PromptWrapping.GEMMA_VLM, model_dim=5376,
                     vocab_size=VOCAB_SIZE_GEMMA3, max_seq_len=32 * 1024)
    _make(c, _gemma3_layer(5376, 21504, 32, 16, 128), 62)
    c.attention_window_sizes = _repeat_window(62, [1024] * 5 + [c.max_seq_len])
    return _gemma3_with_vit(c)


CONFIG_FACTORY = {
    Model.GEMMA2_2B: config_gemma2_2b,
    Model.GEMMA2_9B: config_gemma2_9b,
    Model.GEMMA2_27B: config_gemma2_27b,
    Model.PALIGEMMA2_3B_224: config_paligemma2_3b_224,
    Model.PALIGEMMA2_3B_448: config_paligemma2_3b_448,
    Model.PALIGEMMA2_10B_224: config_paligemma2_10b_224,
    Model.PALIGEMMA2_10B_448: config_paligemma2_10b_448,
    Model.GEMMA3_4B: config_gemma3_4b,
    Model.GEMMA3_1B: config_gemma3_1b,
    Model.GEMMA3_12B: config_gemma3_12b,
    Model.GEMMA3_27B: config_gemma3_27b,
    Model.GEMMA3_270M: config_gemma3_270m,
}


def config_from_model(model: Model, weight: Type = Type.UNKNOWN,
                      wrapping: PromptWrapping | None = None) -> ModelConfig:
    c = CONFIG_FACTORY[model]()
    if weight != Type.UNKNOWN:
        c.weight = weight
    if wrapping is not None:
        c.wrapping = wrapping
    return c


def get_vit_config(config: ModelConfig) -> ModelConfig:
    """Sub-config for the ViT encoder (configs.cc:165-175)."""
    vit = _config_no_ssm()
    vit.model_dim = config.vit_config.model_dim
    vit.max_seq_len = config.vit_config.seq_len
    vit.layer_configs = config.vit_config.layer_configs
    vit.pool_dim = config.vit_config.pool_dim
    vit.wrapping = config.wrapping
    vit.vocab_size = 0
    return vit


def deduce_model(num_layers: int, has_vit: bool = False,
                 is_448: bool = False) -> Model:
    """configs.cc:671-707: pre-2025 files deduce the model from layer count."""
    table = {
        18: Model.GEMMA3_270M,
        26: Model.GEMMA3_1B if has_vit else Model.GEMMA2_2B,
        27: Model.PALIGEMMA2_3B_448 if is_448 else Model.PALIGEMMA2_3B_224,
        34: Model.GEMMA3_4B,
        42: (Model.PALIGEMMA2_10B_448 if is_448 else Model.PALIGEMMA2_10B_224)
        if has_vit
        else Model.GEMMA2_9B,
        46: Model.GEMMA2_27B,
        48: Model.GEMMA3_12B,
        62: Model.GEMMA3_27B,
    }
    return table.get(num_layers, Model.UNKNOWN)
