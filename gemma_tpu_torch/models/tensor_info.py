"""Tensor name -> shape registry (maps gemma/tensor_info.{h,cc}).

Tensor names are the `.sbs` blob-key ABI: base name plus `_<layer>` suffix
(tensor_info.h:81-83).  Shapes here are the *2-D collapsed* extents used for
storage: rows = shape[0], cols = product of the rest when
`cols_take_extra_dims`, else shape[-1] (tensor_info.h ExtentsFromInfo).

Only the fields needed for loading/exporting are kept; source_names (for the
safetensors converter) live in models/export.py.
"""

from __future__ import annotations

import dataclasses

from gemma_tpu_torch.models.configs import LayerAttentionType, ModelConfig


@dataclasses.dataclass
class TensorInfo:
    name: str
    shape: tuple[int, ...]
    cols_take_extra_dims: bool = False

    @property
    def extents(self) -> tuple[int, int]:
        """Collapse ND shape to 2-D (rows, cols) like ExtentsFromInfo."""
        if not self.shape:
            return (0, 0)
        if len(self.shape) == 1:
            return (1, self.shape[0])
        if self.cols_take_extra_dims:
            cols = 1
            for d in self.shape[1:]:
                cols *= d
            return (self.shape[0], cols)
        rows = 1
        for d in self.shape[:-1]:
            rows *= d
        return (rows, self.shape[-1])


def layer_suffix(layer_idx: int) -> str:
    return f"_{layer_idx}"


class TensorInfoRegistry:
    """All tensors for a model config, addressable by suffixed name."""

    def __init__(self, config: ModelConfig):
        self._by_name: dict[str, TensorInfo] = {}
        self._add_model_tensors(config)
        for i, lc in enumerate(config.layer_configs):
            self._add_layer_tensors(config, lc, i)
        for i, lc in enumerate(config.vit_config.layer_configs):
            self._add_image_layer_tensors(config, lc, i)

    def _add(self, suffix: str, info: TensorInfo) -> None:
        info = dataclasses.replace(info, name=info.name + suffix)
        assert info.name not in self._by_name, info.name
        self._by_name[info.name] = info

    def find(self, name: str) -> TensorInfo | None:
        return self._by_name.get(name)

    def names(self) -> list[str]:
        return list(self._by_name)

    # --- tensor tables (tensor_info.cc:29-445) ---

    def _add_model_tensors(self, c: ModelConfig) -> None:
        vit_dim = c.vit_config.model_dim
        self._add("", TensorInfo("c_embedding", (c.vocab_size, c.model_dim)))
        self._add("", TensorInfo("c_final_norm", (c.model_dim,)))
        self._add("", TensorInfo("enc_norm_bias", (vit_dim,)))
        self._add("", TensorInfo("enc_norm_scale", (vit_dim,)))
        self._add("", TensorInfo("img_emb_bias", (vit_dim,)))
        self._add(
            "",
            TensorInfo(
                "img_emb_kernel",
                (vit_dim, c.vit_config.patch_width, c.vit_config.patch_width, 3),
                cols_take_extra_dims=True,
            ),
        )
        self._add("", TensorInfo("img_head_bias", (c.model_dim,)))
        self._add("", TensorInfo("img_head_kernel", (c.model_dim, vit_dim)))
        self._add("", TensorInfo("img_pos_emb", (c.vit_config.seq_len, vit_dim)))
        self._add("", TensorInfo("mm_embed_norm", (vit_dim,)))

    def _add_layer_tensors(self, c: ModelConfig, lc, layer_idx: int) -> None:
        s = layer_suffix(layer_idx)
        heads, kv_heads, qkv_dim = lc.heads, lc.kv_heads, lc.qkv_dim
        self._add(s, TensorInfo("key_norm", (qkv_dim,)))
        self._add(s, TensorInfo("query_norm", (qkv_dim,)))
        self._add(s, TensorInfo("qkv1_w", (heads * qkv_dim, c.model_dim)))
        self._add(s, TensorInfo("qkv2_w", (2 * kv_heads * qkv_dim, c.model_dim)))
        self._add(s, TensorInfo("q_ein", (lc.model_dim, lc.model_dim)))
        self._add(s, TensorInfo("k_ein", (qkv_dim, lc.model_dim)))
        self._add(s, TensorInfo("v_ein", (qkv_dim, lc.model_dim)))
        self._add(
            s,
            TensorInfo("qkv_ein", ((heads + 2 * kv_heads) * qkv_dim, c.model_dim)),
        )
        self._add(s, TensorInfo("attn_ob", (c.model_dim,)))
        self._add(s, TensorInfo("gating_ein", (2, lc.ff_hidden_dim, c.model_dim)))
        self._add(s, TensorInfo("gating1_w", (lc.ff_hidden_dim, c.model_dim)))
        self._add(s, TensorInfo("gating2_w", (lc.ff_hidden_dim, c.model_dim)))
        self._add(s, TensorInfo("linear_w", (c.model_dim, lc.ff_hidden_dim)))
        self._add(s, TensorInfo("pre_att_ns", (c.model_dim,)))
        self._add(s, TensorInfo("pre_ff_ns", (c.model_dim,)))
        self._add(s, TensorInfo("post_att_ns", (c.model_dim,)))
        self._add(s, TensorInfo("post_ff_ns", (c.model_dim,)))
        self._add(s, TensorInfo("ffw_gat_b", (2 * lc.ff_hidden_dim,)))
        self._add(s, TensorInfo("ffw_out_b", (c.model_dim,)))
        # att_ein: [heads, model_dim, qkv_dim] stored as rows=heads*model_dim.
        self._add(s, TensorInfo("att_ein", (heads, c.model_dim, qkv_dim)))
        # att_w: transposed for the GEMM, [model_dim, heads * qkv_dim].
        self._add(
            s,
            TensorInfo("att_w", (c.model_dim, heads, qkv_dim),
                       cols_take_extra_dims=True),
        )

    def _add_image_layer_tensors(self, c: ModelConfig, lc, layer_idx: int) -> None:
        s = layer_suffix(layer_idx)
        vit_dim = c.vit_config.model_dim
        heads, qkv_dim, ff = lc.heads, lc.qkv_dim, lc.ff_hidden_dim
        self._add(
            s,
            TensorInfo("attn_out_w", (vit_dim, heads, qkv_dim),
                       cols_take_extra_dims=True),
        )
        self._add(s, TensorInfo("attn_out_b", (vit_dim,)))
        self._add(s, TensorInfo("q_ein_w", (heads, qkv_dim, vit_dim)))
        self._add(s, TensorInfo("k_ein_w", (heads, qkv_dim, vit_dim)))
        self._add(s, TensorInfo("v_ein_w", (heads, qkv_dim, vit_dim)))
        self._add(s, TensorInfo("qkv_ein_w", (heads, 3 * qkv_dim, vit_dim)))
        self._add(s, TensorInfo("q_ein_b", (heads, qkv_dim)))
        self._add(s, TensorInfo("k_ein_b", (lc.kv_heads, qkv_dim)))
        self._add(s, TensorInfo("v_ein_b", (lc.kv_heads, qkv_dim)))
        self._add(s, TensorInfo("qkv_ein_b", (heads + lc.kv_heads * 2, qkv_dim)))
        self._add(s, TensorInfo("linear_0_w", (ff, vit_dim)))
        self._add(s, TensorInfo("linear_0_b", (ff,)))
        self._add(s, TensorInfo("linear_1_w", (vit_dim, ff)))
        self._add(s, TensorInfo("linear_1_b", (vit_dim,)))
        self._add(s, TensorInfo("ln_0_bias", (vit_dim,)))
        self._add(s, TensorInfo("ln_0_scale", (vit_dim,)))
        self._add(s, TensorInfo("ln_1_bias", (vit_dim,)))
        self._add(s, TensorInfo("ln_1_scale", (vit_dim,)))
