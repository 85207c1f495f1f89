"""Carry weights and caches into the port from plain numpy trees.

The JAX package's `Params` and `KVCache`, flattened by a caller into
nested dicts of numpy arrays, become the port's `Params` / `KVCache`
here (this module never imports the JAX package).  A weight is

    {"kind": "i8", "shape": (N, K), "scale": 1.0,
     "arrays": {"codes": i8 [N, K], "inv_scales": f32 [N, K/128],
                "zeropoints": f32 [N, K/128]}}

(kind "sfp"/"nuq" with arrays {"codes": u8 [N, K]}, kind "f32"/"bf16"
with arrays {"w": [N, K]}, kind "i4" with {"codes": u8 [N, Kp/2],
"scales", "mins": f32 [N, Kp/128]}, kind "nuq4" with {"codes": u8
[N, Kp/2], "tables": u8 [N, round_up(Kp/16, 128)]}; each with its tensor
`scale`).  JAX's layouts are taken as they are: the CUDA GEMMs read codes
and dense weights row-major, the group scales as [N, K/128] and the
tables at their padded row stride, so nothing is re-laid.  A
layer carries either "qkv_cat" or the split "qkv1"/"qkv2", and keeps
what it carries: a split pair runs as two GEMMs and the split decode
kernel, as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from gemma_tpu_torch.models.configs import ModelConfig
from gemma_tpu_torch.models.gemma import LayerParams, Params
from gemma_tpu_torch.models.kv_cache import KVCache
from gemma_tpu_torch.ops.matmul import KINDS, QuantTensor, unknown_kind
from gemma_tpu_torch.utils.basics import resolve_device


def tensor_from_numpy(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True, order="C")).to(device)


def quant_tensor_from_numpy(qt: dict, device) -> QuantTensor:
    if qt["kind"] not in KINDS:
        raise unknown_kind(qt["kind"])
    return QuantTensor(
        qt["kind"], tuple(int(s) for s in qt["shape"]), float(qt["scale"]),
        {k: tensor_from_numpy(v, device) for k, v in qt["arrays"].items()})


def params_from_numpy(tree: dict, config: ModelConfig,
                      device=None) -> Params:
    """The port's Params on `device` (CUDA unless the caller names one)."""
    device = resolve_device(device)

    def norm(a):
        return None if a is None else tensor_from_numpy(
            np.asarray(a, np.float32), device)

    def quant(lt, name):
        return None if lt.get(name) is None else quant_tensor_from_numpy(
            lt[name], device)

    layers = []
    for lt in tree["layers"]:
        layers.append(LayerParams(
            qkv1=quant(lt, "qkv1"), qkv2=quant(lt, "qkv2"),
            qkv_cat=quant(lt, "qkv_cat"), att_w=quant(lt, "att_w"),
            gating1=quant(lt, "gating1"), gating2=quant(lt, "gating2"),
            linear=quant(lt, "linear"),
            pre_att_norm=norm(lt["pre_att_norm"]),
            pre_ffw_norm=norm(lt["pre_ffw_norm"]),
            post_att_norm=norm(lt.get("post_att_norm")),
            post_ffw_norm=norm(lt.get("post_ffw_norm")),
            key_norm=norm(lt.get("key_norm")),
            query_norm=norm(lt.get("query_norm")),
        ))
    if len(layers) != len(config.layer_configs):
        raise ValueError(f"{len(layers)} layers for a "
                         f"{len(config.layer_configs)}-layer config")
    return Params(embedding=quant_tensor_from_numpy(tree["embedding"], device),
                  final_norm=norm(tree["final_norm"]), layers=layers)


def kv_cache_from_numpy(tree: dict, device=None) -> KVCache:
    """tree: kv, seq_len, kv_local, seq_len_local, layer_map, local_slack,
    kv_scale, kv_local_scale (arrays or None).  On `device`, CUDA unless
    the caller names one."""
    device = resolve_device(device)

    def arr(name):
        a = tree.get(name)
        return None if a is None else tensor_from_numpy(a, device)

    return KVCache(arr("kv"), int(tree["seq_len"]), arr("kv_local"),
                   int(tree.get("seq_len_local", 0)),
                   tuple(tuple(x) for x in tree.get("layer_map", ())),
                   int(tree.get("local_slack", 0)), arr("kv_scale"),
                   arr("kv_local_scale"))
