"""Loading a `.sbs` checkpoint into the port: its own copies of the weight
codecs (gemma_tpu_torch/compression), of the file format
(gemma_tpu_torch/io, models/tensor_info.py, models/configs.py) and of the
loader (ops/matmul.py:quant_tensor_from_packed, models/gemma.py:load_params,
gemma.py:Gemma) against the JAX package's, on seeded numpy inputs and on
files the tests write themselves.

Everything here is exact: the codecs are the same numpy code, so streams,
decoded values and device arrays must agree byte for byte and f32 side
arrays to 0 ulp; either package's `write_model` gives the same file bytes;
and `load_params` gives the JAX loader's arrays for every kind_override,
for the stacked tensor names (qkv_ein, gating_ein, att_ein) and the split
ones (qkv1_w, qkv2_w, gating1_w, gating2_w, att_w)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gemma_tpu import compression as jcomp
from gemma_tpu.compression import int4 as jint4
from gemma_tpu.compression import int8 as jint8
from gemma_tpu.compression import nuq as jnuq
from gemma_tpu.compression import sfp as jsfp
from gemma_tpu.io import fields as jfields
from gemma_tpu.io.blob_store import BlobReader as JBlobReader
from gemma_tpu.io.model_store import ModelStore as JModelStore
from gemma_tpu.io.model_store import write_model as j_write_model
from gemma_tpu.models import configs as jcfg
from gemma_tpu.models.gemma import load_params as j_load_params
from gemma_tpu.models.tensor_info import TensorInfoRegistry as JRegistry
from gemma_tpu.ops import matmul as jmm
from gemma_tpu.utils import basics as jbasics
from gemma_tpu_torch import compression as tcomp
from gemma_tpu_torch.compression import int4 as tint4
from gemma_tpu_torch.compression import int8 as tint8
from gemma_tpu_torch.compression import nuq as tnuq
from gemma_tpu_torch.compression import sfp as tsfp
from gemma_tpu_torch.engine import GemmaEngine, RuntimeConfig
from gemma_tpu_torch.gemma import Gemma
from gemma_tpu_torch.io import fields as tfields
from gemma_tpu_torch.io.blob_store import BlobReader, BlobWriter
from gemma_tpu_torch.io.model_store import ModelStore, write_model
from gemma_tpu_torch.models import configs as tcfg
from gemma_tpu_torch.models.gemma import load_params
from gemma_tpu_torch.models.tensor_info import TensorInfoRegistry
from gemma_tpu_torch.ops import matmul as tmm
from gemma_tpu_torch.utils import bf16 as tbf16

torch.set_num_threads(1)


def same_bits(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (a.dtype, b.dtype,
                                                       a.shape, b.shape)
    np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))


# --- the codecs -----------------------------------------------------------


def test_bf16_helpers_match_jax():
    """Integer-arithmetic rounding against the bfloat16 numpy dtype the
    JAX package leans on: every f32 whose low half is a tie or near one,
    both signs, subnormals and infinities."""
    rng = np.random.default_rng(0)
    hi = rng.integers(0, 1 << 16, 4096).astype(np.uint32) << 16
    lows = np.array([0, 1, 0x7FFF, 0x8000, 0x8001, 0xFFFF], np.uint32)
    bits = (hi[:, None] | lows[None, :]).reshape(-1)
    bits = bits[(bits & 0x7FFFFFFF) <= 0x7F800000]  # NaNs apart
    x = bits.view(np.float32)
    same_bits(tbf16.f32_to_bf16_round(x), jbasics.f32_to_bf16_round(x))
    same_bits(tbf16.f32_to_bf16_truncate(x), jbasics.f32_to_bf16_truncate(x))
    u16 = np.arange(1 << 16, dtype=np.uint16)
    same_bits(tbf16.bf16_bits_to_f32(u16), jbasics.bf16_bits_to_f32(u16))
    nan = tbf16.f32_to_bf16_round(np.array([np.nan, -np.nan], np.float32))
    assert np.isnan(tbf16.bf16_bits_to_f32(nan)).all()


def test_sfp_codec_matches_jax():
    """Every in-range bf16 bit pattern and seeded normals: encode, decode
    and the per-tensor scaling byte for byte."""
    u16 = np.arange(1 << 16, dtype=np.uint16)
    vals = jbasics.bf16_bits_to_f32(u16)
    ok = np.abs(np.nan_to_num(vals, nan=9.0)) <= 1.875
    same_bits(tsfp.encode(u16[ok]), jsfp.encode(u16[ok]))
    codes = np.arange(256, dtype=np.uint8)
    same_bits(tsfp.decode(codes), jsfp.decode(codes))
    same_bits(tsfp.decode_bits(codes), jsfp.decode_bits(codes))
    rng = np.random.default_rng(1)
    x = rng.normal(0, 0.3, (37, 129)).astype(np.float32)
    same_bits(tsfp.encode(x), jsfp.encode(x))
    big = x * 40
    (a, sa), (b, sb) = tsfp.scale_weights(big), jsfp.scale_weights(big)
    assert sa == sb and sa > 1.0
    same_bits(a, b)
    with pytest.raises(ValueError, match="exceeds 1.875"):
        tsfp.encode(big)
    assert tsfp.SFP_MAX == jsfp.SFP_MAX


@pytest.mark.parametrize("num", [128 * 5, 128 * 3 + 17])
def test_int8_codec_matches_jax(num):
    rng = np.random.default_rng(num)
    x = rng.normal(0, 0.05, num).astype(np.float32)
    x[:128] = 0.25  # a constant group: range 0
    stream = tint8.encode(x)
    same_bits(stream, jint8.encode(x))
    assert stream.size == tint8.packed_end(num) == jint8.packed_end(num)
    same_bits(tint8.decode(stream, num), jint8.decode(stream, num))
    rows, cols = (5, 128) if num % 128 == 0 else (1, num)
    for got, want in zip(tint8.to_device_layout(stream, rows, cols),
                         jint8.to_device_layout(stream, rows, cols)):
        same_bits(got, want)


@pytest.mark.parametrize("k", [256, 384])
def test_int4_codec_matches_jax(k):
    rng = np.random.default_rng(k)
    x = rng.normal(0, 0.05, (9, k)).astype(np.float32)
    x[0] = 0.125  # constant groups: scale 0, the mean as the offset
    got, want = tint4.encode_affine(x), jint4.encode_affine(x)
    for a, b in zip(got, want):
        same_bits(a, b)
    same_bits(tint4.decode_affine(*got, k), jint4.decode_affine(*want, k))
    assert got[0].max() <= 15 and got[0].shape == (9, -(-k // 256) * 256)


@pytest.mark.parametrize("num", [512, 256 + 77])
def test_nuq_codec_matches_jax(num):
    """The dynamic-programming clusterer in numpy on two groups (one of
    them partial): stream, decode and both device layouts.  The JAX
    package takes its numpy path too when its optional C encoder is not
    built; where it is, the streams are identical by its own tests."""
    rng = np.random.default_rng(num)
    x = rng.normal(0, 0.1, num).astype(np.float32)
    stream = tnuq.encode(x)
    same_bits(stream, jnuq.encode(x))
    assert stream.size == tnuq.packed_end(num) == jnuq.packed_end(num)
    same_bits(tnuq.decode(stream, num), jnuq.decode(stream, num))
    rows, cols = (2, 256) if num == 512 else (3, 111)
    same_bits(tnuq.to_sfp_codes(stream, rows, cols),
              jnuq.to_sfp_codes(stream, rows, cols))
    for got, want in zip(tnuq.to_device_layout(stream, rows, cols),
                         jnuq.to_device_layout(stream, rows, cols)):
        same_bits(got, want)
    centers, idx = tnuq._cluster_group(x[:200])
    jc, ji = jnuq._cluster_group(x[:200])
    same_bits(centers, jc)
    same_bits(idx, ji)


@pytest.mark.parametrize("name", ["F32", "BF16", "SFP", "NUQ", "I8", "F64"])
def test_registry_matches_jax(name):
    tt, jt = tcomp.Type[name], jcomp.Type[name]
    assert int(tt) == int(jt) and tcomp.TYPE_NAMES == jcomp.TYPE_NAMES
    assert tcomp.TYPE_BITS == jcomp.TYPE_BITS
    assert tcomp.type_from_name(name.lower()) == tt
    rng = np.random.default_rng(int(tt))
    vals = rng.normal(0, 0.2, (4, 128)).astype(np.float32) * (
        20 if name in ("SFP", "NUQ") else 1)
    got = tcomp.compress_tensor(tt, "t", vals)
    want = jcomp.compress_tensor(jt, "t", vals)
    assert (got.rows, got.cols, got.scale) == (want.rows, want.cols,
                                               want.scale)
    assert (got.scale != 1.0) == (name in ("SFP", "NUQ"))
    same_bits(got.data, want.data)
    assert got.data.size == tcomp.packed_nbytes(tt, 4, 128) \
        == jcomp.packed_nbytes(jt, 4, 128)
    same_bits(got.to_f32(), want.to_f32())
    same_bits(tcomp.decompress(tt, got.data, 512),
              jcomp.decompress(jt, want.data, 512))


# --- the file format ------------------------------------------------------


@pytest.mark.parametrize("model", list(tcfg.CONFIG_FACTORY),
                         ids=lambda m: m.name)
def test_config_serializes_like_jax(model):
    """Every config factory: the same fields and the same `Fields` words
    as the JAX package's, and a read of those words gives them back."""
    mine = tcfg.CONFIG_FACTORY[model]()
    ref = jcfg.CONFIG_FACTORY[jcfg.Model(int(model))]()
    words = tfields.write_fields(mine)
    same_bits(words, jfields.write_fields(ref))
    assert mine.specifier() == ref.specifier()
    assert mine.query_scale_value() == ref.query_scale_value()
    assert mine.kv_cache_cols() == ref.kv_cache_cols()
    assert mine.num_layers == len(mine.layer_configs) == ref.num_layers
    back = tcfg.ModelConfig()
    result = tfields.read_fields(back, words)
    assert result.pos == len(words) and result.missing_fields == 0
    same_bits(tfields.write_fields(back), words)
    assert back == mine or tfields.write_fields(back).tolist() \
        == words.tolist()
    assert tcfg.config_from_model(model, tcomp.Type.SFP).weight \
        == tcomp.Type.SFP
    assert [t.name for t in tcfg.Model] == [t.name for t in jcfg.Model]


def test_config_helpers_match_jax():
    for layers, vit, big in ((18, False, False), (26, False, False),
                             (26, True, False), (27, True, True),
                             (42, True, True), (42, False, False),
                             (46, False, False), (62, False, False),
                             (5, False, False)):
        assert int(tcfg.deduce_model(layers, vit, big)) \
            == int(jcfg.deduce_model(layers, vit, big))
    pg, jpg = tcfg.config_paligemma2_3b_224(), jcfg.config_paligemma2_3b_224()
    same_bits(tfields.write_fields(tcfg.get_vit_config(pg)),
              jfields.write_fields(jcfg.get_vit_config(jpg)))
    assert tcfg.is_paligemma(pg.model) and not tcfg.is_vlm(pg.model)
    cut = dataclasses.replace(tcfg.config_gemma2_9b(), num_layers=2)
    assert cut.num_layers == 2 and cut.model_dim == 3584


def test_fields_forward_and_backward_compatible():
    """Old data under new code keeps defaults; new data under old code is
    skipped by the length prefix (the copy behaves as the original)."""
    lc = tcfg.LayerConfig(model_dim=64, heads=2, kv_heads=1, qkv_dim=32)
    words = tfields.write_fields(lc)
    short = words.copy()[:-3]
    short[0] -= 3
    back = tcfg.LayerConfig()
    res = tfields.read_fields(back, short)
    assert res.pos and res.missing_fields >= 3 and back.heads == 2
    longer = np.concatenate([words, np.array([7, 7], np.uint32)])
    longer[0] += 2
    back = tcfg.LayerConfig()
    res = tfields.read_fields(back, longer)
    assert res.extra_u32 == 2 and back.qkv_dim == 32
    jback = jcfg.LayerConfig()
    jres = jfields.read_fields(jback, longer)
    assert (jres.pos, jres.extra_u32) == (res.pos, res.extra_u32)


@pytest.mark.parametrize("factory", ["config_gemma2_2b", "config_gemma3_4b"])
def test_tensor_info_matches_jax(factory):
    mine = TensorInfoRegistry(getattr(tcfg, factory)())
    ref = JRegistry(getattr(jcfg, factory)())
    assert mine.names() == ref.names()
    for name in mine.names():
        assert mine.find(name).extents == ref.find(name).extents
    assert mine.find("nope") is None


# --- files, written by either package and read by both --------------------

MODEL_DIM, FF, HEADS, KV_HEADS, QKV, VOCAB, LAYERS = 256, 512, 2, 1, 128, 300, 2
STACKED = ("qkv_ein", "gating_ein", "att_ein", "linear_w")
SPLIT = ("qkv1_w", "qkv2_w", "gating1_w", "gating2_w", "att_w", "linear_w")
NORMS = ("pre_att_ns", "pre_ff_ns", "post_att_ns", "post_ff_ns")


def tiny_config(mod):
    lcs = [mod.LayerConfig(model_dim=MODEL_DIM, ff_hidden_dim=FF, heads=HEADS,
                           kv_heads=KV_HEADS, qkv_dim=QKV,
                           post_norm=mod.PostNormType.SCALE)
           for _ in range(LAYERS)]
    return mod.ModelConfig(
        display_name="tiny", model=mod.Model.GEMMA2_2B, num_layers=LAYERS,
        model_dim=MODEL_DIM, vocab_size=VOCAB, max_seq_len=64, att_cap=50.0,
        final_cap=30.0, layer_configs=lcs, attention_window_sizes=[16, 64],
        wrapping=mod.PromptWrapping.GEMMA_IT, eos_id=1, secondary_eos_id=107)


def tensor_values(names_kind: str, seed: int):
    """{name: f32 [rows, cols]} for the tiny model under the stacked or the
    split tensor names."""
    rng = np.random.default_rng(seed)
    registry = TensorInfoRegistry(tiny_config(tcfg))
    names = ["c_embedding", "c_final_norm"]
    for i in range(LAYERS):
        bases = (STACKED if names_kind == "stacked" else SPLIT) + NORMS
        names += [f"{b}_{i}" for b in bases]
    out = {}
    for name in names:
        rows, cols = registry.find(name).extents
        sigma = 0.1 if rows == 1 else 0.06
        out[name] = rng.normal(0, sigma, (rows, cols)).astype(np.float32)
    return out


def packed_tensors(comp, values, weight_type: str):
    tensors = []
    for name, v in values.items():
        t = comp.Type[weight_type] if v.shape[0] > 1 else comp.Type.F32
        tensors.append(comp.compress_tensor(t, name, v))
    return tensors


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """{(weight type, names): path}: SFP- and NUQ-typed files under the
    stacked names, an SFP-typed one under the split names, written by the
    port; and the SFP stacked one once more by the JAX package."""
    root = tmp_path_factory.mktemp("sbs")
    out = {}
    for wt, names, seed in (("SFP", "stacked", 1), ("NUQ", "stacked", 2),
                            ("SFP", "split", 3), ("BF16", "stacked", 4)):
        path = str(root / f"{wt}_{names}.sbs")
        write_model(path, tiny_config(tcfg),
                    packed_tensors(tcomp, tensor_values(names, seed), wt))
        out[wt, names] = path
    path = str(root / "jax_SFP_stacked.sbs")
    j_write_model(path, tiny_config(jcfg),
                  packed_tensors(jcomp, tensor_values("stacked", 1), "SFP"))
    out["jax"] = path
    return out


def test_either_writer_gives_the_same_file(files):
    with open(files["SFP", "stacked"], "rb") as f, \
            open(files["jax"], "rb") as g:
        assert f.read() == g.read()


@pytest.mark.parametrize("which", ["port_file_jax_reader",
                                   "jax_file_port_reader"])
def test_files_cross_read(files, which):
    if which == "port_file_jax_reader":
        store = JModelStore(JBlobReader(files["NUQ", "stacked"]))
        ref = ModelStore(BlobReader(files["NUQ", "stacked"]))
    else:
        store = ModelStore(BlobReader(files["jax"]))
        ref = JModelStore(JBlobReader(files["jax"]))
    assert list(store.tensors) == list(ref.tensors)
    assert store.tokenizer_bytes() == ref.tokenizer_bytes() == b"unavailable"
    same_bits(tfields.write_fields(store.config)
              if isinstance(store.config, tcfg.ModelConfig)
              else jfields.write_fields(store.config),
              tfields.write_fields(tiny_config(tcfg)))
    for name in store.tensors:
        a, b = store.read_tensor(name), ref.read_tensor(name)
        assert (int(a.type), a.rows, a.cols, a.scale) \
            == (int(b.type), b.rows, b.cols, b.scale)
        same_bits(a.data, b.data)
    assert store.read_tensor("absent") is None


def test_blob_store_round_trip(tmp_path):
    path = str(tmp_path / "blobs.sbs")
    rng = np.random.default_rng(5)
    blobs = {f"key{i}": rng.integers(0, 256, n, dtype=np.uint8)
             for i, n in enumerate((1, 255, 256, 70000))}
    with BlobWriter(path) as w:
        for k, v in blobs.items():
            w.add(k, v)
        with pytest.raises(ValueError, match="duplicate"):
            w.add("key0", b"x")
    for reader in (BlobReader(path), BlobReader(path, memmap=False),
                   JBlobReader(path)):
        assert reader.keys == list(blobs)
        for k, v in blobs.items():
            same_bits(reader.read(k), v)
            assert reader.ranges[k][0] % 256 == 0
        same_bits(reader.read_slice("key3", 100, 50), blobs["key3"][100:150])
        reader.close()
    with open(path, "r+b") as f:
        f.truncate(1000)
    with pytest.raises(ValueError):
        BlobReader(path)


def assert_same_quant(jq, tq, what):
    assert jq.kind == tq.kind, (what, jq.kind, tq.kind)
    assert tuple(jq.shape) == tuple(tq.shape), what
    assert float(jq.scale) == float(tq.scale), what
    assert set(jq.arrays) == set(tq.arrays), what
    for key, arr in jq.arrays.items():
        a, b = np.asarray(arr), tq.arrays[key]
        assert b.is_contiguous(), (what, key)
        if b.dtype == torch.bfloat16:
            a, b = a.view(np.uint16), b.view(torch.int16).numpy().view(
                np.uint16)
        else:
            b = b.numpy()
        same_bits(a, b)


def assert_same_params(jp, tp):
    assert_same_quant(jp.embedding, tp.embedding, "embedding")
    same_bits(jp.final_norm, tp.final_norm.numpy())
    assert len(jp.layers) == len(tp.layers) == LAYERS
    for i, (jl, tl) in enumerate(zip(jp.layers, tp.layers)):
        assert jl.qkv1 is None and jl.qkv2 is None
        for name in ("qkv_cat", "att_w", "gating1", "gating2", "linear"):
            assert_same_quant(getattr(jl, name), getattr(tl, name),
                              f"{name}_{i}")
        for name in ("pre_att_norm", "pre_ffw_norm", "post_att_norm",
                     "post_ffw_norm"):
            same_bits(getattr(jl, name), getattr(tl, name).numpy())
        assert tl.key_norm is None and tl.query_norm is None


LOADS = [("SFP", "stacked", None), ("SFP", "stacked", "i8"),
         ("SFP", "stacked", "i4"), ("SFP", "stacked", "bf16"),
         ("NUQ", "stacked", None), ("NUQ", "stacked", "nuq4"),
         ("NUQ", "stacked", "i4"), ("NUQ", "stacked", "i8"),
         ("SFP", "split", None), ("SFP", "split", "i8"),
         ("SFP", "split", "i4"), ("BF16", "stacked", None),
         ("BF16", "stacked", "f32"), ("BF16", "stacked", "i4")]


@pytest.mark.parametrize("wt,names,override", LOADS,
                         ids=[f"{w}-{n}-{o}" for w, n, o in LOADS])
def test_load_params_matches_jax_loader(files, wt, names, override):
    """The same file through both loaders: kinds, shapes, scales and every
    array equal (bytes exact, f32 side arrays to 0 ulp)."""
    path = files[wt, names]
    jp = j_load_params(JModelStore(JBlobReader(path)), kind_override=override)
    tp = load_params(ModelStore(BlobReader(path)), kind_override=override,
                     device="cpu")
    assert_same_params(jp, tp)
    want_kind = override or {"SFP": "sfp", "NUQ": "nuq", "BF16": "bf16"}[wt]
    assert tp.embedding.kind == tp.layers[0].linear.kind == want_kind
    if override == "nuq4":
        # 128-wide heads: the 256-blocks do not survive att_ein's
        # permutation, so att_w loads as kind nuq beside nuq4 all else.
        assert tp.layers[0].att_w.kind == "nuq"
        assert tp.layers[0].qkv_cat.arrays["tables"].shape[1] == 128


def test_load_params_rejects_what_it_cannot_transcode(files):
    store = ModelStore(BlobReader(files["SFP", "stacked"]))
    with pytest.raises(ValueError, match="from a SFP stream"):
        load_params(store, kind_override="nuq4", device="cpu")
    with pytest.raises(ValueError, match="one of"):
        load_params(store, kind_override="i5", device="cpu")


@pytest.mark.parametrize("override", [None, "i4"])
def test_gemma_facade_loads_and_generates(files, override):
    """Gemma.load -> engine: tokens equal the engine's on the loader's
    params and, for the sfp file, the JAX facade's engine on the same file
    (greedy, the margins of this random model are wide)."""
    path = files["SFP", "stacked"]
    rt = RuntimeConfig(seq_len=64)
    g = Gemma.load(path, kind_override=override, runtime=rt, device="cpu")
    assert g.runtime is rt and g.config.model_dim == MODEL_DIM
    assert g.config.wrapping == tcfg.PromptWrapping.GEMMA_IT
    prompt = [2, 17, 45, 99, 120]
    out = g.generate(prompt, max_generated_tokens=5)
    params = load_params(ModelStore(BlobReader(path)), override, "cpu")
    ref = GemmaEngine(params, g.config, RuntimeConfig(seq_len=64),
                      device="cpu").generate_batch([prompt],
                                                   max_generated_tokens=5)
    assert out == ref[0] and len(out) == 5
    assert g.generate_batch([prompt, prompt[:3]],
                            max_generated_tokens=2)[0] == out[:2]
    cache = g.new_cache(2, seq_len=32)
    assert cache.kv.shape[0] == 2 or cache.kv.shape[1] == 2
    for call in (lambda: g.generate_text("hi"), lambda: g.chat("hi")):
        with pytest.raises(NotImplementedError, match="frontends slice"):
            call()
    if override is None:
        from gemma_tpu.engine import GemmaEngine as JEngine
        from gemma_tpu.engine import RuntimeConfig as JRuntime

        store = JModelStore(JBlobReader(path))
        jeng = JEngine(j_load_params(store), store.config,
                       JRuntime(seq_len=64, verbosity=0))
        assert jeng.generate_batch([prompt], max_generated_tokens=5)[0] == out


def test_gemma_save_round_trips(files, tmp_path):
    g = Gemma.load(files["NUQ", "stacked"], device="cpu")
    out = str(tmp_path / "saved.sbs")
    g.save(out)
    with open(out, "rb") as f, open(files["NUQ", "stacked"], "rb") as h:
        assert f.read() == h.read()
    store = JModelStore(JBlobReader(out))
    assert_same_params(j_load_params(store, kind_override="nuq4"),
                       Gemma.load(out, kind_override="nuq4",
                                  device="cpu").params)
    bare = Gemma(g.config, g.params, device="cpu")
    with pytest.raises(ValueError, match="store-backed"):
        bare.save(out)


@pytest.mark.parametrize("entry", ["gemma_load", "load_params", "from_packed",
                                   "quant_i4"])
def test_loader_entry_points_default_to_cuda(files, entry):
    """Every loading entry point lands on CUDA unless the caller names a
    device, and raises when CUDA is absent."""
    path = files["SFP", "stacked"]
    pt = ModelStore(BlobReader(path)).read_tensor("linear_w_0")
    make = {
        "gemma_load": lambda dev: Gemma.load(path, device=dev).params
        .final_norm,
        "load_params": lambda dev: load_params(
            ModelStore(BlobReader(path)), device=dev).embedding.arrays["codes"],
        "from_packed": lambda dev: tmm.quant_tensor_from_packed(
            pt, device=dev).arrays["codes"],
        "quant_i4": lambda dev: tmm.quant_tensor_i4(
            np.zeros((8, 256), np.float32), dev).arrays["scales"],
    }[entry]
    assert make("cpu").device.type == "cpu"
    if torch.cuda.is_available():
        assert make(None).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make(None)


@pytest.mark.parametrize("kind", [None, "f32", "bf16", "i8", "i4"])
def test_quant_tensor_from_packed_matches_jax(kind):
    """One SFP-typed tensor with a tensor scale through every transcode,
    and the loaded tensor multiplies like the JAX one."""
    rng = np.random.default_rng(11)
    vals = rng.normal(0, 1.2, (24, 256)).astype(np.float32)
    jpt = jcomp.compress_tensor(jcomp.Type.SFP, "w", vals)
    tpt = tcomp.compress_tensor(tcomp.Type.SFP, "w", vals)
    assert tpt.scale == jpt.scale != 1.0
    jq = jmm.quant_tensor_from_packed(jpt, kind)
    tq = tmm.quant_tensor_from_packed(tpt, kind, "cpu")
    assert_same_quant(jq, tq, kind)
    a = rng.normal(0, 1, (3, 256)).astype(np.float32)
    want = jmm.matmul(jnp.asarray(a).astype(jnp.bfloat16), jq, interpret=True)
    got = tmm.matmul(torch.from_numpy(a).to(torch.bfloat16), tq)
    err = np.abs(got.numpy() - np.asarray(want)).max()
    assert err <= 1e-5 * np.abs(np.asarray(want)).max()
