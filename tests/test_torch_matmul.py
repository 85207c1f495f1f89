"""The port's i8 GEMMs (gemma_tpu_torch/ops/matmul.py, plain path) vs the
JAX package's `matmul` / `gated_ffn` (Pallas kernels in interpret mode on
CPU, as the JAX suite runs them), on the same numpy-made i8 weights.

Also holds the helpers the other port tests share: i8 (and sfp, nuq,
bf16, f32) weights made with numpy in the JAX layout, reduced Gemma2-shaped configs for both packages,
and the flattening of JAX `Params` into the numpy tree that
gemma_tpu_torch/models/bridge.py reads.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gemma_tpu.models import configs as jcfg
from gemma_tpu.models.gemma import LayerParams as JLayerParams
from gemma_tpu.models.gemma import Params as JParams
from gemma_tpu.ops import matmul as jmm
from gemma_tpu_torch.models import bridge
from gemma_tpu_torch.models import configs as tcfg
from gemma_tpu_torch.ops import matmul as tmm

torch.set_num_threads(1)


# --- shared helpers -------------------------------------------------------


def i8_arrays(rng, n, k, zp_sigma=2.0):
    """i8 codes + group scales in the JAX layout, scaled so the dequantized
    weights have std ~1/sqrt(k) (activations stay O(1) through a stack)."""
    g = k // 128
    return {
        "codes": rng.integers(-128, 127, (n, k), dtype=np.int8),
        "inv_scales": (rng.uniform(0.5, 1.5, (n, g))
                       / (64.0 * np.sqrt(k))).astype(np.float32),
        "zeropoints": rng.normal(0, zp_sigma, (n, g)).astype(np.float32),
    }


def jax_qt(arrays, scale=1.0):
    n, k = arrays["codes"].shape
    return jmm.QuantTensor("i8", (n, k), scale,
                           {key: jnp.asarray(v) for key, v in arrays.items()})


def torch_qt(arrays, scale=1.0):
    n, k = arrays["codes"].shape
    return tmm.QuantTensor("i8", (n, k), scale,
                           {key: torch.from_numpy(v.copy())
                            for key, v in arrays.items()})


def small_configs(num_layers=2, model_dim=256, heads=4, kv_heads=2,
                  qkv_dim=128, ff=512, vocab=512, seq=64, windows=(16, 64)):
    """A reduced Gemma2-shaped config for both packages (post-norms, caps,
    GQA, alternating local/global windows)."""
    common = dict(model_dim=model_dim, ff_hidden_dim=ff, heads=heads,
                  kv_heads=kv_heads, qkv_dim=qkv_dim)
    wins = [windows[i % len(windows)] for i in range(num_layers)]
    jc = jcfg.ModelConfig(
        model=jcfg.Model.GEMMA2_2B, model_dim=model_dim, vocab_size=vocab,
        max_seq_len=seq, num_layers=num_layers, att_cap=50.0, final_cap=30.0,
        query_scale=jcfg.QueryScaleType.SQRT_KEY_SIZE, eos_id=1,
        secondary_eos_id=107)
    jc.layer_configs = [jcfg.LayerConfig(
        post_norm=jcfg.PostNormType.SCALE, **common)
        for _ in range(num_layers)]
    jc.attention_window_sizes = list(wins)
    tc = tcfg.ModelConfig(
        model=tcfg.Model.GEMMA2_2B, num_layers=num_layers,
        model_dim=model_dim, vocab_size=vocab, max_seq_len=seq, att_cap=50.0,
        final_cap=30.0, layer_configs=[tcfg.LayerConfig(
            post_norm=tcfg.PostNormType.SCALE, **common)
            for _ in range(num_layers)],
        attention_window_sizes=list(wins), eos_id=1, secondary_eos_id=107)
    return jc, tc


def jax_i8_params(config, rng):
    """JAX Params with numpy-made i8 weights, qkv row-concatenated."""
    d = config.model_dim

    def norm(n):
        return jnp.asarray(rng.normal(0, 0.1, (n,)).astype(np.float32))

    layers = []
    for lc in config.layer_configs:
        h, kvh, q, ff = lc.heads, lc.kv_heads, lc.qkv_dim, lc.ff_hidden_dim
        layers.append(JLayerParams(
            qkv1=None, qkv2=None,
            qkv_cat=jax_qt(i8_arrays(rng, (h + 2 * kvh) * q, d)),
            att_w=jax_qt(i8_arrays(rng, d, h * q)),
            gating1=jax_qt(i8_arrays(rng, ff, d)),
            gating2=jax_qt(i8_arrays(rng, ff, d)),
            linear=jax_qt(i8_arrays(rng, d, ff)),
            pre_att_norm=norm(d), pre_ffw_norm=norm(d),
            post_att_norm=norm(d), post_ffw_norm=norm(d),
            key_norm=None, query_norm=None))
    emb = i8_arrays(rng, config.vocab_size, d)
    # Embedding rows of std ~0.25, so the tied logits head stays below the
    # final soft cap (the dequant scale above targets GEMMs).
    emb["inv_scales"] *= np.float32(16.0 * np.sqrt(d) / 74.0)
    return JParams(embedding=jax_qt(emb), final_norm=norm(d), layers=layers)


def jax_kind_qt(rng, n, k, kind, rms=None):
    """A JAX QuantTensor of kind sfp, nuq, bf16 or f32 with numpy-made
    weights of rms `rms` (1/sqrt(k) by default): random SFP bytes sized by
    the tensor's scale, or dense normal weights with scale 1."""
    rms = 1.0 / np.sqrt(k) if rms is None else rms
    if kind in ("sfp", "nuq"):
        codes = rng.integers(0, 256, (n, k), dtype=np.uint8)
        # Random SFP bytes decode to values of rms 0.4231.
        return jmm.QuantTensor(kind, (n, k), float(rms / 0.4231),
                               {"codes": jnp.asarray(codes)})
    w = jnp.asarray(rng.normal(0, rms, (n, k)).astype(np.float32))
    if kind == "bf16":
        w = w.astype(jnp.bfloat16)
    return jmm.QuantTensor(kind, (n, k), 1.0, {"w": w})


def jax_kind_params(config, rng, kind, emb_rms=0.25):
    """JAX Params of one non-i8 kind, qkv row-concatenated; embedding rows
    of rms `emb_rms` so the tied logits head stays below the final cap."""
    d = config.model_dim

    def norm(n):
        return jnp.asarray(rng.normal(0, 0.1, (n,)).astype(np.float32))

    layers = []
    for lc in config.layer_configs:
        h, kvh, q, ff = lc.heads, lc.kv_heads, lc.qkv_dim, lc.ff_hidden_dim
        layers.append(JLayerParams(
            qkv1=None, qkv2=None,
            qkv_cat=jax_kind_qt(rng, (h + 2 * kvh) * q, d, kind),
            att_w=jax_kind_qt(rng, d, h * q, kind),
            gating1=jax_kind_qt(rng, ff, d, kind),
            gating2=jax_kind_qt(rng, ff, d, kind),
            linear=jax_kind_qt(rng, d, ff, kind),
            pre_att_norm=norm(d), pre_ffw_norm=norm(d),
            post_att_norm=norm(d), post_ffw_norm=norm(d),
            key_norm=None, query_norm=None))
    return JParams(embedding=jax_kind_qt(rng, config.vocab_size, d, kind,
                                         rms=emb_rms),
                   final_norm=norm(d), layers=layers)


def flatten_qt(qt):
    return {"kind": qt.kind, "shape": tuple(qt.shape), "scale": qt.scale,
            "arrays": {k: np.asarray(v) for k, v in qt.arrays.items()}}


def flatten_params(params):
    """JAX Params -> the numpy tree models/bridge.py reads."""
    def arr(a):
        return None if a is None else np.asarray(a)

    layers = []
    for lp in params.layers:
        lt = {}
        for f in dataclasses.fields(lp):
            v = getattr(lp, f.name)
            lt[f.name] = (flatten_qt(v) if isinstance(v, jmm.QuantTensor)
                          else arr(v))
        layers.append(lt)
    return {"embedding": flatten_qt(params.embedding),
            "final_norm": arr(params.final_norm), "layers": layers}


def flatten_cache(cache):
    def arr(a):
        return None if a is None else np.asarray(a)

    return {"kv": arr(cache.kv), "seq_len": cache.seq_len,
            "kv_local": arr(cache.kv_local),
            "seq_len_local": cache.seq_len_local,
            "layer_map": cache.layer_map, "local_slack": cache.local_slack,
            "kv_scale": arr(cache.kv_scale),
            "kv_local_scale": arr(cache.kv_local_scale)}


def rel_err(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


# --- tests ----------------------------------------------------------------

M, K, N = 5, 384, 256


@pytest.mark.parametrize("variant", ["plain", "prologue", "epilogue_add",
                                     "bf16_out"])
def test_matmul_i8_matches_jax(variant):
    """K1's function vs the JAX i8 kernel.  Products of bf16 A and i8
    codes are exact in f32 in both; only the f32 summation order differs
    (and, under the prologue, rare one-ulp flips of the bf16-rounded A), so
    outputs agree to 1e-5 of max|out| (bf16 output: one bf16 ulp, 2^-8)."""
    rng = np.random.default_rng(
        {"plain": 1, "prologue": 2, "epilogue_add": 3, "bf16_out": 4}[variant])
    w = i8_arrays(rng, N, K)
    kw_j, kw_t = {}, {}
    if variant == "prologue":
        a = rng.normal(0, 3, (M, K)).astype(np.float32)
        nw = rng.normal(0, 0.1, (K,)).astype(np.float32)
        kw_j["prologue_norm"] = jnp.asarray(nw)
        kw_t["prologue_norm"] = torch.from_numpy(nw)
    else:
        a = rng.normal(0, 1, (M, K)).astype(np.float32)
        a = np.array(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32))
    if variant == "epilogue_add":
        pw = rng.normal(0, 0.1, (N,)).astype(np.float32)
        add = rng.normal(0, 1, (M, N)).astype(np.float32)
        kw_j.update(epilogue_norm=jnp.asarray(pw), add=jnp.asarray(add))
        kw_t.update(epilogue_norm=torch.from_numpy(pw),
                    add=torch.from_numpy(add))
    out_j = jnp.bfloat16 if variant == "bf16_out" else jnp.float32
    out_t = torch.bfloat16 if variant == "bf16_out" else torch.float32
    a_j = jnp.asarray(a) if variant == "prologue" \
        else jnp.asarray(a).astype(jnp.bfloat16)
    a_t = torch.from_numpy(a) if variant == "prologue" \
        else torch.from_numpy(a).to(torch.bfloat16)
    want = jmm.matmul(a_j, jax_qt(w), out_dtype=out_j, **kw_j)
    got = tmm.matmul(a_t, torch_qt(w), out_dtype=out_t, **kw_t)
    tol = 2 ** -8 if variant == "bf16_out" else 1e-5
    assert rel_err(got.float(), np.asarray(want, np.float32)) <= tol


@pytest.mark.parametrize("prologue", [False, True])
def test_gated_ffn_i8_matches_jax(prologue):
    """K2's function vs the JAX gated kernel; bf16 output, so one bf16 ulp
    (2^-8 of max|out|) on top of the GEMMs' reordered f32 sums."""
    rng = np.random.default_rng(11 + prologue)
    w1, w2 = i8_arrays(rng, N, K), i8_arrays(rng, N, K)
    if prologue:
        x = rng.normal(0, 3, (M, K)).astype(np.float32)
        nw = rng.normal(0, 0.1, (K,)).astype(np.float32)
        want = jmm.gated_ffn(jnp.asarray(x), jax_qt(w1), jax_qt(w2),
                             out_dtype=jnp.bfloat16,
                             prologue_norm=jnp.asarray(nw))
        got = tmm.gated_ffn(torch.from_numpy(x), torch_qt(w1), torch_qt(w2),
                            prologue_norm=torch.from_numpy(nw))
    else:
        x = jnp.asarray(rng.normal(0, 1, (M, K)).astype(np.float32)).astype(
            jnp.bfloat16)
        want = jmm.gated_ffn(x, jax_qt(w1), jax_qt(w2),
                             out_dtype=jnp.bfloat16)
        got = tmm.gated_ffn(
            torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16),
            torch_qt(w1), torch_qt(w2))
    assert got.dtype == torch.bfloat16
    assert rel_err(got.float(), np.asarray(want, np.float32)) <= 2 ** -8


def test_dequantize_and_bridge_exact():
    """The bridge carries i8 weights across bit for bit, and the port's
    dequantize equals the JAX one exactly (same f32 formula)."""
    rng = np.random.default_rng(5)
    w = i8_arrays(rng, N, K)
    jq = jax_qt(w, scale=0.5)
    tq = bridge.quant_tensor_from_numpy(flatten_qt(jq), "cpu")
    for key in w:
        np.testing.assert_array_equal(tq.arrays[key].numpy(), w[key])
    assert tq.shape == (N, K) and tq.scale == 0.5
    np.testing.assert_array_equal(tq.dequantize().numpy(),
                                  np.asarray(jq.dequantize()))


def test_concat_rows_matches_separate_gemms():
    rng = np.random.default_rng(6)
    w1, w2 = i8_arrays(rng, 128, K), i8_arrays(rng, 64, K)
    a = torch.randn(M, K, generator=torch.Generator().manual_seed(0)).to(
        torch.bfloat16)
    cat = tmm.concat_rows(torch_qt(w1), torch_qt(w2))
    assert cat.shape == (192, K)
    want = torch.cat([tmm.matmul(a, torch_qt(w1)),
                      tmm.matmul(a, torch_qt(w2))], dim=1)
    torch.testing.assert_close(tmm.matmul(a, cat), want, rtol=0, atol=0)
