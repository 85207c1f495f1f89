"""The port's 4.5-bit weight codecs (kinds i4 and nuq4 in
gemma_tpu_torch/ops/matmul.py, plain path on CPU) vs the JAX package's on
the same numpy-made weights: the nibble packing and `dequantize` bit for
bit; `matmul` / `gated_ffn` / `matmul_top1` / `matmul_topk` against the
Pallas kernels in interpret mode, at a K that is a multiple of 256 and at
one that is not (both packages zero-pad A to whole 256-blocks);
`embed_tokens`, `concat_rows`, `quant_tensor_i4`, the bridge and the
synth; a small i4 and a small nuq4 model (and the mix a loaded nuq4 model
has: att_w of kind nuq) through prefill and decode chunks against the JAX
engine; and a model with 128-wide heads, two query heads per KV head and
Gemma2-27B's query scale, 1/sqrt(model_dim / heads).

Tolerances are those tests/test_torch_codecs.py states for i8 and sfp:
both packages turn the B tile into the same bf16 values (raw codes 0..15,
or SFP table entries) and form the same exact products; f32 sums run in
another order and, under the prologue, the bf16-rounded A may flip one
ulp, so outputs agree to 1e-5 of max|out| (bf16 outputs: one bf16 ulp,
2^-8)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gemma_tpu.engine import GemmaEngine as JEngine
from gemma_tpu.engine import RuntimeConfig as JRuntime
from gemma_tpu.models import configs as jcfg
from gemma_tpu.models.gemma import LayerParams as JLayerParams
from gemma_tpu.models.gemma import Params as JParams
from gemma_tpu.models.gemma import embed_tokens as j_embed
from gemma_tpu.models.gemma import forward as j_forward
from gemma_tpu.models.kv_cache import KVCache as JKVCache
from gemma_tpu.ops import matmul as jmm
from gemma_tpu_torch.engine import GemmaEngine, RuntimeConfig
from gemma_tpu_torch.models import bridge
from gemma_tpu_torch.models import configs as tcfg
from gemma_tpu_torch.models.gemma import embed_tokens as t_embed
from gemma_tpu_torch.models.gemma import forward as t_forward
from gemma_tpu_torch.models.kv_cache import KVCache as TKVCache
from gemma_tpu_torch.ops import matmul as tmm
from gemma_tpu_torch.utils import synth
from tests.test_torch_matmul import (flatten_params, flatten_qt, i8_arrays,
                                     jax_kind_qt, jax_qt, rel_err,
                                     small_configs)

torch.set_num_threads(1)

KINDS = ["i4", "nuq4"]
KS = [512, 384]   # whole 256-blocks; one and a half
M, N = 5, 256
SCALE = 0.37      # every case runs the scale != 1 path
SFP_RMS = 0.4231  # of uniformly random SFP bytes


def packed_arrays(rng, kind, n, k, rms=None):
    """Numpy arrays of one packed kind in the JAX layout, weights of rms
    ~`rms` (1/sqrt(k) by default) before the tensor scale.  i4: random
    codes, group scales U(0.5, 1.5) * rms / 4.6 and mins about -7.5 *
    scale.  nuq4: random codes, tables of random SFP bytes sorted by value
    (zero-padded to a multiple of 128 a row): (arrays, rms of the values)."""
    rms = 1.0 / np.sqrt(k) if rms is None else rms
    blocks = -(-k // 256)
    codes = rng.integers(0, 256, (n, blocks * 128), dtype=np.uint8)
    if kind == "i4":
        sc = (rng.uniform(0.5, 1.5, (n, blocks * 2)) * rms / 4.6).astype(
            np.float32)
        mins = (-(7.5 + rng.normal(0, 0.5, sc.shape)) * sc).astype(np.float32)
        return {"codes": codes, "scales": sc, "mins": mins}, rms
    from gemma_tpu.compression import sfp as jsfp

    entries = rng.integers(0, 256, (n, blocks, 16), dtype=np.uint8)
    entries[entries == 0x80] = 0
    order = np.argsort(jsfp.decode(entries), axis=-1, kind="stable")
    entries = np.take_along_axis(entries, order, axis=-1)
    tables = np.zeros((n, -(-(blocks * 16) // 128) * 128), np.uint8)
    tables[:, :blocks * 16] = entries.reshape(n, -1)
    return {"codes": codes, "tables": tables}, SFP_RMS


def weights(rng, kind, n=N, k=512, scale=SCALE, rms=None):
    """(JAX QuantTensor, port QuantTensor via the bridge) of one kind."""
    arrays, _ = packed_arrays(rng, kind, n, k, rms)
    jq = jmm.QuantTensor(kind, (n, k), scale,
                         {key: jnp.asarray(v) for key, v in arrays.items()})
    return jq, bridge.quant_tensor_from_numpy(flatten_qt(jq), "cpu")


def logit_weights(rng, kind, n, k, std=4.0):
    """Weights whose logits against N(0, 1)-sized rows have std ~`std`."""
    if kind == "i4":
        return weights(rng, kind, n, k, scale=std)
    return weights(rng, kind, n, k, scale=std / (np.sqrt(k) * SFP_RMS))


@pytest.mark.parametrize("k", [256, 384, 1000])
def test_pack_unpack_bit_exact(k):
    rng = np.random.default_rng(k)
    codes = rng.integers(0, 16, (7, k), dtype=np.uint8)
    packed = tmm.pack_nuq4(codes)
    np.testing.assert_array_equal(packed, jmm._pack_nuq4(codes))
    kp = -(-k // 256) * 256
    assert packed.shape == (7, kp // 2) and packed.dtype == np.uint8
    # byte g*128 + j: element j low, element 128 + j high
    padded = np.zeros((7, kp), np.uint8)
    padded[:, :k] = codes
    last = kp // 256 - 1
    np.testing.assert_array_equal(packed[:, last * 128 + 2] & 15,
                                  padded[:, last * 256 + 2])
    np.testing.assert_array_equal(packed[:, 5] >> 4, padded[:, 128 + 5])
    mine = tmm.unpack_nuq4(torch.from_numpy(packed))
    np.testing.assert_array_equal(
        mine.numpy(), np.asarray(jmm._unpack_nuq4(jnp.asarray(packed))))
    assert mine.dtype == torch.int32
    np.testing.assert_array_equal(mine.numpy()[:, :k], codes)
    lead = tmm.unpack_nuq4(torch.from_numpy(packed).reshape(7, 1, kp // 2))
    np.testing.assert_array_equal(lead[:, 0].numpy(), mine.numpy())


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("k", KS)
def test_dequantize_and_bridge_bit_exact(kind, k):
    """The bridge carries every array and the scale across bit for bit;
    dequantize equals JAX's exactly, cut to the logical K."""
    rng = np.random.default_rng(500 + KINDS.index(kind) + k)
    jq, tq = weights(rng, kind, k=k)
    assert tq.kind == kind and tq.shape == (N, k) and tq.scale == SCALE
    assert tq.kp == 512 and set(tq.arrays) == set(jq.arrays)
    for key, arr in jq.arrays.items():
        mine = tq.arrays[key]
        assert str(mine.dtype).split(".")[1] == str(arr.dtype)
        np.testing.assert_array_equal(mine.numpy(), np.asarray(arr))
    got = tq.dequantize()
    assert got.shape == (N, k)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jq.dequantize()))
    assert tq.nbytes() == jq.nbytes()


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("variant", ["plain", "prologue", "epilogue_add",
                                     "bf16_out"])
def test_matmul_packed_matches_jax(kind, k, variant):
    rng = np.random.default_rng(100 + KINDS.index(kind) * 10 + len(variant)
                                + k)
    jq, tq = weights(rng, kind, k=k)
    kw_j, kw_t = {}, {}
    if variant == "prologue":
        # The norm's mean runs over the logical K, not the padded one.
        a = rng.normal(0, 3, (M, k)).astype(np.float32)
        nw = rng.normal(0, 0.1, (k,)).astype(np.float32)
        kw_j["prologue_norm"] = jnp.asarray(nw)
        kw_t["prologue_norm"] = torch.from_numpy(nw)
        a_j, a_t = jnp.asarray(a), torch.from_numpy(a)
    else:
        a_j = jnp.asarray(rng.normal(0, 1, (M, k)).astype(np.float32)).astype(
            jnp.bfloat16)
        a_t = torch.from_numpy(np.asarray(a_j, np.float32)).to(torch.bfloat16)
    if variant == "epilogue_add":
        pw = rng.normal(0, 0.1, (N,)).astype(np.float32)
        add = rng.normal(0, 1, (M, N)).astype(np.float32)
        kw_j.update(epilogue_norm=jnp.asarray(pw), add=jnp.asarray(add))
        kw_t.update(epilogue_norm=torch.from_numpy(pw),
                    add=torch.from_numpy(add))
    out_j = jnp.bfloat16 if variant == "bf16_out" else jnp.float32
    out_t = torch.bfloat16 if variant == "bf16_out" else torch.float32
    want = jmm.matmul(a_j, jq, out_dtype=out_j, interpret=True, **kw_j)
    got = tmm.matmul(a_t, tq, out_dtype=out_t, **kw_t)
    assert got.shape == (M, N)
    tol = 2 ** -8 if variant == "bf16_out" else 1e-5
    assert rel_err(got.float(), np.asarray(want, np.float32)) <= tol
    # and the dense product it stands for
    dense = a_t.float() if variant != "prologue" else None
    if variant == "plain":
        ref = dense @ tq.dequantize().T
        assert rel_err(got, ref.numpy()) <= 1e-5


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("prologue", [False, True])
def test_gated_ffn_packed_matches_jax(kind, k, prologue):
    rng = np.random.default_rng(200 + KINDS.index(kind) * 2 + prologue + k)
    j1, t1 = weights(rng, kind, k=k)
    j2, t2 = weights(rng, kind, k=k, scale=0.81)
    if prologue:
        x = rng.normal(0, 3, (M, k)).astype(np.float32)
        nw = rng.normal(0, 0.1, (k,)).astype(np.float32)
        want = jmm.gated_ffn(jnp.asarray(x), j1, j2, out_dtype=jnp.bfloat16,
                             prologue_norm=jnp.asarray(nw), interpret=True)
        got = tmm.gated_ffn(torch.from_numpy(x), t1, t2,
                            prologue_norm=torch.from_numpy(nw))
    else:
        x = jnp.asarray(rng.normal(0, 1, (M, k)).astype(np.float32)).astype(
            jnp.bfloat16)
        want = jmm.gated_ffn(x, j1, j2, out_dtype=jnp.bfloat16,
                             interpret=True)
        got = tmm.gated_ffn(
            torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16),
            t1, t2)
    assert got.dtype == torch.bfloat16 and got.shape == (M, N)
    assert rel_err(got.float(), np.asarray(want, np.float32)) <= 2 ** -8


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("need_prob", [True, False])
def test_matmul_top1_packed_matches_jax(kind, need_prob):
    """K3's function per kind, with the final-norm prologue and a mask:
    tokens equal where the capped top1-top2 margin exceeds 1e-4 of
    max|logit|, probs to rtol 1e-5 (tests/test_torch_top1.py's bounds)."""
    rng = np.random.default_rng(300 + KINDS.index(kind) * 2 + need_prob)
    n, k = 1000, 512  # pads to 1024 in JAX's 256-column blocks
    jq, tq = logit_weights(rng, kind, n, k)
    a = rng.normal(0, 3, (M, k)).astype(np.float32)
    nw = rng.normal(0, 0.1, (k,)).astype(np.float32)
    mask = np.ones(n, bool)
    mask[::3] = False
    wt, wp = jmm.matmul_top1(
        jnp.asarray(a), jq, final_cap=30.0, prologue_norm=jnp.asarray(nw),
        allowed_mask=jnp.asarray(mask), blocks=(8, 256, k), interpret=True,
        need_prob=need_prob)
    gt, gp = tmm.matmul_top1(
        torch.from_numpy(a), tq, final_cap=30.0,
        prologue_norm=torch.from_numpy(nw),
        allowed_mask=torch.from_numpy(mask), need_prob=need_prob)
    logits = tmm.matmul_plain(torch.from_numpy(a), tq,
                              prologue_norm=torch.from_numpy(nw))
    if need_prob:
        logits = 30.0 * torch.tanh(logits / 30.0)
    logits = np.where(mask[None], logits.numpy(), -np.inf)
    top2 = np.sort(logits, axis=-1)[:, -2:]
    scale = np.abs(logits[np.isfinite(logits)]).max()
    clear = (top2[:, 1] - top2[:, 0]) > 1e-4 * scale
    assert clear.sum() >= M - 1 and 2.0 < scale < 29.0
    np.testing.assert_array_equal(gt.numpy()[clear], np.asarray(wt)[clear])
    assert mask[gt.numpy()].all()
    if need_prob:
        np.testing.assert_allclose(gp.numpy(), np.asarray(wp), rtol=1e-5)
    else:
        np.testing.assert_array_equal(gp.numpy(), np.ones(M, np.float32))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("k_top", [1, 4, 128])
@pytest.mark.parametrize("variant", ["raw", "cap_prologue", "cap_mask",
                                     "cap_prologue_mask"])
def test_matmul_topk_packed_matches_jax_kernel(kind, k_top, variant):
    """K6's function per kind against the Pallas kernel in interpret mode,
    with tests/test_torch_topk.py's cases and bounds: values to 1e-4 of
    max|logit|, indices equal wherever both neighbours are further apart."""
    from tests.test_torch_topk import _check, _run

    n, k = 1000, 512
    rng = np.random.default_rng(KINDS.index(kind) * 100 + k_top
                                + len(variant) + 4000)
    wj, wt = logit_weights(rng, kind, n, k)
    cap = 30.0 if "cap" in variant else 0.0
    if "prologue" in variant:
        a = rng.normal(0, 3, (M, k)).astype(np.float32)
        nw = rng.normal(0, 0.1, (k,)).astype(np.float32)
    else:
        a = np.array(jnp.asarray(rng.normal(0, 1, (M, k)).astype(
            np.float32)).astype(jnp.bfloat16).astype(jnp.float32))
        nw = None
    mask = rng.random(n) < 0.5 if "mask" in variant else None
    want, got = _run(wj, wt, a, nw, k_top, cap, mask, blocks=(8, 256, k))
    _check(want, got, k_top)
    if mask is not None:
        assert mask[got[1]].all()


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("k", KS)
def test_embed_tokens_packed_matches_jax(kind, k):
    """The token's packed row with its scales / mins or its table row,
    decoded and cut to model_dim: the same f32 arithmetic (i4's s*c + m may
    fuse into one rounding in XLA: 1e-6 relative to the row's size)."""
    rng = np.random.default_rng(400 + KINDS.index(kind) + k)
    jq, tq = weights(rng, kind, n=64, k=k)
    tokens = rng.integers(0, 64, (3, 7)).astype(np.int32)
    want = np.asarray(j_embed(jq, jnp.asarray(tokens), k))
    got = t_embed(tq, torch.from_numpy(tokens), k)
    assert got.dtype == torch.float32 and got.shape == (3, 7, k)
    assert rel_err(got, want) <= 1e-6
    rows = tq.dequantize()[torch.from_numpy(tokens).long()]
    assert rel_err(got, (rows / SCALE * (k ** 0.5 * SCALE)).numpy()) <= 1e-2


@pytest.mark.parametrize("kind", KINDS)
def test_concat_rows_packed(kind):
    rng = np.random.default_rng(600 + KINDS.index(kind))
    j1, t1 = weights(rng, kind, n=128)
    j2, t2 = weights(rng, kind, n=64)
    a = torch.randn(M, 512, generator=torch.Generator().manual_seed(0)).to(
        torch.bfloat16)
    cat = tmm.concat_rows(t1, t2)
    assert cat.kind == kind and cat.shape == (192, 512) and cat.scale == SCALE
    jcat = jmm.concat_rows(j1, j2)
    for key, arr in jcat.arrays.items():
        np.testing.assert_array_equal(cat.arrays[key].numpy(),
                                      np.asarray(arr))
    want = torch.cat([tmm.matmul(a, t1), tmm.matmul(a, t2)], dim=1)
    torch.testing.assert_close(tmm.matmul(a, cat), want, rtol=0, atol=0)
    _, other = weights(rng, kind, n=64, scale=0.5)
    assert tmm.concat_rows(t1, other) is None  # scales differ
    _, wide = weights(rng, kind, n=64, k=768)
    assert tmm.concat_rows(t1, wide) is None   # K differs


@pytest.mark.parametrize("k", KS)
def test_quant_tensor_i4_matches_jax(k):
    """The i4 encoder (numpy, compression/int4.py) and the packing: every
    array equals the JAX package's, and the round trip stays within one code
    step of the values (the least-squares refit may clip an outlier)."""
    rng = np.random.default_rng(k)
    vals = rng.normal(0, 0.05, (24, k)).astype(np.float32)
    want = jmm.quant_tensor_i4(vals)
    got = tmm.quant_tensor_i4(vals, "cpu")
    assert got.kind == "i4" and got.shape == (24, k) and got.scale == 1.0
    for key, arr in want.arrays.items():
        np.testing.assert_array_equal(got.arrays[key].numpy(),
                                      np.asarray(arr))
    err = (got.dequantize().numpy() - vals)
    assert np.abs(err).max() <= float(got.arrays["scales"].max())


@pytest.mark.parametrize("kind", KINDS)
def test_synth_quant_packed_layout_and_rms(kind):
    """The synth's arrays have the JAX synth's names, shapes and dtypes,
    the weights' rms is 1/sqrt(K) (within sampling noise), and nuq4's
    tables ascend within each block."""
    from gemma_tpu.utils.synth import synth_quant as j_synth

    for k in (512, 640):
        n = 64
        mine = synth.synth_quant(torch.Generator().manual_seed(1), n, k,
                                 "cpu", kind)
        ref = j_synth(np.random.default_rng(1), n, k, kind)
        assert set(mine.arrays) == set(ref.arrays)
        for key, arr in ref.arrays.items():
            assert tuple(mine.arrays[key].shape) == arr.shape
            assert str(mine.arrays[key].dtype).split(".")[1] == str(arr.dtype)
        rms = float(mine.dequantize().square().mean().sqrt())
        assert abs(rms * np.sqrt(k) - 1.0) < 0.1
    if kind == "nuq4":
        blocks = -(-k // 256)
        t = tmm.sfp_decode(mine.arrays["tables"][:, :blocks * 16]).reshape(
            n, blocks, 16)
        assert bool((t[..., 1:] >= t[..., :-1]).all())
        assert mine.scale != 1.0
        assert not mine.arrays["tables"][:, blocks * 16:].any()


def test_packed_kinds_raise_on_bad_cuda_shapes():
    """On the card K must be whole 256-blocks: the wrapper says so before
    any launch (here without a card, through the operand check)."""
    tq = synth.synth_quant(torch.Generator().manual_seed(0), 16, 384, "cpu",
                           "i4")
    with pytest.raises(ValueError, match="multiple of 256"):
        tmm._b_operand(tq, "matmul")
    with pytest.raises(ValueError, match="one of"):
        tmm.QuantTensor("i5", (8, 256), 1.0, {}).dequantize()


# --- whole models ---------------------------------------------------------

SEQ, NEW, LOGIT_TOL = 64, 9, 5e-3


def jax_packed_qt(rng, n, k, kind, rms=None):
    if kind == "i8":
        arrays = i8_arrays(rng, n, k)
        if rms is not None:
            arrays["inv_scales"] *= np.float32(rms * np.sqrt(k) * 64 / 74)
        return jax_qt(arrays)
    if kind not in KINDS:
        return jax_kind_qt(rng, n, k, kind, rms)
    arrays, val_rms = packed_arrays(rng, kind, n, k, rms)
    rms = 1.0 / np.sqrt(k) if rms is None else rms
    scale = 1.0 if kind == "i4" else float(rms / val_rms)
    return jmm.QuantTensor(kind, (n, k), scale,
                           {key: jnp.asarray(v) for key, v in arrays.items()})


def jax_packed_params(config, rng, kind, att_kind=None, emb_rms=0.25 * 0.03):
    """JAX Params with every weight of `kind` (att_w of `att_kind` when
    given), qkv row-concatenated; embedding rows shrunk and the final norm
    raised as in tests/test_torch_decode.py, so the layers decide the
    greedy tokens."""
    d = config.model_dim

    def norm(n):
        return jnp.asarray(rng.normal(0, 0.1, (n,)).astype(np.float32))

    layers = []
    for lc in config.layer_configs:
        h, kvh, q, ff = lc.heads, lc.kv_heads, lc.qkv_dim, lc.ff_hidden_dim
        layers.append(JLayerParams(
            qkv1=None, qkv2=None,
            qkv_cat=jax_packed_qt(rng, (h + 2 * kvh) * q, d, kind),
            att_w=jax_packed_qt(rng, d, h * q, att_kind or kind),
            gating1=jax_packed_qt(rng, ff, d, kind),
            gating2=jax_packed_qt(rng, ff, d, kind),
            linear=jax_packed_qt(rng, d, ff, kind),
            pre_att_norm=norm(d), pre_ffw_norm=norm(d),
            post_att_norm=norm(d), post_ffw_norm=norm(d),
            key_norm=None, query_norm=None))
    return JParams(
        embedding=jax_packed_qt(rng, config.vocab_size, d, kind, rms=emb_rms),
        final_norm=norm(d) + 9.0, layers=layers)


def _model(kind, att_kind=None, query_scale=None, seed=27):
    jc, tc = small_configs(num_layers=2, seq=SEQ, windows=(16, SEQ))
    if query_scale is not None:
        jc.query_scale = jcfg.QueryScaleType(int(query_scale))
        tc.query_scale = tcfg.QueryScaleType(int(query_scale))
    rng = np.random.default_rng(seed)
    jparams = jax_packed_params(jc, rng, kind, att_kind)
    tparams = bridge.params_from_numpy(flatten_params(jparams), tc, "cpu")
    prompts = [rng.integers(2, jc.vocab_size, n).tolist() for n in (5, 23, 40)]
    return jc, tc, jparams, tparams, prompts


@pytest.fixture(scope="module", params=["i4", "nuq4", "nuq4+nuq"])
def packed_model(request):
    kind, _, att_kind = request.param.partition("+")
    return _model(kind, att_kind or None)


@pytest.fixture(scope="module")
def wide_scale_model():
    """128-wide heads, 4 query heads over 2 KV heads, query scale
    1/sqrt(model_dim / heads) = 1/8 (against 1/sqrt(128)), i8 weights."""
    return _model("i8", query_scale=tcfg.QueryScaleType
                  .SQRT_MODEL_DIM_DIV_NUM_HEADS, seed=31)


def _teacher_logits(model, seq, kv_kind="bf16"):
    jc, tc, jparams, tparams, _ = model
    jcache = JKVCache.create(jc, 1, SEQ, kind=kv_kind)
    want, _ = j_forward(jparams, jnp.asarray(seq, jnp.int32)[None],
                        jnp.arange(len(seq), dtype=jnp.int32)[None], jcache,
                        jc, return_logits="all")
    tcache = TKVCache.create(tc, 1, SEQ, kind=kv_kind, device="cpu")
    got, _ = t_forward(tparams, torch.tensor(seq)[None],
                       torch.arange(len(seq))[None], tcache, tc,
                       return_logits="all")
    return got[0].numpy(), np.asarray(want[0])


def _check_engines(model, **kw):
    """Greedy (or sampled) decode chunks of both engines on the same
    prompts: teacher-forced logits within LOGIT_TOL of max|logit|, tokens
    equal while JAX's top1-top2 margin exceeds twice that."""
    jc, tc, jparams, tparams, prompts = model
    jeng = JEngine(jparams, jc, JRuntime(verbosity=0, seq_len=SEQ, **kw))
    teng = GemmaEngine(tparams, tc, RuntimeConfig(seq_len=SEQ, **kw),
                       device="cpu")
    assert teng.runtime.decode_chunk == 4
    kv_kind = teng.runtime.kv_kind
    want = jeng.generate_batch(prompts, max_generated_tokens=NEW)
    got = teng.generate_batch(prompts, max_generated_tokens=NEW)
    assert [len(g) for g in got] == [len(w) for w in want]
    compared = 0
    for p, g, w in zip(prompts, got, want):
        t_log, j_log = _teacher_logits(model, p + w, kv_kind)
        scale = np.abs(j_log).max()
        assert np.abs(t_log - j_log).max() <= LOGIT_TOL * scale
        for i, tok in enumerate(w):
            top2 = np.sort(j_log[len(p) - 1 + i])[-2:]
            if top2[1] - top2[0] <= 2 * LOGIT_TOL * scale:
                break
            assert g[i] == tok, (i, g, w)
            compared += 1
    assert compared >= 6
    return got


def test_packed_model_decode_matches_jax_engine(packed_model):
    """A whole i4 model, a whole nuq4 model and the loaded nuq4 model's mix
    (att_w of kind nuq): chunked prefill and decode chunks through the
    fused greedy head against the JAX engine."""
    _check_engines(packed_model)


def test_packed_model_decode_matches_prefill(packed_model):
    """The fused decode layer (prologue and epilogue passes around the
    packed GEMMs) gives the prefill path's last logits."""
    _, tc, _, tparams, prompts = packed_model
    seq = prompts[1]
    cache = TKVCache.create(tc, 1, SEQ, kind="bf16", device="cpu")
    t_forward(tparams, torch.tensor(seq[:-1])[None],
              torch.arange(len(seq) - 1)[None], cache, tc,
              return_logits="none")
    dec, _ = t_forward(tparams, torch.tensor([[seq[-1]]]),
                       torch.tensor([[len(seq) - 1]]), cache, tc,
                       return_logits="last")
    ref, _ = t_forward(tparams, torch.tensor(seq)[None],
                       torch.arange(len(seq))[None],
                       TKVCache.create(tc, 1, SEQ, kind="bf16", device="cpu"),
                       tc, return_logits="last")
    assert rel_err(dec, ref.numpy()) <= LOGIT_TOL


def test_packed_model_sampled_chunk_matches_stepwise(packed_model):
    """Sampled decode on packed weights: chunks of 4 through the fused
    top-k head draw the tokens of one-step decode on full logits."""
    _, tc, _, tparams, prompts = packed_model
    kw = dict(seq_len=SEQ, top_k=8, temperature=0.8, seed=3)
    chunked = GemmaEngine(tparams, tc, RuntimeConfig(**kw), device="cpu")
    stepwise = GemmaEngine(tparams, tc, RuntimeConfig(decode_chunk=1, **kw),
                           device="cpu")
    a = chunked.generate_batch(prompts[:2], max_generated_tokens=6)
    b = stepwise.generate_batch(prompts[:2], max_generated_tokens=6)
    assert a == b and all(len(x) == 6 for x in a)


def test_query_scale_value_matches_jax(wide_scale_model):
    jc, tc, *_ = wide_scale_model
    assert tc.query_scale_value() == jc.query_scale_value() == 0.125
    jc2, tc2 = small_configs()
    assert tc2.query_scale_value() == jc2.query_scale_value() \
        == 1 / np.sqrt(128)
    assert tcfg.config_gemma2_27b().query_scale_value() == \
        jcfg.config_gemma2_27b().query_scale_value() == 1 / 12


def test_wide_scale_model_decode_matches_jax_engine(wide_scale_model):
    """D=128, 2 queries per KV head, SQRT_MODEL_DIM_DIV_NUM_HEADS: prefill
    and decode chunks against the JAX engine; the other query scale would
    not pass (checked below).  Over an f32 KV cache: the sharper softmax of
    this query scale (1/8 against 1/11.3) doubles what a one-ulp flip of a
    bf16 KV row does to the logits, past the 5e-3 the other models keep;
    the bf16 ring is held by the packed models above."""
    got = _check_engines(wide_scale_model, kv_kind="f32")
    jc, tc, jparams, tparams, prompts = wide_scale_model
    other = dataclasses.replace(
        tc, query_scale=tcfg.QueryScaleType.SQRT_KEY_SIZE)
    seq = prompts[2] + got[2]
    cache = TKVCache.create(other, 1, SEQ, kind="f32", device="cpu")
    wrong, _ = t_forward(tparams, torch.tensor(seq)[None],
                         torch.arange(len(seq))[None], cache, other,
                         return_logits="all")
    right, j_log = _teacher_logits(wide_scale_model, seq, "f32")
    assert rel_err(wrong[0], j_log) > 4 * rel_err(right, j_log)


@pytest.mark.parametrize("kv_kind", ["i8", "bf16"])
def test_wide_scale_model_prefill_then_decode_matches_jax(wide_scale_model,
                                                          kv_kind):
    """One decode step after a chunked prefill, last logits against the
    JAX forward, over the other KV kinds."""
    jc, tc, jparams, tparams, prompts = wide_scale_model
    seq = prompts[2]
    jcache = JKVCache.create(jc, 1, SEQ, kind=kv_kind)
    tcache = TKVCache.create(tc, 1, SEQ, kind=kv_kind, device="cpu")
    n = len(seq) - 1
    _, jcache = j_forward(jparams, jnp.asarray(seq[:n], jnp.int32)[None],
                          jnp.arange(n, dtype=jnp.int32)[None], jcache, jc,
                          return_logits="none")
    want, _ = j_forward(jparams, jnp.asarray([[seq[n]]], jnp.int32),
                        jnp.asarray([[n]], jnp.int32), jcache, jc,
                        return_logits="last")
    t_forward(tparams, torch.tensor(seq[:n])[None], torch.arange(n)[None],
              tcache, tc, return_logits="none")
    got, _ = t_forward(tparams, torch.tensor([[seq[n]]]),
                       torch.tensor([[n]]), tcache, tc, return_logits="last")
    assert rel_err(got, np.asarray(want)) <= LOGIT_TOL
