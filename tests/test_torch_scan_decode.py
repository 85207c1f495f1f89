"""The port's scan-over-layers decode (gemma_tpu_torch/engine/scan_decode.py)
and its stacked GEMMs (ops/matmul.py `stack_quant_tensors`, `take_layer`,
`matmul(..., layer=)`, `gated_ffn(..., layer=)`) on the CPU, against the
JAX package's (Pallas kernels in interpret mode) and against the port's
own unrolled forward; the engine under GEMMA_SCAN_DECODE=1; and the
port's absolute position embeddings and its refusal of a file's ViT
weights.

Models use tests/test_scan_decode.py's lane-aligned tiny config (every
GEMM dim a multiple of 128); weights are made with numpy and carried into
the port with models/bridge.py.  Tolerances are stated where they apply.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gemma_tpu.engine import scan_decode as jscan
from gemma_tpu.models import configs as jcfg
from gemma_tpu.models.gemma import forward as j_forward
from gemma_tpu.models.kv_cache import KVCache as JKVCache
from gemma_tpu.ops import matmul as jmm
from gemma_tpu_torch.engine import GemmaEngine, RuntimeConfig
from gemma_tpu_torch.engine import engine as tengine
from gemma_tpu_torch.engine import scan_decode as tscan
from gemma_tpu_torch.models import configs as tcfg
from gemma_tpu_torch.models.bridge import params_from_numpy
from gemma_tpu_torch.models.gemma import forward as t_forward
from gemma_tpu_torch.models.kv_cache import KVCache as TKVCache
from gemma_tpu_torch.ops import matmul as tmm
from tests.test_model import random_weights, tiny_config, to_params
from tests.test_scan_decode import _aligned
from tests.test_torch_matmul import (flatten_params, flatten_qt, i8_arrays,
                                     jax_i8_params, jax_kind_params, rel_err)

torch.set_num_threads(1)

SEQ, BATCH, N_PRE = 64, 2, 6
# Port against JAX over a whole forward: the same math in another f32
# summation order; an i8 KV row re-quantized from such a sum can move a
# code by one, which the JAX suite's full-forward bound for i8 KV absorbs
# (tests/test_parity_full.py:149-154: 2e-2 of max|logit|).  With f32 KV
# nothing is re-quantized: 1e-4.
TOL = {"i8": 2e-2, "f32": 1e-4}


def both_configs(num_layers=4, windows=None, use_qk_norm=False,
                 absolute_pe=False):
    """The aligned tiny config of tests/test_scan_decode.py, in both
    packages."""
    jc = _aligned(tiny_config(num_layers=num_layers, use_qk_norm=use_qk_norm))
    if windows is not None:
        jc.attention_window_sizes = [windows[i % len(windows)]
                                     for i in range(num_layers)]
    jc.absolute_pe = absolute_pe
    lc = jc.layer_configs[0]
    tc = tcfg.ModelConfig(
        model=tcfg.Model.GEMMA2_2B, num_layers=num_layers,
        model_dim=jc.model_dim, vocab_size=jc.vocab_size,
        max_seq_len=jc.max_seq_len, att_cap=jc.att_cap,
        final_cap=jc.final_cap, absolute_pe=absolute_pe,
        query_scale=tcfg.QueryScaleType.SQRT_KEY_SIZE,
        layer_configs=[tcfg.LayerConfig(
            model_dim=lc.model_dim, ff_hidden_dim=lc.ff_hidden_dim,
            heads=lc.heads, kv_heads=lc.kv_heads, qkv_dim=lc.qkv_dim,
            post_norm=tcfg.PostNormType.SCALE, use_qk_norm=use_qk_norm)
            for _ in range(num_layers)],
        attention_window_sizes=list(jc.attention_window_sizes))
    return jc, tc


def make_model(jc, tc, weights="f32", seed=0):
    """(JAX params, port params) with the same numpy-made weights: "f32"
    the JAX scan test's split dense weights, "i8" fused i8 weights."""
    rng = np.random.default_rng(seed)
    if weights == "f32":
        jp = to_params(random_weights(jc, rng), jc)
    elif weights == "i8":
        jp = jax_i8_params(jc, rng)
    else:
        jp = jax_kind_params(jc, rng, weights)
    return jp, params_from_numpy(flatten_params(jp), tc, "cpu")


def prefilled(tc, tp, kv_kind, seed=1):
    """A port cache prefilled through the unrolled forward with N_PRE
    tokens per slot (local windows of 16 get their own pool: slack 8)."""
    cache = TKVCache.create(tc, BATCH, SEQ, kind=kv_kind, local_slack=8,
                            device="cpu")
    rng = np.random.default_rng(seed)
    toks = torch.from_numpy(rng.integers(1, tc.vocab_size, (BATCH, N_PRE)))
    pos = torch.arange(N_PRE).repeat(BATCH, 1)
    t_forward(tp, toks, pos, cache, tc, return_logits="none")
    return cache


def to_jax_cache(c: TKVCache) -> JKVCache:
    def arr(a):
        if a is None:
            return None
        if a.dtype == torch.bfloat16:
            return jnp.asarray(a.float().numpy()).astype(jnp.bfloat16)
        return jnp.asarray(a.numpy())

    return JKVCache(kv=arr(c.kv), seq_len=c.seq_len, kv_local=arr(c.kv_local),
                    seq_len_local=c.seq_len_local, layer_map=c.layer_map,
                    local_slack=c.local_slack, kv_scale=arr(c.kv_scale),
                    kv_local_scale=arr(c.kv_local_scale))


def assert_caches_equal(a: TKVCache, b: TKVCache):
    for name in ("kv", "kv_local", "kv_scale", "kv_local_scale"):
        x, y = getattr(a, name), getattr(b, name)
        assert (x is None) == (y is None), name
        if x is not None:
            assert torch.equal(x, y), name


# --- detect_period ----------------------------------------------------------


@pytest.mark.parametrize("model", list(tcfg.CONFIG_FACTORY),
                         ids=lambda m: m.name)
def test_detect_period_matches_jax(model):
    tc = tcfg.CONFIG_FACTORY[model]()
    jc = jcfg.CONFIG_FACTORY[jcfg.Model[model.name]]()
    assert tscan.detect_period(tc) == jscan.detect_period(jc)


# --- stacked weights --------------------------------------------------------

L, N, K, M = 3, 256, 512, 4
KINDS = ("i8", "sfp", "nuq", "bf16", "f32", "i4", "nuq4")


def jax_weight(rng, kind, scale=1.0, n=N, k=K):
    """A JAX QuantTensor of `kind` [n, k] with numpy-made arrays in the
    JAX layout (random codes, group arrays and tables)."""
    if kind == "i8":
        return jmm.QuantTensor("i8", (n, k), scale, {
            key: jnp.asarray(v) for key, v in i8_arrays(rng, n, k).items()})
    if kind in ("sfp", "nuq"):
        return jmm.QuantTensor(kind, (n, k), scale, {"codes": jnp.asarray(
            rng.integers(0, 256, (n, k), dtype=np.uint8))})
    if kind in ("bf16", "f32"):
        w = jnp.asarray(rng.normal(0, 1 / np.sqrt(k), (n, k)), jnp.float32)
        return jmm.QuantTensor(kind, (n, k), scale, {
            "w": w.astype(jnp.bfloat16) if kind == "bf16" else w})
    kp = -(-k // 256) * 256
    codes = jnp.asarray(rng.integers(0, 256, (n, kp // 2), dtype=np.uint8))
    if kind == "i4":
        sc = rng.uniform(0.5, 1.5, (n, kp // 128)) / (4.64 * np.sqrt(k))
        return jmm.QuantTensor("i4", (n, k), scale, {
            "codes": codes, "scales": jnp.asarray(sc, jnp.float32),
            "mins": jnp.asarray(-7.5 * sc, jnp.float32)})
    tables = np.zeros((n, -(-(kp // 16) // 128) * 128), np.uint8)
    tables[:, :kp // 16] = rng.integers(0, 256, (n, kp // 16))
    return jmm.QuantTensor("nuq4", (n, k), scale, {
        "codes": codes, "tables": jnp.asarray(tables)})


def port_weight(jq):
    from gemma_tpu_torch.models.bridge import quant_tensor_from_numpy
    return quant_tensor_from_numpy(flatten_qt(jq), "cpu")


def stacks(kind, seed):
    """L JAX weights of `kind` (bf16 / f32 with a tensor scale to fold,
    the others with one shared scale), and their port copies."""
    rng = np.random.default_rng(seed)
    scale = {"bf16": 1.25, "f32": 0.75}.get(kind, 1.0)
    if kind in ("sfp", "nuq", "nuq4"):
        scale = 0.04
    jqs = [jax_weight(rng, kind, scale) for _ in range(L)]
    return jqs, [port_weight(q) for q in jqs]


@pytest.mark.parametrize("kind", KINDS)
def test_stack_quant_tensors_matches_jax(kind):
    """The stacked arrays equal JAX's bit for bit: [L, G, N] group arrays
    for i8 / i4, the tensor scale folded into bf16 / f32 weights."""
    jqs, tqs = stacks(kind, 1)
    js, ts = jmm.stack_quant_tensors(jqs), tmm.stack_quant_tensors(tqs)
    assert ts.stacked and "stacked" in js.flags
    assert (ts.kind, ts.shape, ts.scale) == (js.kind, tuple(js.shape),
                                            js.scale)
    assert set(ts.arrays) == set(js.arrays)
    for key, a in js.arrays.items():
        want = np.asarray(a.astype(jnp.float32) if a.dtype == jnp.bfloat16
                          else a)
        np.testing.assert_array_equal(ts.arrays[key].float().numpy()
                                      if ts.arrays[key].dtype
                                      == torch.bfloat16
                                      else ts.arrays[key].numpy(), want)
    for t in range(L):  # take_layer undoes the stack (and keeps the fold)
        got = tmm.take_layer(ts, t)
        want = jmm.take_layer(js, jnp.int32(t))
        for key in want.arrays:
            np.testing.assert_array_equal(
                got.arrays[key].float().numpy(),
                np.asarray(want.arrays[key]).astype(np.float32))


@pytest.mark.parametrize("kind", ["i8", "sfp", "nuq", "i4", "nuq4"])
def test_heterogeneous_scales_raise(kind):
    jqs, tqs = stacks(kind, 2)
    jqs[1] = dataclasses.replace(jqs[1], scale=jqs[1].scale * 2)
    tqs[1] = dataclasses.replace(tqs[1], scale=tqs[1].scale * 2)
    with pytest.raises(ValueError):
        jmm.stack_quant_tensors(jqs)
    with pytest.raises(ValueError):
        tmm.stack_quant_tensors(tqs)


def test_layer_argument_is_checked():
    _, tqs = stacks("i8", 3)
    st = tmm.stack_quant_tensors(tqs)
    a = torch.zeros(M, K, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="needs layer"):
        tmm.matmul(a, st)
    with pytest.raises(ValueError, match="stacked weight"):
        tmm.matmul(a, tqs[0], layer=0)
    with pytest.raises(ValueError, match="layer 3 of 3"):
        tmm.matmul(a, st, layer=L)
    with pytest.raises(ValueError, match="needs layer"):
        tmm.gated_ffn(a, st, st)
    with pytest.raises(ValueError, match="stacked"):
        tmm.matmul_top1(a.float(), st, final_cap=0.0)


@pytest.mark.parametrize("kind", KINDS)
def test_stacked_matmul_and_gated_match_jax(kind):
    """matmul(layer=t) with the prologue norm, the post-norm and the
    residual add, and gated_ffn(layer=t) with its prologue, against JAX's
    layer= calls (interpret mode), at tests/test_torch_matmul.py's
    tolerances: 1e-5 of max|out| for f32 out (the same exact products in
    another f32 order), 2^-8 for the gated GEMM's bf16 out.  On the CPU
    the port's result equals its own unstacked call on that layer."""
    rng = np.random.default_rng(5)
    jqs, tqs = stacks(kind, 4)
    js, ts = jmm.stack_quant_tensors(jqs), tmm.stack_quant_tensors(tqs)
    x = rng.normal(0, 3, (M, K)).astype(np.float32)
    nw = rng.normal(0, 0.1, (K,)).astype(np.float32)
    pw = rng.normal(0, 0.1, (N,)).astype(np.float32)
    add = rng.normal(0, 1, (M, N)).astype(np.float32)
    kw_j = dict(prologue_norm=jnp.asarray(nw), epilogue_norm=jnp.asarray(pw),
                add=jnp.asarray(add))
    kw_t = dict(prologue_norm=torch.from_numpy(nw),
                epilogue_norm=torch.from_numpy(pw), add=torch.from_numpy(add))
    jw, tw = (jqs, tqs) if kind not in ("bf16", "f32") else (None, None)
    for t in (0, L - 1):
        want = jmm.matmul(jnp.asarray(x), js, layer=jnp.int32(t), **kw_j)
        got = tmm.matmul(torch.from_numpy(x), ts, layer=t, **kw_t)
        assert rel_err(got, np.asarray(want)) <= 1e-5
        if jw is not None:  # unfolded kinds: the plain layer exactly
            own = tmm.matmul(torch.from_numpy(x), tw[t], **kw_t)
            assert torch.equal(got, own)
    gq = [jax_weight(np.random.default_rng(20 + i), kind,
                     stacks(kind, 0)[0][0].scale, n=N, k=K)
          for i in range(2 * L)]
    js1, js2 = (jmm.stack_quant_tensors(gq[:L]),
                jmm.stack_quant_tensors(gq[L:]))
    ts1 = tmm.stack_quant_tensors([port_weight(q) for q in gq[:L]])
    ts2 = tmm.stack_quant_tensors([port_weight(q) for q in gq[L:]])
    want = jmm.gated_ffn(jnp.asarray(x), js1, js2, out_dtype=jnp.bfloat16,
                         prologue_norm=jnp.asarray(nw), layer=jnp.int32(1))
    got = tmm.gated_ffn(torch.from_numpy(x), ts1, ts2,
                        prologue_norm=torch.from_numpy(nw), layer=1)
    assert got.dtype == torch.bfloat16
    assert rel_err(got.float(), np.asarray(want, np.float32)) <= 2 ** -8


# --- forward_scan -----------------------------------------------------------


def scan_setup(kv_kind, windows=None, num_layers=4, use_qk_norm=False,
               weights="f32"):
    jc, tc = both_configs(num_layers, windows, use_qk_norm)
    jp, tp = make_model(jc, tc, weights)
    jsp = jscan.build_scan_params(jp, jc)
    tsp = tscan.build_scan_params(tp, tc)
    assert jsp is not None and tsp is not None
    return jc, tc, jsp, tp, tsp


@pytest.mark.parametrize("kv_kind", ["f32", "i8"])
@pytest.mark.parametrize("windows", [None, (16, 64)], ids=["one_pool",
                                                          "two_pools"])
def test_forward_scan_matches_unrolled_and_jax(kv_kind, windows):
    """Three chained decode steps: the port's forward_scan equals its
    unrolled forward bit for bit, logits and every pool; its first step
    matches JAX's forward_scan on the same cache (TOL)."""
    jc, tc, jsp, tp, tsp = scan_setup(kv_kind, windows)
    ca = prefilled(tc, tp, kv_kind)
    if windows is not None:
        assert ca.layer_map, "alternating windows must split the pools"
    cb = ca.copy()
    jcache = to_jax_cache(ca)
    rng = np.random.default_rng(7)
    tok = torch.from_numpy(rng.integers(1, tc.vocab_size, (BATCH, 1)))
    for step in range(3):
        pos = torch.full((BATCH, 1), N_PRE + step)
        ref, _ = t_forward(tp, tok, pos, ca, tc, return_logits="last")
        got, _ = tscan.forward_scan(tsp, tok, pos, cb, tc,
                                    return_logits="last")
        assert torch.equal(got, ref)
        assert_caches_equal(ca, cb)
        if step == 0:
            want, _ = jscan.forward_scan(
                jsp, jnp.asarray(tok.numpy(), jnp.int32),
                jnp.asarray(pos.numpy(), jnp.int32), jcache, jc,
                return_logits="last")
            assert rel_err(got, np.asarray(want)) <= TOL[kv_kind]
        tok = ref.argmax(-1, keepdim=True)


def test_forward_scan_qk_norm_period_3():
    """The 6-layer period-3 config with QK norms (two local layers, one
    global, per period) against the unrolled forward and JAX."""
    jc, tc, jsp, tp, tsp = scan_setup("f32", (16, 16, 64), num_layers=6,
                                      use_qk_norm=True)
    assert tscan.detect_period(tc) == 3 and len(tsp.layers) == 3
    ca = prefilled(tc, tp, "f32")
    cb = ca.copy()
    jcache = to_jax_cache(ca)
    tok = torch.tensor([[5], [9]])
    pos = torch.full((BATCH, 1), N_PRE)
    ref, _ = t_forward(tp, tok, pos, ca, tc, return_logits="last")
    got, _ = tscan.forward_scan(tsp, tok, pos, cb, tc, return_logits="last")
    assert torch.equal(got, ref)
    assert_caches_equal(ca, cb)
    want, _ = jscan.forward_scan(jsp, jnp.asarray(tok.numpy(), jnp.int32),
                                 jnp.asarray(pos.numpy(), jnp.int32), jcache,
                                 jc, return_logits="last")
    assert rel_err(got, np.asarray(want)) <= TOL["f32"]


@pytest.mark.parametrize("head", ["top1", "topk", "none"])
def test_forward_scan_heads_and_valid(head):
    """Each fused head with a valid mask (slot 1 invalid: it writes only
    the garbage row), on fused i8 weights over an i8 cache: equal to the
    unrolled forward, and JAX's tokens (top1: the winner; topk: indices,
    values within TOL)."""
    jc, tc, jsp, tp, tsp = scan_setup("i8", (16, 64), weights="i8")
    assert tp.layers[0].qkv_cat is not None
    ca = prefilled(tc, tp, "i8")
    cb = ca.copy()
    jcache = to_jax_cache(ca)
    tok = torch.tensor([[3], [11]])
    pos = torch.full((BATCH, 1), N_PRE)
    valid = torch.tensor([[True], [False]])
    kw = dict(return_logits=head, top_k_n=4)
    ref, _ = t_forward(tp, tok, pos, ca, tc, valid=valid, **kw)
    got, _ = tscan.forward_scan(tsp, tok, pos, cb, tc, valid=valid, **kw)
    assert_caches_equal(ca, cb)
    if head == "none":
        assert got is None and ref is None
        return
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
    want, _ = jscan.forward_scan(
        jsp, jnp.asarray(tok.numpy(), jnp.int32),
        jnp.asarray(pos.numpy(), jnp.int32), jcache, jc,
        valid=jnp.asarray(valid.numpy()), **kw)
    if head == "top1":
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        assert rel_err(got[1], np.asarray(want[1])) <= TOL["i8"]
    else:
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
        assert rel_err(got[0], np.asarray(want[0])) <= TOL["i8"]


@pytest.mark.parametrize("weights", ["i4", "nuq4", "sfp"])
def test_forward_scan_equals_unrolled_per_kind(weights):
    """The other weight kinds, fused qkv, bf16 KV: bit-equal to the
    unrolled forward (nuq4 and sfp tensors share one tensor scale, as the
    loader's transcodes give them)."""
    jc, tc = both_configs(4, (16, 64))
    rng = np.random.default_rng(3)
    tp = params_from_numpy(flatten_params(jax_i8_params(jc, rng)), tc, "cpu")
    wr = np.random.default_rng(4)
    for lp in tp.layers:
        for name in ("qkv_cat", "att_w", "gating1", "gating2", "linear"):
            w = getattr(lp, name)
            setattr(lp, name, port_weight(jax_weight(
                wr, weights, 0.04 if weights != "i4" else 1.0, n=w.n,
                k=w.k)))
    tsp = tscan.build_scan_params(tp, tc)
    assert tsp is not None and tsp.layers[0].linear.kind == weights
    ca = prefilled(tc, tp, "bf16")
    cb = ca.copy()
    tok = torch.tensor([[4], [8]])
    for step in range(2):
        pos = torch.full((BATCH, 1), N_PRE + step)
        ref, _ = t_forward(tp, tok, pos, ca, tc, return_logits="top1")
        got, _ = tscan.forward_scan(tsp, tok, pos, cb, tc,
                                    return_logits="top1")
        assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
        assert_caches_equal(ca, cb)
        tok = ref[0][:, None].long()


def test_forward_scan_folded_bf16_scale():
    """bf16 weights with a tensor scale: stacking folds it into the
    weights (one more bf16 rounding, rel 2^-9 a weight), so the scan's
    logits differ from the unrolled forward's by about that: 1e-2 of
    max|logit| bounds it over 4 layers."""
    jc, tc = both_configs(4, (16, 64))
    jp, tp = make_model(jc, tc, "bf16")
    for lp in tp.layers:
        for name in ("qkv_cat", "att_w", "gating1", "gating2", "linear"):
            setattr(lp, name, dataclasses.replace(getattr(lp, name),
                                                  scale=1.3))
    tsp = tscan.build_scan_params(tp, tc)
    assert tsp.layers[0].linear.scale == 1.0
    ca = prefilled(tc, tp, "bf16")
    cb = ca.copy()
    tok = torch.tensor([[4], [8]])
    pos = torch.full((BATCH, 1), N_PRE)
    ref, _ = t_forward(tp, tok, pos, ca, tc, return_logits="last")
    got, _ = tscan.forward_scan(tsp, tok, pos, cb, tc, return_logits="last")
    err = rel_err(got, ref.numpy())
    assert 0 < err <= 1e-2


def test_build_scan_params_refusals():
    """T == 1 (period equals L), and weights whose scales differ per
    layer, give None, as in JAX."""
    jc, tc = both_configs(3)
    tc.attention_window_sizes = [64, 16, 16]
    jc.attention_window_sizes = [64, 16, 16]
    jp, tp = make_model(jc, tc)
    assert tscan.detect_period(tc) == jscan.detect_period(jc) == 3
    assert tscan.build_scan_params(tp, tc) is None
    assert jscan.build_scan_params(jp, jc) is None
    jc, tc = both_configs(4, (16, 64))
    _, tp = make_model(jc, tc, "sfp")
    tp.layers[2].linear = dataclasses.replace(tp.layers[2].linear, scale=0.5)
    assert tscan.build_scan_params(tp, tc) is None


# A period position whose layers sit in both pools: not periodic-affine.
MIXED_MAP = ((True, 0), (False, 0), (False, 1), (True, 1))


def test_pool_affine_refuses_a_mixed_layer_map():
    jc, tc = both_configs(4, (16, 64))
    cache = TKVCache.create(tc, 1, SEQ, local_slack=8, device="cpu")
    assert tscan._pool_affine(cache, 2, 2) == [(True, 0, 1), (False, 0, 1)]
    # Reversed indices are affine too (stride -1), as in JAX.
    rev = dataclasses.replace(cache, layer_map=((True, 1), (False, 0),
                                                (True, 0), (False, 1)))
    assert tscan._pool_affine(rev, 2, 2) == [(True, 1, -1), (False, 0, 1)]
    mixed = dataclasses.replace(cache, layer_map=MIXED_MAP)
    assert tscan._pool_affine(mixed, 2, 2) is None
    _, tp = make_model(jc, tc)
    with pytest.raises(ValueError, match="periodic-affine"):
        tscan.forward_scan(tscan.build_scan_params(tp, tc),
                           torch.tensor([[1]]), torch.tensor([[0]]), mixed,
                           tc)
    assert tscan.scan_plan(tscan.build_scan_params(tp, tc), mixed,
                           tc) is None


def test_scan_plan_made_once_serves_every_step():
    """A plan made once (as the engine makes it per chunk) gives the steps
    of a plan made per call, bit for bit; a plan is refused for another
    cache."""
    jc, tc, jsp, tp, tsp = scan_setup("i8", (16, 64), weights="i8")
    ca = prefilled(tc, tp, "i8")
    cb = ca.copy()
    plan = tscan.scan_plan(tsp, cb, tc)
    assert plan.t_iters == 2 and len(plan.bodies) == 2
    tok = torch.tensor([[3], [11]])
    for step in range(3):
        pos = torch.full((BATCH, 1), N_PRE + step)
        ref, _ = tscan.forward_scan(tsp, tok, pos, ca, tc,
                                    return_logits="top1")
        got, _ = tscan.forward_scan(tsp, tok, pos, cb, tc,
                                    return_logits="top1", plan=plan)
        assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
        assert_caches_equal(ca, cb)
        tok = ref[0][:, None].long()
    with pytest.raises(ValueError, match="another cache"):
        tscan.forward_scan(tsp, tok, pos, ca, tc, plan=plan)


# --- the engine under GEMMA_SCAN_DECODE=1 ------------------------------------


@pytest.fixture(scope="module")
def engine_model():
    jc, tc = both_configs(4, (16, 64))
    _, tp = make_model(jc, tc, "i8", seed=6)
    rng = np.random.default_rng(8)
    prompts = [rng.integers(2, tc.vocab_size, n).tolist() for n in (5, 11)]
    return tc, tp, prompts


def _scan_calls(monkeypatch):
    calls = []
    real = tengine.forward_scan

    def counting(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(tengine, "forward_scan", counting)
    return calls


@pytest.mark.parametrize("runtime", [
    dict(), dict(decode_chunk=1), dict(kv_kind="i8"),
    dict(top_k=8, temperature=0.8, seed=3)],
    ids=["greedy_chunks", "one_step", "i8_kv", "sampled"])
def test_engine_scan_decode_gives_switch_off_tokens(engine_model, monkeypatch,
                                                    runtime):
    tc, tp, prompts = engine_model
    rt = RuntimeConfig(seq_len=SEQ, prefill_tbatch_size=16, **runtime)
    monkeypatch.delenv("GEMMA_SCAN_DECODE", raising=False)
    off = GemmaEngine(tp, tc, rt, device="cpu")
    want = off.generate_batch(prompts, max_generated_tokens=6)
    assert off.scan_params is None
    monkeypatch.setenv("GEMMA_SCAN_DECODE", "1")
    calls = _scan_calls(monkeypatch)
    on = GemmaEngine(tp, tc, rt, device="cpu")
    assert on.scan_params is not None
    assert on.generate_batch(prompts, max_generated_tokens=6) == want
    assert calls, "decode did not run forward_scan"
    monkeypatch.setenv("GEMMA_SCAN_DECODE", "0")
    assert on.scan_params is not None  # read once per engine


def test_engine_generate_fast_scans(engine_model, monkeypatch):
    tc, tp, prompts = engine_model
    rt = RuntimeConfig(seq_len=SEQ, prefill_tbatch_size=16)
    want = GemmaEngine(tp, tc, rt, device="cpu").generate_fast(prompts, 5)
    monkeypatch.setenv("GEMMA_SCAN_DECODE", "1")
    calls = _scan_calls(monkeypatch)
    got = GemmaEngine(tp, tc, rt, device="cpu").generate_fast(prompts, 5)
    np.testing.assert_array_equal(got, want)
    assert len(calls) == 5


def test_engine_routes_a_non_affine_cache_to_the_unrolled_step(
        engine_model, monkeypatch):
    """A cache whose layer_map mixes the pools within a period position
    (a valid cache, laid out for another pattern) decodes through the
    unrolled forward: no forward_scan call, the switch-off tokens.  Here
    the global window is the whole ring of 512, so the engine's cache
    has a local pool (16 + the 256-row slack < 512)."""
    tc, tp, prompts = engine_model
    tc = dataclasses.replace(tc, max_seq_len=512,
                             attention_window_sizes=[16, 512, 16, 512])
    rt = RuntimeConfig(seq_len=512, prefill_tbatch_size=16)

    def shuffled_cache(engine):
        c = engine.new_cache(len(prompts))
        assert c.layer_map == ((True, 0), (False, 0), (True, 1), (False, 1))
        return dataclasses.replace(c, layer_map=MIXED_MAP)

    off = GemmaEngine(tp, tc, rt, device="cpu")
    want = off.generate_batch(prompts, max_generated_tokens=4,
                              cache=shuffled_cache(off))
    monkeypatch.setenv("GEMMA_SCAN_DECODE", "1")
    calls = _scan_calls(monkeypatch)
    on = GemmaEngine(tp, tc, rt, device="cpu")
    assert on.scan_params is not None
    assert on.generate_batch(prompts, max_generated_tokens=4,
                             cache=shuffled_cache(on)) == want
    assert not calls


def test_engine_scan_params_none_when_t_is_1(monkeypatch):
    jc, tc = both_configs(2, (16, 64))
    _, tp = make_model(jc, tc)
    monkeypatch.setenv("GEMMA_SCAN_DECODE", "1")
    assert tscan.detect_period(tc) == 2
    assert GemmaEngine(tp, tc, RuntimeConfig(seq_len=SEQ),
                       device="cpu").scan_params is None


# --- absolute position embeddings --------------------------------------------


@pytest.mark.parametrize("flag", [False, True])
def test_absolute_pe_matches_jax(flag):
    """config.absolute_pe flipped in both packages: prefill logits over
    every position, a decode step, and the scan's decode step agree with
    JAX's (f32 weights and KV: 1e-4 of max|logit|); the flag moves the
    logits."""
    jc, tc = both_configs(4, (16, 64), absolute_pe=flag)
    jp, tp = make_model(jc, tc, seed=9)
    rng = np.random.default_rng(10)
    toks = rng.integers(1, tc.vocab_size, (1, 8))
    tcache = TKVCache.create(tc, 1, SEQ, kind="f32", local_slack=8,
                             device="cpu")
    jcache = JKVCache.create(jc, 1, SEQ, dtype=jnp.float32, local_slack=8)
    want, jcache = j_forward(jp, jnp.asarray(toks, jnp.int32),
                             jnp.arange(8, dtype=jnp.int32)[None], jcache, jc)
    got, _ = t_forward(tp, torch.from_numpy(toks), torch.arange(8)[None],
                       tcache, tc)
    assert rel_err(got, np.asarray(want)) <= 1e-4
    tok, pos = np.array([[7]]), np.array([[8]])
    want_d, _ = j_forward(jp, jnp.asarray(tok, jnp.int32),
                          jnp.asarray(pos, jnp.int32), jcache, jc,
                          return_logits="last")
    scan_cache = tcache.copy()
    got_d, _ = t_forward(tp, torch.from_numpy(tok), torch.from_numpy(pos),
                         tcache, tc, return_logits="last")
    assert rel_err(got_d, np.asarray(want_d)) <= 1e-4
    got_s, _ = tscan.forward_scan(tscan.build_scan_params(tp, tc),
                                  torch.from_numpy(tok),
                                  torch.from_numpy(pos), scan_cache, tc)
    assert torch.equal(got_s, got_d)
    tc.absolute_pe = not flag
    other, _ = t_forward(tp, torch.from_numpy(toks), torch.arange(8)[None],
                         TKVCache.create(tc, 1, SEQ, kind="f32",
                                         local_slack=8, device="cpu"), tc)
    assert rel_err(other, np.asarray(want)) > 1e-2


# --- a file's ViT weights ---------------------------------------------------


def _vlm_file(path, with_vit: bool):
    from gemma_tpu_torch.compression import registry as tcomp
    from gemma_tpu_torch.io.model_store import write_model
    from tests.test_torch_loader import (packed_tensors, tensor_values,
                                         tiny_config as loader_config)

    config = loader_config(tcfg)
    config.vit_config.model_dim = 128
    config.vit_config.layer_configs = [tcfg.LayerConfig(
        model_dim=128, ff_hidden_dim=256, heads=2, kv_heads=2, qkv_dim=64)]
    tensors = packed_tensors(tcomp, tensor_values("stacked", 1), "SFP")
    if with_vit:
        tensors.append(tcomp.compress_tensor(
            tcomp.Type.F32, "img_emb_kernel",
            np.ones((128, 588), np.float32)))
    write_model(path, config, tensors)
    return path


def test_gemma_load_refuses_vit_weights(tmp_path):
    from gemma_tpu_torch.gemma import Gemma

    path = _vlm_file(str(tmp_path / "vit.sbs"), with_vit=True)
    with pytest.raises(NotImplementedError, match="ViT"):
        Gemma.load(path, device="cpu")


def test_gemma_load_takes_a_vlm_config_without_vit_weights(tmp_path):
    from gemma_tpu_torch.gemma import Gemma

    path = _vlm_file(str(tmp_path / "lm.sbs"), with_vit=False)
    g = Gemma.load(path, device="cpu")
    assert g.config.vit_config.layer_configs
    out = g.generate([2, 5, 9], max_generated_tokens=2)
    assert len(out) == 2
