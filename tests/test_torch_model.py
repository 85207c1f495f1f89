"""The port's forward pass (gemma_tpu_torch/models/gemma.py, plain path on
CPU) vs the JAX package's `forward` on a reduced Gemma2-shaped i8 model
(and whole sfp and bf16 models) with an i8 KV cache, weights carried
across with the bridge; the fused top1 and top-k heads included.

Two cache layouts: the windows of tests/test_parity_full.py (local
windows of 16 at a 64 ring, one pool) and a small local slack that splits
the cache into a local and a global pool.  Prompts go in chunks of at
most 16 tokens, the slack, as the engine's chunked prefill does."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gemma_tpu.models.gemma import forward as j_forward
from gemma_tpu.models.kv_cache import KVCache as JKVCache
from gemma_tpu_torch.models.bridge import params_from_numpy
from gemma_tpu_torch.models.gemma import forward as t_forward
from gemma_tpu_torch.models.kv_cache import KVCache as TKVCache
from tests.test_torch_matmul import (flatten_params, jax_i8_params,
                                     jax_kind_params, small_configs)

torch.set_num_threads(1)

SEQ, T, LAYERS = 64, 33, 4
# Full-forward logit tolerance of the JAX suite for i8 KV
# (tests/test_parity_full.py:149-154): 2e-2 of max|logit|.  The two
# packages run the same math in another f32 summation order; a re-quantized
# KV code can move by one, which the bound absorbs across the layers.
TOL = 2e-2


@pytest.fixture(scope="module")
def model():
    jc, tc = small_configs(num_layers=LAYERS, seq=SEQ, windows=(16, SEQ))
    rng = np.random.default_rng(42)
    jparams = jax_i8_params(jc, rng)
    tparams = params_from_numpy(flatten_params(jparams), tc, "cpu")
    tokens = rng.integers(2, jc.vocab_size, T).astype(np.int32)
    return jc, tc, jparams, tparams, tokens


def _caches(jc, tc, slack):
    kw = {} if slack is None else {"local_slack": slack}
    jcache = JKVCache.create(jc, 1, SEQ, kind="i8", **kw)
    tcache = TKVCache.create(tc, 1, SEQ, kind="i8", device="cpu", **kw)
    assert (jcache.kv_local is None) == (tcache.kv_local is None)
    return jcache, tcache


# Chunk bounds: every chunk <= the local slack of 16.  ALL ends with a
# one-token step; PREFILL's last chunk is a 16-token prefill.
ALL = (0, 16, 32, T)
PREFILL = (0, 1, 17, T)


def _run_jax(jparams, jc, jcache, tokens, bounds, ret="all"):
    outs = []
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        out, jcache = j_forward(
            jparams, jnp.asarray(tokens[lo:hi])[None],
            jnp.arange(lo, hi, dtype=jnp.int32)[None], jcache, jc,
            return_logits=ret)
        outs.append(out)
    return outs, jcache


def _run_torch(tparams, tc, tcache, tokens, bounds, ret="all"):
    outs = []
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        out, _ = t_forward(tparams, torch.from_numpy(tokens[lo:hi])[None],
                           torch.arange(lo, hi)[None], tcache, tc,
                           return_logits=ret)
        outs.append(out)
    return outs


def _max_rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("slack", [None, 16])
def test_prefill_all_logits_match_jax(model, slack):
    jc, tc, jparams, tparams, tokens = model
    jcache, tcache = _caches(jc, tc, slack)
    want, jcache = _run_jax(jparams, jc, jcache, tokens, ALL)
    want = np.concatenate([np.asarray(w) for w in want], axis=1)
    got = torch.cat(_run_torch(tparams, tc, tcache, tokens, ALL), dim=1)
    assert got.shape == want.shape and torch.isfinite(got).all()
    assert _max_rel(got.numpy(), want) <= TOL
    # The prefill scatter wrote the same i8 rows (a code may move by one
    # where the residual stream differs in its last bits).
    for jp, tp in ((jcache.kv, tcache.kv), (jcache.kv_local, tcache.kv_local)):
        if jp is None:
            continue
        diff = np.abs(np.asarray(jp).astype(np.int32) - tp.numpy())
        assert diff.max() <= 1 and (diff > 0).mean() <= 0.01


@pytest.mark.parametrize("slack", [None, 16])
def test_prefill_then_decode_matches_jax(model, slack):
    """Prefill T-1 tokens ("none"), then one decode step ("last")."""
    jc, tc, jparams, tparams, tokens = model
    jcache, tcache = _caches(jc, tc, slack)
    _, jcache = _run_jax(jparams, jc, jcache, tokens[:-1], ALL[:-1], "none")
    want, _ = j_forward(jparams, jnp.asarray(tokens[-1:])[None],
                        jnp.asarray([[T - 1]], jnp.int32), jcache, jc,
                        return_logits="last")
    _run_torch(tparams, tc, tcache, tokens[:-1], ALL[:-1], "none")
    got, _ = t_forward(tparams, torch.from_numpy(tokens[-1:])[None],
                       torch.tensor([[T - 1]]), tcache, tc,
                       return_logits="last")
    assert got.shape == (1, jc.vocab_size)
    assert _max_rel(got.numpy(), np.asarray(want)) <= TOL


@pytest.mark.parametrize("slack", [None, 16])
def test_decode_matches_prefill(model, slack):
    """The port's own check (tests/test_parity_full.py:133-154): decode's
    last logits == the prefill path's last row, within the i8-KV bound."""
    _, tc, _, tparams, tokens = model
    kw = {} if slack is None else {"local_slack": slack}
    cache = TKVCache.create(tc, 1, SEQ, kind="i8", device="cpu", **kw)
    full = _run_torch(tparams, tc, cache, tokens, PREFILL)[-1]
    cache = TKVCache.create(tc, 1, SEQ, kind="i8", device="cpu", **kw)
    got = _run_torch(tparams, tc, cache, tokens, ALL, "last")[-1]
    assert _max_rel(got[0].numpy(), full[0, -1].numpy()) <= TOL


def test_fused_heads_raise(model):
    """The fused top-k head needs its k; an unknown head is refused."""
    _, tc, _, tparams, tokens = model
    cache = TKVCache.create(tc, 1, SEQ, kind="i8", device="cpu")
    args = (tparams, torch.from_numpy(tokens[:1])[None],
            torch.zeros(1, 1, dtype=torch.int64), cache, tc)
    with pytest.raises(ValueError, match="top_k_n"):
        t_forward(*args, return_logits="topk")
    with pytest.raises(ValueError, match="top9"):
        t_forward(*args, return_logits="top9")


@pytest.mark.parametrize("masked", [False, True])
def test_topk_head_matches_jax(model, masked):
    """Prefill T-1 tokens, then one decode step through the fused top-k
    head in both packages: values within the i8-KV logit bound, indices
    equal wherever both neighbours are further apart than twice it, and
    every JAX candidate clear of the cut-off by twice it is in the port's
    list (and the reverse)."""
    jc, tc, jparams, tparams, tokens = model
    jcache, tcache = _caches(jc, tc, 16)
    _, jcache = _run_jax(jparams, jc, jcache, tokens[:-1], ALL[:-1], "none")
    _run_torch(tparams, tc, tcache, tokens[:-1], ALL[:-1], "none")
    mask = None
    if masked:
        mask = np.arange(jc.vocab_size) % 3 != 0
    k = 8
    (jv, ji), _ = j_forward(
        jparams, jnp.asarray(tokens[-1:])[None],
        jnp.asarray([[T - 1]], jnp.int32), jcache, jc, return_logits="topk",
        top_k_n=k, top1_mask=None if mask is None else jnp.asarray(mask))
    (tv, ti), _ = t_forward(
        tparams, torch.from_numpy(tokens[-1:])[None], torch.tensor([[T - 1]]),
        tcache, tc, return_logits="topk", top_k_n=k,
        top1_mask=None if mask is None else torch.from_numpy(mask))
    assert tv.shape == ti.shape == (1, k) and ti.dtype == torch.int32
    jv, ji, tv, ti = (np.asarray(x)[0] for x in (jv, ji, tv, ti))
    bound = TOL * np.abs(jv).max()
    assert np.abs(tv - jv).max() <= bound
    gap = np.abs(np.diff(jv)) > 2 * bound
    pinned = np.ones(k, bool)
    pinned[1:] &= gap
    pinned[:-1] &= gap
    assert pinned[0]
    np.testing.assert_array_equal(ti[pinned], ji[pinned])
    for (av, ai), (_, bi) in (((jv, ji), (tv, ti)), ((tv, ti), (jv, ji))):
        inside = ai[av > av[-1] + 2 * bound]
        assert len(inside) >= 2 and set(inside) <= set(bi)
    if mask is not None:
        assert mask[ti].all()


@pytest.fixture(scope="module", params=["sfp", "bf16"])
def kind_model(request):
    jc, tc = small_configs(num_layers=LAYERS, seq=SEQ, windows=(16, SEQ))
    rng = np.random.default_rng(43)
    jparams = jax_kind_params(jc, rng, request.param)
    tparams = params_from_numpy(flatten_params(jparams), tc, "cpu")
    assert tparams.embedding.kind == request.param
    tokens = rng.integers(2, jc.vocab_size, T).astype(np.int32)
    return jc, tc, jparams, tparams, tokens


@pytest.mark.parametrize("slack", [None, 16])
def test_codec_model_prefill_logits_match_jax(kind_model, slack):
    """A whole sfp model and a whole bf16 model: chunked prefill logits
    against JAX at the i8 model's tolerance."""
    jc, tc, jparams, tparams, tokens = kind_model
    jcache, tcache = _caches(jc, tc, slack)
    want, _ = _run_jax(jparams, jc, jcache, tokens, ALL)
    want = np.concatenate([np.asarray(w) for w in want], axis=1)
    got = torch.cat(_run_torch(tparams, tc, tcache, tokens, ALL), dim=1)
    assert got.shape == want.shape and torch.isfinite(got).all()
    assert _max_rel(got.numpy(), want) <= TOL


def test_codec_model_decode_matches_prefill(kind_model):
    """Decode's last logits == the prefill path's last row (the port's own
    check, as test_decode_matches_prefill), for sfp and bf16 weights."""
    _, tc, _, tparams, tokens = kind_model
    cache = TKVCache.create(tc, 1, SEQ, kind="i8", device="cpu")
    full = _run_torch(tparams, tc, cache, tokens, PREFILL)[-1]
    cache = TKVCache.create(tc, 1, SEQ, kind="i8", device="cpu")
    got = _run_torch(tparams, tc, cache, tokens, ALL, "last")[-1]
    assert _max_rel(got[0].numpy(), full[0, -1].numpy()) <= TOL


@pytest.mark.parametrize("need_prob", [True, False])
def test_top1_head_matches_jax(model, need_prob):
    """Prefill T-1 tokens, then one decode step through the fused greedy
    head in both packages: the same token where JAX's capped margin
    clears the i8-KV logit bound, and probs within it (the prob moves
    with exp of the logit error: ~2e-2 relative at most here)."""
    jc, tc, jparams, tparams, tokens = model
    jcache, tcache = _caches(jc, tc, 16)
    _, jcache = _run_jax(jparams, jc, jcache, tokens[:-1], ALL[:-1], "none")
    _run_torch(tparams, tc, tcache, tokens[:-1], ALL[:-1], "none")
    logits, _ = j_forward(jparams, jnp.asarray(tokens[-1:])[None],
                          jnp.asarray([[T - 1]], jnp.int32), jcache, jc,
                          return_logits="last")
    (jt, jp), _ = j_forward(jparams, jnp.asarray(tokens[-1:])[None],
                            jnp.asarray([[T - 1]], jnp.int32), jcache, jc,
                            return_logits="top1", top1_need_prob=need_prob)
    (tt, tp), _ = t_forward(tparams, torch.from_numpy(tokens[-1:])[None],
                            torch.tensor([[T - 1]]), tcache, tc,
                            return_logits="top1", top1_need_prob=need_prob)
    assert tt.dtype == torch.int32 and tt.shape == (1,)
    top2 = np.sort(np.asarray(logits[0]))[-2:]
    assert top2[1] - top2[0] > TOL * np.abs(np.asarray(logits)).max()
    assert int(tt[0]) == int(jt[0])
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=2e-2)
