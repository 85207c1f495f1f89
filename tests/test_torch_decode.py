"""The port's default greedy decode (gemma_tpu_torch/engine, plain path on
CPU) vs the JAX package's GemmaEngine on the same bridged i8 weights:
multi-step decode chunks through the fused greedy head, bf16/f32/i8 KV
caches, allowed_tokens, accept_token, stream_probs, streaming in bursts
and generate_fast; whole sfp and bf16 models through the same chunks; and
sampled decode (top_k > 1, temperature, seed): chunked against stepwise,
batch composition, allowed_tokens, accept_token and temperature 0.

The model is the reduced Gemma2 shape of tests/test_torch_engine.py with
its embedding rows shrunk to 0.03 of their size and 9 added to the final
norm's weight, so the layers, not the last prompt token, decide each
greedy token (at full embedding size the transcripts repeat one token)
and the head's logits stay far enough apart to compare tokens.

Tolerances (as test_torch_engine.py): the two packages' logits differ by
f32 summation order and rare one-ulp KV roundings, within 5e-3 of
max|logit| under teacher forcing; greedy tokens must agree wherever JAX's
top1-top2 margin exceeds twice that, up to the first closer step."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gemma_tpu.engine import GemmaEngine as JEngine
from gemma_tpu.engine import RuntimeConfig as JRuntime
from gemma_tpu.models.gemma import forward as j_forward
from gemma_tpu.models.kv_cache import KVCache as JKVCache
from gemma_tpu.ops import matmul as jmm
from gemma_tpu_torch.engine import GemmaEngine, RuntimeConfig
from gemma_tpu_torch.models.bridge import params_from_numpy
from gemma_tpu_torch.models.gemma import forward as t_forward
from gemma_tpu_torch.models.kv_cache import KVCache as TKVCache
from tests.test_torch_matmul import (flatten_params, jax_i8_params,
                                     jax_kind_params, small_configs)

torch.set_num_threads(1)

SEQ = 64
NEW = 9          # decode_chunk=4 runs chunks of 4, 4, then one step
LOGIT_TOL = 5e-3
ALLOWED = list(range(3, 512, 8))


@pytest.fixture(scope="module")
def model():
    jc, tc = small_configs(num_layers=2, seq=SEQ, windows=(16, SEQ))
    rng = np.random.default_rng(7)
    jparams = jax_i8_params(jc, rng)
    emb = jparams.embedding
    arrays = dict(emb.arrays, inv_scales=emb.arrays["inv_scales"] * 0.03)
    jparams = dataclasses.replace(
        jparams, embedding=jmm.QuantTensor(emb.kind, emb.shape, emb.scale,
                                           arrays),
        final_norm=jparams.final_norm + 9.0)
    tparams = params_from_numpy(flatten_params(jparams), tc, "cpu")
    prompts = [rng.integers(2, jc.vocab_size, n).tolist() for n in (5, 23, 40)]
    return jc, tc, jparams, tparams, prompts


def _teacher_logits(model, seq, kind):
    """Teacher-forced logits over `seq` from both packages, [len, vocab]."""
    jc, tc, jparams, tparams, _ = model
    jcache = JKVCache.create(jc, 1, SEQ, kind=kind)
    want, _ = j_forward(jparams, jnp.asarray(seq, jnp.int32)[None],
                        jnp.arange(len(seq), dtype=jnp.int32)[None], jcache,
                        jc, return_logits="all")
    tcache = TKVCache.create(tc, 1, SEQ, kind=kind, device="cpu")
    got, _ = t_forward(tparams, torch.tensor(seq)[None],
                       torch.arange(len(seq))[None], tcache, tc,
                       return_logits="all")
    return got[0].numpy(), np.asarray(want[0])


def _check_transcripts(model, got, want, kind="bf16", allowed=None):
    """got == want token by token while JAX's margin is clear; returns
    the number of tokens compared."""
    prompts = model[-1]
    assert [len(g) for g in got] == [len(w) for w in want]
    compared = 0
    for p, g, w in zip(prompts, got, want):
        t_log, j_log = _teacher_logits(model, p + w, kind)
        scale = np.abs(j_log).max()
        assert np.abs(t_log - j_log).max() <= LOGIT_TOL * scale
        if allowed is not None:
            j_log = np.where(allowed[None], j_log, -np.inf)
        for i, tok in enumerate(w):
            top2 = np.sort(j_log[len(p) - 1 + i])[-2:]
            if top2[1] - top2[0] <= 2 * LOGIT_TOL * scale:
                break  # a near tie: the teacher-forced logits above decide
            assert g[i] == tok, (i, g, w)
            compared += 1
    assert compared >= 6  # the margin rule must leave real comparisons
    return compared


def _engines(model, **kw):
    jc, tc, jparams, tparams, _ = model
    return (JEngine(jparams, jc, JRuntime(verbosity=0, **kw)),
            GemmaEngine(tparams, tc, RuntimeConfig(**kw), device="cpu"))


def test_runtime_config_defaults_match_jax():
    """Every field the two RuntimeConfigs share has the same default."""
    mine = {f.name: f.default for f in dataclasses.fields(RuntimeConfig)}
    ref = {f.name: f.default for f in dataclasses.fields(JRuntime)}
    shared = set(mine) & set(ref)
    assert {"decode_chunk", "kv_kind", "top_k", "seq_len", "stream_probs",
            "prefill_tbatch_size", "max_generated_tokens"} <= shared
    assert {n: mine[n] for n in shared} == {n: ref[n] for n in shared}


@pytest.mark.parametrize("kv_kind", ["bf16", "f32", "i8"])
def test_default_decode_matches_jax_engine(model, kv_kind):
    """decode_chunk=4 through the fused head on each KV kind (bf16 is the
    default RuntimeConfig of both packages)."""
    kw = {} if kv_kind == "bf16" else {"kv_kind": kv_kind}
    jeng, teng = _engines(model, **kw)
    assert teng.runtime.decode_chunk == 4
    prompts = model[-1]
    want = jeng.generate_batch(prompts, max_generated_tokens=NEW)
    got = teng.generate_batch(prompts, max_generated_tokens=NEW)
    _check_transcripts(model, got, want, kv_kind)


def _stream(engine, prompts, **kw):
    seen = []

    def stream(qi, pos, token, prob):
        seen.append((qi, pos, token, prob))
        return True

    out = engine.generate_batch(prompts, max_generated_tokens=NEW,
                                stream_token=stream, **kw)
    return out, seen


def _decoded(seen, prompts):
    """The streamed events of generated tokens (after each prompt)."""
    return [s for s in seen if s[1] >= len(prompts[s[0]])]


def test_decode_chunk_matches_stepwise(model):
    """Chunks of 4 through the fused head give the tokens of one-step
    decode over the materialized logits, and the same probs: the plain
    head takes the same argmax over the same capped logits, and its prob
    1/s differs from top1's e_max/s by rounding only (rtol 1e-5)."""
    _, tc, _, tparams, prompts = model
    out = {}
    for chunk in (1, 4):
        eng = GemmaEngine(tparams, tc, RuntimeConfig(decode_chunk=chunk),
                          device="cpu")
        out[chunk] = _stream(eng, prompts)
    assert out[4][0] == out[1][0]
    assert [s[:3] for s in out[4][1]] == [s[:3] for s in out[1][1]]
    np.testing.assert_allclose([s[3] for s in out[4][1]],
                               [s[3] for s in out[1][1]], rtol=1e-5)


def test_allowed_tokens_matches_jax(model):
    """The [vocab] mask rides the fused head in chunks and the NEG_INF
    mask of the one-step path (the ninth token): every token is allowed
    and equals JAX's where the masked margin is clear."""
    jeng, teng = _engines(model)
    prompts = model[-1]
    want = jeng.generate_batch(prompts, max_generated_tokens=NEW,
                               allowed_tokens=ALLOWED)
    got = teng.generate_batch(prompts, max_generated_tokens=NEW,
                              allowed_tokens=ALLOWED)
    assert all(t in ALLOWED for g in got for t in g)
    allowed = np.zeros(model[0].vocab_size, bool)
    allowed[ALLOWED] = True
    _check_transcripts(model, got, want, allowed=allowed)


def test_accept_token_matches_jax(model):
    """accept_token (top_k=1) forces one-step chunks and the host's
    candidate loop; the picks equal JAX's, the prob of a lone accepted
    candidate is 1.0, and the callback saw only real candidates."""
    jeng, teng = _engines(model)
    prompts = model[-1]
    asked = []

    def accept(token, logit):
        asked.append(token)
        return token % 3 == 0

    want = jeng.generate_batch(prompts, max_generated_tokens=NEW,
                               accept_token=lambda t, lg: t % 3 == 0)
    got, seen = _stream(teng, prompts, accept_token=accept)
    assert all(t % 3 == 0 for g in got for t in g)
    assert all(0 <= t < model[0].vocab_size for t in asked)
    assert all(s[3] == 1.0 for s in _decoded(seen, prompts))
    allowed = np.arange(model[0].vocab_size) % 3 == 0
    _check_transcripts(model, got, want, allowed=allowed)


def test_stream_probs_false_keeps_tokens(model):
    """stream_probs=False: the raw-logits argmax gives the same tokens
    (no capped ties at these logits) and every chunked token streams
    prob 1.0."""
    _, tc, _, tparams, prompts = model
    base = _stream(GemmaEngine(tparams, tc, RuntimeConfig(), device="cpu"),
                   prompts)
    noprob = _stream(GemmaEngine(tparams, tc,
                                 RuntimeConfig(stream_probs=False),
                                 device="cpu"), prompts)
    assert noprob[0] == base[0]
    # The first 8 new tokens of a query come from two chunks of 4.
    chunked = [s for s in noprob[1]
               if 0 <= s[1] - len(prompts[s[0]]) < 8]
    assert chunked and all(s[3] == 1.0 for s in chunked)
    assert any(s[3] != 1.0 for s in _decoded(base[1], prompts))


@pytest.mark.parametrize("kv_kind", ["bf16", "i8"])
def test_generate_fast_matches_generate_batch(model, kv_kind):
    """generate_fast runs the same greedy steps without EOS or streaming:
    its tokens extend generate_batch's (which stops at an EOS)."""
    _, tc, _, tparams, prompts = model
    eng = GemmaEngine(tparams, tc, RuntimeConfig(kv_kind=kv_kind),
                      device="cpu")
    fast = eng.generate_fast(prompts, NEW)
    assert fast.shape == (len(prompts), NEW) and fast.dtype == np.int32
    out = eng.generate_batch(prompts, max_generated_tokens=NEW)
    for f, o in zip(fast.tolist(), out):
        assert f[:len(o)] == o


def test_streaming_in_bursts(model):
    """Callbacks of a chunk fire together after the chunk has run: each
    chunk's k tokens per query stream between one chunk and the next, in
    position order, and the stream is the prompt then the output."""
    _, tc, _, tparams, prompts = model
    eng = GemmaEngine(tparams, tc, RuntimeConfig(), device="cpu")
    events = []
    inner = eng._decode_steps

    def decode_steps(*args, **kw):
        events.append(("chunk", args[3]))
        return inner(*args, **kw)

    eng._decode_steps = decode_steps

    def stream(qi, pos, token, prob):
        events.append(("token", qi, pos, token))
        return True

    out = eng.generate_batch(prompts, max_generated_tokens=NEW,
                             stream_token=stream)
    marks = [i for i, e in enumerate(events) if e[0] == "chunk"]
    assert [events[i][1] for i in marks] == [4, 4]  # then one step
    burst = events[marks[0] + 1:marks[1]]
    assert len(burst) == 4 * len(prompts)
    assert [e[1] for e in burst] == [q for _ in range(4)
                                     for q in range(len(prompts))]
    for qi, prompt in enumerate(prompts):
        mine = [e for e in events if e[0] == "token" and e[1] == qi]
        assert [e[3] for e in mine] == prompt + out[qi]
        assert [e[2] for e in mine] == list(range(len(mine)))


# --- the one-byte and dense weight kinds ----------------------------------


@pytest.fixture(scope="module", params=["sfp", "bf16"])
def kind_model(request):
    """The reduced model with all weights of one kind; the embedding rows
    shrunk and the final norm raised as in `model` above."""
    jc, tc = small_configs(num_layers=2, seq=SEQ, windows=(16, SEQ))
    rng = np.random.default_rng(17)
    jparams = jax_kind_params(jc, rng, request.param, emb_rms=0.25 * 0.03)
    jparams = dataclasses.replace(jparams,
                                  final_norm=jparams.final_norm + 9.0)
    tparams = params_from_numpy(flatten_params(jparams), tc, "cpu")
    prompts = [rng.integers(2, jc.vocab_size, n).tolist() for n in (5, 23, 40)]
    return jc, tc, jparams, tparams, prompts


def test_codec_decode_matches_jax_engine(kind_model):
    """A whole sfp model and a whole bf16 model: greedy decode chunks
    through the fused head against the JAX engine, at the i8 model's
    tolerances."""
    jeng, teng = _engines(kind_model)
    prompts = kind_model[-1]
    want = jeng.generate_batch(prompts, max_generated_tokens=NEW)
    got = teng.generate_batch(prompts, max_generated_tokens=NEW)
    _check_transcripts(kind_model, got, want)


# --- sampled decode -------------------------------------------------------

SAMPLED = dict(top_k=8, temperature=0.8, seed=1)


def _sampled_engine(model, **kw):
    _, tc, _, tparams, _ = model
    return GemmaEngine(tparams, tc, RuntimeConfig(**{**SAMPLED, **kw}),
                       device="cpu")


def test_sampled_chunk_matches_stepwise(model):
    """decode_chunk=4 (the fused top-k head, then the draw on [B, k]) gives
    the tokens of decode_chunk=1 (full logits, top-k, the same draw) token
    for token: the stream is keyed by (seed, query, position), not by the
    path.  Probs agree to rtol 1e-5 (the same softmax over the same k
    values)."""
    prompts = model[-1]
    out = {chunk: _stream(_sampled_engine(model, decode_chunk=chunk), prompts)
           for chunk in (1, 4)}
    assert out[4][0] == out[1][0]
    assert [s[:3] for s in out[4][1]] == [s[:3] for s in out[1][1]]
    np.testing.assert_allclose([s[3] for s in out[4][1]],
                               [s[3] for s in out[1][1]], rtol=1e-5)
    greedy = GemmaEngine(model[3], model[1], RuntimeConfig(),
                         device="cpu").generate_batch(
        prompts, max_generated_tokens=NEW)
    assert out[4][0] != greedy  # it does sample
    probs = [s[3] for s in _decoded(out[4][1], prompts)]
    assert all(0.0 < p <= 1.0 for p in probs) and min(probs) < 0.5


def test_sampled_decode_matches_jax_engine(model):
    """The port's stream is JAX's (key words and uniforms bit for bit), and
    on the CPU the draws' float arithmetic agrees closely enough that the
    sampled transcripts are the JAX engine's token for token (a step would
    need a Gumbel margin below ~1e-5 to differ; none here does)."""
    jeng, teng = _engines(model, **SAMPLED)
    prompts = model[-1]
    want = jeng.generate_batch(prompts, max_generated_tokens=NEW)
    got = teng.generate_batch(prompts, max_generated_tokens=NEW)
    assert got == want


def test_sampled_decode_is_reproducible_and_seeded(model):
    prompts = model[-1]
    a = _sampled_engine(model).generate_batch(prompts,
                                              max_generated_tokens=NEW)
    b = _sampled_engine(model).generate_batch(prompts,
                                              max_generated_tokens=NEW)
    c = _sampled_engine(model, seed=2).generate_batch(
        prompts, max_generated_tokens=NEW)
    assert a == b and a != c


def test_sampled_decode_ignores_batch_composition(model):
    """Query 0 gets the same tokens alone as in the batch of three."""
    prompts = model[-1]
    eng = _sampled_engine(model)
    batch = eng.generate_batch(prompts, max_generated_tokens=NEW)
    alone = eng.generate_batch(prompts[:1], max_generated_tokens=NEW)
    assert alone[0] == batch[0]


def test_sampled_temperature_zero_is_greedy(model):
    """T = 0 picks entry 0 of the top-k head: the greedy transcript, in
    chunks and stepwise."""
    _, tc, _, tparams, prompts = model
    greedy = GemmaEngine(tparams, tc, RuntimeConfig(), device="cpu"
                         ).generate_batch(prompts, max_generated_tokens=NEW)
    for chunk in (1, 4):
        got = _sampled_engine(model, temperature=0.0, decode_chunk=chunk
                              ).generate_batch(prompts,
                                               max_generated_tokens=NEW)
        assert got == greedy


@pytest.mark.parametrize("chunk", [1, 4])
def test_sampled_allowed_tokens_stay_in_the_set(model, chunk):
    """top_k=3 under allowed_tokens: the mask rides the top-k head (and
    NEG_INF on the one-step path), so no draw leaves the set."""
    prompts = model[-1]
    few = ALLOWED[:5]
    got = _sampled_engine(model, top_k=3, decode_chunk=chunk).generate_batch(
        prompts, max_generated_tokens=NEW, allowed_tokens=few)
    assert all(t in few for g in got for t in g)
    assert len({t for g in got for t in g}) > 1
    # Fewer allowed tokens than top_k: the dead entries are never drawn.
    two = _sampled_engine(model, top_k=3, decode_chunk=chunk).generate_batch(
        prompts, max_generated_tokens=NEW, allowed_tokens=few[:2])
    assert all(t in few[:2] for g in two for t in g)


def test_sampled_accept_token_matches_jax(model):
    """accept_token with top_k > 1: one-step chunks, the host's candidate
    loop over the top_k best accepted tokens, and a uniform of the
    (seed, query, position) stream, which equals JAX's bit for bit; the
    picks equal the JAX engine's wherever its logits leave the candidate
    set and the inverse-CDF pick clear of rounding (all steps here)."""
    jeng, _ = _engines(model, **SAMPLED)
    teng = _sampled_engine(model)
    prompts = model[-1]
    want = jeng.generate_batch(prompts, max_generated_tokens=NEW,
                               accept_token=lambda t, lg: t % 3 == 0)
    got, seen = _stream(teng, prompts, accept_token=lambda t, lg: t % 3 == 0)
    assert all(t % 3 == 0 for g in got for t in g)
    probs = [s[3] for s in _decoded(seen, prompts)]
    assert all(0.0 < p <= 1.0 for p in probs) and min(probs) < 1.0
    assert got == want
