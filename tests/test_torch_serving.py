"""The port's continuous batcher (gemma_tpu_torch/engine/serving.py, plain
path on the CPU): the cases of tests/test_serving.py on the port, whose
batcher must give exactly the port's one-at-a-time tokens, and its tokens
against the JAX package's ContinuousBatcher on the same bridged i8 weights
under the margin rule of tests/test_torch_engine.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gemma_tpu.engine import GemmaEngine as JEngine
from gemma_tpu.engine import RuntimeConfig as JRuntime
from gemma_tpu.engine.serving import ContinuousBatcher as JBatcher
from gemma_tpu.engine.serving import Request as JRequest
from gemma_tpu.models.gemma import forward as j_forward
from gemma_tpu.models.kv_cache import KVCache as JKVCache
from gemma_tpu_torch.engine import GemmaEngine, RuntimeConfig
from gemma_tpu_torch.engine.serving import ContinuousBatcher, Request
from gemma_tpu_torch.models.bridge import params_from_numpy
from gemma_tpu_torch.models.gemma import forward as t_forward
from gemma_tpu_torch.models.kv_cache import (KVCache, extract_slot,
                                             insert_slot)
from tests.test_torch_engine import LOGIT_TOL
from tests.test_torch_matmul import (flatten_params, jax_i8_params,
                                     small_configs)

torch.set_num_threads(1)

SEQ = 48
TEACHER_LEN = 32


def _engines(seq=SEQ, windows=(16, SEQ), seed=7):
    """Both packages' engines on the same i8 weights, EOS off (a random
    model would retire requests by accident), prefill pinned to 8-token
    rounds, two slots.  The port's one-at-a-time decode takes one-step
    chunks: the batcher picks on "last" logits, as decode_chunk=1 does."""
    jc, tc = small_configs(num_layers=2, seq=seq, windows=windows)
    for c in (jc, tc):
        c.eos_id = c.secondary_eos_id = -1
    rng = np.random.default_rng(seed)
    jparams = jax_i8_params(jc, rng)
    tparams = params_from_numpy(flatten_params(jparams), tc, "cpu")
    jeng = JEngine(jparams, jc, JRuntime(
        seq_len=seq, prefill_tbatch_size=8, decode_qbatch_size=2,
        verbosity=0))
    teng = GemmaEngine(tparams, tc, RuntimeConfig(
        seq_len=seq, prefill_tbatch_size=8, decode_qbatch_size=2,
        decode_chunk=1), device="cpu")
    return jc, tc, jparams, tparams, jeng, teng


@pytest.fixture(scope="module")
def engines():
    return _engines()


@pytest.fixture(scope="module")
def engine(engines):
    return engines[-1]


def _held_to_jax(engines, prompts, got, want):
    """got (the port's) equals want (the JAX package's) token for token
    up to each request's first near tie of JAX's teacher-forced logits;
    the teacher-forced logits of both agree within LOGIT_TOL."""
    jc, tc, jparams, tparams, _, _ = engines
    compared = 0
    for p, g, w in zip(prompts, got, want):
        # Padded to one length (causal: the padding moves no earlier
        # logit), so JAX compiles the forward once.
        seq = [int(t) for t in p] + w
        seq += [0] * (TEACHER_LEN - len(seq))
        jcache = JKVCache.create(jc, 1, SEQ)
        j_log, _ = j_forward(jparams, jnp.asarray(seq, jnp.int32)[None],
                             jnp.arange(len(seq), dtype=jnp.int32)[None],
                             jcache, jc, return_logits="all")
        j_log = np.asarray(j_log[0])
        tcache = KVCache.create(tc, 1, SEQ, device="cpu")
        t_log, _ = t_forward(tparams, torch.tensor(seq)[None],
                             torch.arange(len(seq))[None], tcache, tc,
                             return_logits="all")
        scale = np.abs(j_log).max()
        assert np.abs(t_log[0].numpy() - j_log).max() <= LOGIT_TOL * scale
        for i, tok in enumerate(w):
            top2 = np.sort(j_log[len(p) - 1 + i])[-2:]
            if top2[1] - top2[0] <= 2 * LOGIT_TOL * scale:
                break
            assert g[i] == tok, (i, g, w)
            compared += 1
    return compared


def test_continuous_matches_individual(engines):
    *_, jeng, engine = engines
    rng = np.random.default_rng(1)
    prompts = [list(rng.integers(2, 500, n)) for n in (3, 5, 7, 4, 6)]
    max_tokens = 6
    want = [engine.generate(p, max_generated_tokens=max_tokens)
            for p in prompts]

    batcher = ContinuousBatcher(engine, slots=2, seq_len=SEQ)
    reqs = [batcher.submit(Request(p, max_tokens=max_tokens))
            for p in prompts]
    batcher.run_until_idle()
    assert all(r.done for r in reqs)
    assert [r.output for r in reqs] == want

    jb = JBatcher(jeng, slots=2, seq_len=SEQ)
    jreqs = [jb.submit(JRequest(p, max_tokens=max_tokens)) for p in prompts]
    jb.run_until_idle()
    assert _held_to_jax(engines, prompts, want,
                        [r.output for r in jreqs]) >= 10


def test_streaming_and_early_stop(engine):
    batcher = ContinuousBatcher(engine, slots=2, seq_len=SEQ)
    seen = []

    def on_token(req, tok):
        seen.append((req.request_id, tok))
        return len([t for r, t in seen if r == req.request_id]) < 2

    req = batcher.submit(Request([2, 5, 9], max_tokens=10,
                                 on_token=on_token))
    batcher.run_until_idle()
    assert req.done
    assert len(req.output) == 2  # stopped by callback
    assert [t for _, t in seen] == req.output


def test_slot_reuse_no_leak(engine):
    """A long request decoding while short ones cycle through the other
    slot is not corrupted by slot reuse."""
    rng = np.random.default_rng(2)
    long_prompt = list(rng.integers(2, 500, 8))
    want = engine.generate(long_prompt, max_generated_tokens=10)

    batcher = ContinuousBatcher(engine, slots=2, seq_len=SEQ)
    long_req = batcher.submit(Request(long_prompt, max_tokens=10))
    for n in (3, 4, 5, 3):
        batcher.submit(Request(list(rng.integers(2, 500, n)), max_tokens=2))
    batcher.run_until_idle()
    assert long_req.output == want


def test_chunked_admission_matches_individual(engines):
    """Prompts longer than admission_chunk prefill across several ticks and
    still generate exactly the one-at-a-time tokens."""
    *_, jeng, engine = engines
    rng = np.random.default_rng(3)
    prompts = [list(rng.integers(2, 500, n)) for n in (17, 23, 5)]
    want = [engine.generate(p, max_generated_tokens=5) for p in prompts]

    batcher = ContinuousBatcher(engine, slots=2, seq_len=SEQ,
                                admission_chunk=4)
    reqs = [batcher.submit(Request(p, max_tokens=5)) for p in prompts]
    batcher.run_until_idle()
    assert [r.output for r in reqs] == want

    jb = JBatcher(jeng, slots=2, seq_len=SEQ, admission_chunk=4)
    jreqs = [jb.submit(JRequest(p, max_tokens=5)) for p in prompts]
    jb.run_until_idle()
    assert _held_to_jax(engines, prompts, want,
                        [r.output for r in jreqs]) >= 6


def test_admission_does_not_stall_decodes(engine):
    """While a long prompt is admitted chunk by chunk, an in-flight request
    gains a token every tick."""
    rng = np.random.default_rng(4)
    batcher = ContinuousBatcher(engine, slots=2, seq_len=SEQ,
                                admission_chunk=4)
    short = batcher.submit(Request([2, 5, 9], max_tokens=20))
    batcher.step()  # admit + first decode
    assert len(short.output) == 1

    long_req = batcher.submit(Request(list(rng.integers(2, 500, 21)),
                                      max_tokens=3))
    before = len(short.output)
    ticks = 0
    while long_req.output == [] and ticks < 10:
        batcher.step()
        ticks += 1
        assert len(short.output) == before + ticks, "decode stalled"
    assert long_req.output, "long request never started decoding"
    batcher.run_until_idle()
    assert long_req.output == engine.generate(
        list(long_req.prompt_ids), max_generated_tokens=3)


def test_admission_ring_aliasing_regression():
    """While a long prompt admits into a sliding-window ring, the other
    slots' shared decode steps must not write real ring rows: a row at a
    padding slot's stale pos can alias a still-attended position of the
    admitting prompt (tests/test_serving.py:120).  A ring of 24 rows and a
    60-token prompt make the window wrap mid-admission."""
    jc, tc, _, _, jeng, eng = _engines(seq=96, windows=(8, 96), seed=11)
    rng = np.random.default_rng(11)
    long_prompt = [int(t) for t in rng.integers(2, 500, 60)]
    want = eng.generate(list(long_prompt), max_generated_tokens=4)

    batcher = ContinuousBatcher(eng, slots=2, seq_len=96, admission_chunk=8)
    batcher.cache = KVCache.create(tc, 2, 96, local_slack=16, device="cpu")
    assert batcher.cache.kv_local is not None
    ring = batcher.cache.seq_len_local
    assert ring == 24

    batcher.submit(Request([2, 5, 9], max_tokens=3))
    batcher.submit(Request(list(long_prompt), max_tokens=4))
    batcher.cache.kv_local.fill_(-5.0)
    batcher.step()  # slot 0 decodes, slot 1 prefills its first chunk
    kvl = batcher.cache.kv_local
    chunk_rows = set(range(0, 8))
    garbage_alias = 59 % ring
    assert garbage_alias not in chunk_rows
    assert torch.all(kvl[1, :, :, :, garbage_alias] == -5.0), (
        "padding-slot decode wrote a real ring row of the admitting slot")
    untouched = [r for r in range(ring) if r not in chunk_rows]
    assert torch.all(kvl[1, :, :, :, untouched] == -5.0)

    b2 = ContinuousBatcher(eng, slots=2, seq_len=96, admission_chunk=8)
    b2.cache = KVCache.create(tc, 2, 96, local_slack=16, device="cpu")
    s2 = b2.submit(Request([2, 5, 9], max_tokens=3))
    l2 = b2.submit(Request(list(long_prompt), max_tokens=4))
    b2.run_until_idle()
    assert s2.done and l2.done
    assert l2.output == want


def test_session_joins_decode_waves(engine):
    """A session follow-up (a batch-1 KVCache and its position) is admitted
    into a slot by copying its rows, shares decode steps with another
    request, and matches the serialized two-turn conversation; the rows
    handed back carry a third turn."""
    rng = np.random.default_rng(5)
    turn1 = [int(t) for t in rng.integers(2, 500, 5)]
    turn2 = [int(t) for t in rng.integers(2, 500, 4)]
    other = [int(t) for t in rng.integers(2, 500, 6)]

    oracle_cache = engine.new_cache(1, SEQ)
    out1 = engine.generate(turn1, max_generated_tokens=4,
                           cache=oracle_cache, start_pos=0)
    pos1 = len(turn1) + len(out1)
    want2 = engine.generate(turn2, max_generated_tokens=4,
                            cache=oracle_cache, start_pos=pos1)

    session_cache = engine.new_cache(1, SEQ)
    batcher = ContinuousBatcher(engine, slots=2, seq_len=SEQ)
    r1 = batcher.submit(Request(turn1, max_tokens=4, cache=session_cache,
                                start_pos=0))
    batcher.run_until_idle()
    assert r1.output == out1
    assert r1.end_pos == pos1

    r2 = batcher.submit(Request(turn2, max_tokens=4, cache=session_cache,
                                start_pos=r1.end_pos))
    r3 = batcher.submit(Request(other, max_tokens=4))
    batcher._admit()
    batcher._advance_admissions()
    assert batcher.decoding == 2, "session follow-up must share the wave"
    batcher.run_until_idle()
    assert r2.output == want2
    assert r3.output == engine.generate(other, max_generated_tokens=4)
    turn3 = [int(t) for t in rng.integers(2, 500, 3)]
    want3 = engine.generate(turn3, max_generated_tokens=3,
                            cache=oracle_cache, start_pos=r2.end_pos)
    got3 = engine.generate(turn3, max_generated_tokens=3,
                           cache=session_cache, start_pos=r2.end_pos)
    assert got3 == want3


def test_slot_insert_and_extract(engine):
    batched = engine.new_cache(2, SEQ)
    single = engine.new_cache(1, SEQ)
    for t in single.tensors():
        if t is not None:
            t.copy_(torch.randn(t.shape).to(t.dtype))
    insert_slot(batched, single, 1)
    back = extract_slot(batched, 1)
    for a, b, c in zip(single.tensors(), back.tensors(), batched.tensors()):
        if a is not None:
            assert torch.equal(a, b) and torch.equal(c[1:2], a)
            assert not c[0].any()
            assert b.data_ptr() != c.data_ptr()
    kept = single.kv
    single.assign(back)
    assert single.kv is back.kv and single.kv is not kept


@pytest.mark.parametrize("wrong", ["batch2", "seq_len", "kv_kind"])
def test_session_cache_layout_guard(engines, wrong):
    """Mismatched session caches are rejected at submit, not mid-wave."""
    _, tc, _, tparams, _, engine = engines
    batcher = ContinuousBatcher(engine, slots=2, seq_len=SEQ)
    cache = {
        "batch2": lambda: engine.new_cache(2, SEQ),
        "seq_len": lambda: engine.new_cache(1, SEQ - 16),
        "kv_kind": lambda: GemmaEngine(
            tparams, tc, RuntimeConfig(seq_len=SEQ, prefill_tbatch_size=8,
                                       kv_kind="i8"),
            device="cpu").new_cache(1, SEQ),
    }[wrong]()
    with pytest.raises(ValueError, match="session cache"):
        batcher.submit(Request([2, 3], cache=cache, start_pos=0))
    assert batcher.pending == 0
