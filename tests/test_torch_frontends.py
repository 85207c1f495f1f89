"""The port's text frontends on the CPU (gemma_tpu_torch: the Gemma facade's
generate_text / chat / save, the HTTP API server with and without the
continuous batcher, the REPL, GemmaContext, GemmaModel, args) on the tiny
on-disk model of tests/test_frontends.py, against the JAX package's
facade on the same file: token ids equal under the margin rule of
tests/test_torch_engine.py, texts equal where every token's margin is
clear."""

import concurrent.futures
import json
import threading
import urllib.request
from http.server import ThreadingHTTPServer

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gemma_tpu.gemma import Gemma as JGemma
from gemma_tpu.models.gemma import forward as j_forward
from gemma_tpu.models.kv_cache import KVCache as JKVCache
from gemma_tpu_torch import api_client
from gemma_tpu_torch.api_server import GemmaService, make_handler
from gemma_tpu_torch.engine import RuntimeConfig
from gemma_tpu_torch.gemma import Gemma
from gemma_tpu_torch.models.gemma import forward as t_forward
from gemma_tpu_torch.models.tokenizer import wrap_and_tokenize
from tests.test_frontends import tiny_model_file
from tests.test_torch_engine import LOGIT_TOL

torch.set_num_threads(1)

SEQ = 64


def _setup(g):
    g.runtime.seq_len = SEQ
    g.runtime.max_generated_tokens = 8
    g.runtime.prefill_tbatch_size = 16
    return g


@pytest.fixture(scope="module")
def model_path(tmp_path_factory):
    return tiny_model_file(tmp_path_factory.mktemp("model"))


@pytest.fixture(scope="module")
def both(model_path):
    return (_setup(JGemma.load(model_path)),
            _setup(Gemma.load(model_path, device="cpu")))


def clear_prefix(jg, tg, prompt_ids, j_out):
    """How many leading tokens of JAX's j_out have a top1-top2 margin
    above twice LOGIT_TOL in JAX's teacher-forced logits; the two
    packages' teacher-forced logits agree within LOGIT_TOL."""
    seq = list(prompt_ids) + list(j_out)
    pad = seq + [0] * (SEQ - len(seq))
    j_log, _ = j_forward(jg.params, jnp.asarray(pad, jnp.int32)[None],
                         jnp.arange(SEQ, dtype=jnp.int32)[None],
                         JKVCache.create(jg.config, 1, SEQ), jg.config,
                         return_logits="all")
    j_log = np.asarray(j_log[0])[:len(seq)]
    t_log, _ = t_forward(tg.params, torch.tensor(seq)[None],
                         torch.arange(len(seq))[None],
                         tg.new_cache(1, SEQ), tg.config,
                         return_logits="all")
    scale = np.abs(j_log).max()
    assert np.abs(t_log[0].numpy() - j_log).max() <= LOGIT_TOL * scale
    for i in range(len(j_out)):
        top2 = np.sort(j_log[len(prompt_ids) - 1 + i])[-2:]
        if top2[1] - top2[0] <= 2 * LOGIT_TOL * scale:
            return i
    return len(j_out)


def assert_same_answer(jg, tg, prompt, n):
    """generate_text of both packages: the ids under the margin rule, the
    text wherever every token is clear.  Returns the port's text and the
    count of clear tokens."""
    ids = wrap_and_tokenize(tg.tokenizer, tg.chat_template,
                            tg.config.wrapping, 0, prompt)
    j_out = jg.generate(ids, max_generated_tokens=n)
    t_out = tg.generate(ids, max_generated_tokens=n)
    k = clear_prefix(jg, tg, ids, j_out)
    assert t_out[:k] == j_out[:k]
    t_text = tg.generate_text(prompt, max_generated_tokens=n)
    if k == len(j_out):
        assert t_text == jg.generate_text(prompt, max_generated_tokens=n)
    return t_text[0], k


def test_load_and_chat(both):
    jg, tg = both
    assert tg.tokenizer.available
    assert tg.tokenizer.serialize() == jg.tokenizer.serialize()
    text, n_prompt, n_out = tg.generate_text("hello world",
                                             max_generated_tokens=4)
    assert isinstance(text, str)
    assert n_prompt > 2 and 0 <= n_out <= 4
    clear = [assert_same_answer(jg, tg, prompt, 6)[1]
             for prompt in ("hello world", "user model hello", "café")]
    assert sum(clear) >= 8, clear  # the margin rule leaves real comparisons
    assert tg.chat("hello", max_generated_tokens=3) == \
        tg.generate_text("hello", max_generated_tokens=3)[0]
    streamed = []
    text, _, n_out = tg.generate_text(
        "world", max_generated_tokens=5,
        stream=lambda piece: streamed.append(piece) or True)
    assert len(streamed) == n_out and "".join(streamed) == text
    with pytest.raises(NotImplementedError, match="queue 4"):
        tg.generate_text("hi", image_batch_size=4)


def test_save_roundtrip(both, tmp_path):
    jg, tg = both
    out = str(tmp_path / "resaved.sbs")
    tg.save(out)
    g2 = Gemma.load(out, device="cpu")
    ids = g2.tokenizer.encode("hello")
    assert ids == tg.tokenizer.encode("hello") == jg.tokenizer.encode("hello")
    assert g2.tokenizer.serialize() == tg.tokenizer.serialize()
    a = tg.generate([2] + ids, max_generated_tokens=3)
    b = g2.generate([2] + ids, max_generated_tokens=3)
    assert a == b
    assert JGemma.load(out).tokenizer.encode("hello world") == \
        tg.tokenizer.encode("hello world")


def _serve(service):
    server = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(service))
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server, f"http://127.0.0.1:{server.server_address[1]}"


def _post(base, verb, body, stream=False):
    req = urllib.request.Request(
        f"{base}/v1beta/models/tiny:{verb}", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        if stream:
            return [e for e in api_client.iter_sse(r)]
        return json.loads(r.read())


def _alone(tg, service, text, n, pos=0, cache=None):
    wrapped = service.wrap_messages(
        [{"role": "user", "parts": [{"text": text}]}])
    return tg.generate_text(wrapped, max_generated_tokens=n, pos=pos,
                            cache=cache)[0]


def test_http_server(both):
    jg, tg = both
    service = GemmaService(tg, model_name="tiny")
    server, base = _serve(service)
    try:
        with urllib.request.urlopen(f"{base}/v1beta/models") as r:
            models = json.loads(r.read())
        assert models["models"][0]["name"] == "models/tiny"

        body = api_client.build_request("hello", None, 1.0, 1, 3)
        resp = _post(base, "generateContent", body)
        assert resp["candidates"][0]["content"]["role"] == "model"
        assert resp["candidates"][0]["finishReason"] == "STOP"
        assert resp["usageMetadata"]["promptTokenCount"] > 0
        text = api_client.extract_text(resp)
        assert text == _alone(tg, service, "hello", 3)
        wrapped = service.wrap_messages(body["contents"])
        assert_same_answer(jg, tg, wrapped, 3)

        # Session continuation: the same sessionId reuses the KV cache,
        # as generate_text with the cache and the position does.
        cache = tg.new_cache(1, SEQ)
        _alone(tg, service, "hello", 3, cache=cache)
        pos = resp["usageMetadata"]["totalTokenCount"]
        resp2 = _post(base, "generateContent", api_client.build_request(
            "world", resp["sessionId"], 1.0, 1, 2))
        assert resp2["usageMetadata"]["totalTokenCount"] > pos
        assert api_client.extract_text(resp2) == _alone(
            tg, service, "world", 2, pos=pos, cache=cache)

        events = _post(base, "streamGenerateContent", body, stream=True)
        assert events[-1]["candidates"][0].get("finishReason") == "STOP"
        assert "".join(api_client.extract_text(e) for e in events[:-1]) \
            == text
    finally:
        server.shutdown()


def test_http_server_continuous(both):
    """continuous=True: concurrent requests share the batcher's decode
    steps; every answer equals the request run alone (one-step decode, as
    the batcher picks on "last" logits), and a session's two turns equal
    generate_text with the cache and the position."""
    _, tg = both
    tg.runtime.decode_chunk = 1
    service = GemmaService(tg, model_name="tiny", continuous=True)
    server, base = _serve(service)
    try:
        prompts = ["hello", "world", "user model", "café", "hello world"]
        with concurrent.futures.ThreadPoolExecutor(5) as pool:
            results = list(pool.map(lambda p: _post(
                base, "generateContent",
                api_client.build_request(p, None, 1.0, 1, 3)), prompts))
        for p, resp in zip(prompts, results):
            assert resp["candidates"][0]["finishReason"] == "STOP"
            assert resp["usageMetadata"]["candidatesTokenCount"] <= 3
            assert api_client.extract_text(resp) == _alone(tg, service, p, 3)

        cache, pos = tg.new_cache(1, SEQ), 0
        for turn in ("first", "second"):
            resp = _post(base, "generateContent", {
                "contents": [{"parts": [{"text": turn}]}],
                "sessionId": "abc", "generationConfig": {
                    "maxOutputTokens": 2}})
            assert resp["sessionId"] == "abc"
            assert resp["candidates"][0]["finishReason"] == "STOP"
            assert api_client.extract_text(resp) == _alone(
                tg, service, turn, 2, pos=pos, cache=cache)
            pos = service.sessions["abc"].abs_pos
        assert pos > 0

        events = _post(base, "streamGenerateContent",
                       api_client.build_request("hello", None, 1.0, 1, 3),
                       stream=True)
        assert "".join(api_client.extract_text(e) for e in events[:-1]) \
            == _alone(tg, service, "hello", 3)
    finally:
        server.shutdown()
        tg.runtime.decode_chunk = 4


def test_continuous_server_thread_stress(both):
    """More client threads than cores against the continuous server, with
    a short switch interval: every answer equals its request run alone and
    the batcher drains (a lost submit or a slot handed to two requests
    would break one or the other)."""
    import os
    import sys

    _, tg = both
    tg.runtime.decode_chunk = 1
    service = GemmaService(tg, model_name="tiny", continuous=True)
    server, base = _serve(service)
    words = ["hello", "world", "user", "model", "café", "hello world"]
    n = min(2 * (os.cpu_count() or 4), 24)
    prompts = [" ".join(words[(i + j) % len(words)] for j in range(1 + i % 3))
               for i in range(n)]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with concurrent.futures.ThreadPoolExecutor(n) as pool:
            futures = [pool.submit(_post, base, "generateContent",
                                   api_client.build_request(p, None, 1.0, 1,
                                                            2 + i % 3))
                       for i, p in enumerate(prompts)]
            results = [f.result(timeout=300) for f in futures]
    finally:
        sys.setswitchinterval(old)
        server.shutdown()
        tg.runtime.decode_chunk = 4
    assert service.batcher.pending == 0 and service.batcher.active == 0
    tg.runtime.decode_chunk = 1
    try:
        for i, (p, resp) in enumerate(zip(prompts, results)):
            assert api_client.extract_text(resp) == _alone(
                tg, service, p, 2 + i % 3), (i, p)
    finally:
        tg.runtime.decode_chunk = 4


def test_repl_noninteractive(model_path, both, capsys):
    from gemma_tpu_torch import run as run_mod

    _, tg = both
    run_mod.main([
        "--weights", model_path, "--prompt", "hello", "--verbosity", "1",
        "--max_generated_tokens", "3", "--seq_len", "64",
        "--prefill_tbatch_size", "16", "--device", "cpu",
    ])
    out = capsys.readouterr()
    assert "[ Timing ] Prefill:" in out.out
    assert "[ Timing ] Generated" in out.out
    assert "[ Reading prompt ]" in out.err
    answer = tg.generate_text("hello", max_generated_tokens=3)[0]
    assert answer.lstrip(" \t\n") in out.out
    with pytest.raises(NotImplementedError, match="queue 4"):
        run_mod.main(["--weights", model_path, "--prompt", "hi",
                      "--device", "cpu", "--image_file", "x.ppm"])


def test_context_conversations(model_path, both):
    from gemma_tpu.bindings.context import GemmaContext as JContext
    from gemma_tpu_torch.bindings.context import ContextGemma, GemmaContext

    jg, tg = both
    assert ContextGemma is GemmaContext
    ctx = GemmaContext.create(model_path, device="cpu",
                              max_generated_tokens=3)
    _setup(ctx.gemma).runtime.max_generated_tokens = 3
    jctx = JContext(jg)
    jg.runtime.max_generated_tokens = 3
    try:
        for c in (ctx, jctx):
            c.set_multiturn(1)
        texts = [(c.generate("hello"), c.generate("world")) for c in
                 (ctx, jctx)]
        assert texts[0] == texts[1]
        assert ctx.active.abs_pos == jctx.active.abs_pos > 0

        ctx.save_conversation()
        saved = ctx.active.cache.kv.clone()
        pos = ctx.active.abs_pos
        ctx.generate("user")
        assert ctx.active.abs_pos > pos
        ctx.reset_conversation()
        assert ctx.active.abs_pos == pos
        assert torch.equal(ctx.active.cache.kv, saved)

        assert ctx.create_conversation("side")
        assert not ctx.create_conversation("side")
        assert ctx.switch_conversation("side")
        assert ctx.generate("hello") == texts[0][0]
        assert ctx.delete_conversation("side")
        assert ctx.current_conversation() == "default"
        assert not ctx.delete_conversation("default")
        logs = []
        GemmaContext.set_log_callback(logs.append)
        ctx.reset_conversation()
        assert logs
        GemmaContext.set_log_callback(None)
        assert ctx.count_tokens("hello world") == jctx.count_tokens(
            "hello world")
        with pytest.raises(NotImplementedError, match="queue 4"):
            ctx.generate("hi", image=object())
    finally:
        jg.runtime.max_generated_tokens = 8


def test_gemma_model(model_path, both):
    from gemma_tpu.gemma_py import GemmaModel as JModel
    from gemma_tpu_torch.gemma_py import GemmaModel

    m = GemmaModel("", model_path, max_generated_tokens=4, seq_len=SEQ,
                   device="cpu")
    m._gemma.runtime.prefill_tbatch_size = 16
    jm = JModel("", model_path, max_generated_tokens=4, seq_len=SEQ)
    jm._gemma.runtime.prefill_tbatch_size = 16
    ids = m.tokenize("hello world")
    assert ids == jm.tokenize("hello world")
    assert m.detokenize(ids) == "hello world"
    assert m.generate("hello", max_generated_tokens=3) == \
        jm.generate("hello", max_generated_tokens=3)
    assert m.generate_batch(["hello", "world"], max_generated_tokens=2) == \
        jm.generate_batch(["hello", "world"], max_generated_tokens=2)
    seen = []
    out = m.generate_ex("hello", stream=lambda t, p: (seen.append(t), True)[1],
                        max_generated_tokens=3)
    assert len(seen) >= len(out)
    allowed = set(m.tokenize("hello world") + [1])
    out = m.generate_ex("hello", accept=lambda t, l: t in allowed,
                        max_generated_tokens=2)
    assert all(t in allowed for t in out)
    assert out == jm.generate_ex("hello", accept=lambda t, l: t in allowed,
                                 max_generated_tokens=2)
    with pytest.raises(NotImplementedError, match="queue 3"):
        m.cross_entropy("hello world")
    for call in (lambda: m.set_image(np.zeros((4, 4, 3))),
                 lambda: m.generate_with_image("hi")):
        with pytest.raises(NotImplementedError, match="queue 4"):
            call()


def test_profiler_zones(capsys, model_path):
    from gemma_tpu_torch.utils import profiler

    profiler.reset()
    with profiler.zone("Test.outer"):
        with profiler.zone("Test.inner"):
            pass
    with profiler.zone("Test.inner"):
        pass
    res = profiler.results()
    assert res["Test.inner"][1] == 2 and res["Test.outer"][1] == 1
    profiler.print_results()
    out = capsys.readouterr().out
    assert "Test.inner" in out and "Zone" in out
    assert not profiler.results()  # reset after print
    profiler.enable(False)
    with profiler.zone("Test.disabled"):
        pass
    assert not profiler.results()
    profiler.enable(True)
    Gemma.load(model_path, device="cpu")
    assert {"Startup.open", "Startup.weights", "Startup.tokenizer"} <= \
        set(profiler.results())
    profiler.reset()


def test_gemma_env(both, capsys):
    from gemma_tpu.evals.benchmark_helper import GemmaEnv as JEnv
    from gemma_tpu_torch.evals.benchmark_helper import (GemmaEnv,
                                                        log_speed_stats,
                                                        show_config)

    jg, tg = both
    env, jenv = GemmaEnv(tg), JEnv(jg)
    for name in ("tokenize", "tokenize_and_prepend_bos", "wrap_and_tokenize"):
        assert getattr(env, name)("hello world") == \
            getattr(jenv, name)("hello world")
    assert env.string_from_tokens([268, 265]) == "hello world"
    r = env.query_model("hello", max_generated_tokens=3)
    assert r.response_start_pos == len(env.wrap_and_tokenize("hello"))
    assert 0 < r.tokens_generated <= 3
    assert vars(r) == vars(jenv.query_model("hello", max_generated_tokens=3))
    batch = env.batch_query_model(["hello", "world"], max_generated_tokens=2)
    want = jenv.batch_query_model(["hello", "world"], max_generated_tokens=2)
    assert [vars(b) for b in batch] == [vars(b) for b in want]
    with pytest.raises(NotImplementedError, match="queue 3"):
        env.cross_entropy("hello")
    show_config(tg)
    log_speed_stats(0.0, 10)
    out = capsys.readouterr().out
    assert "tiny-test" in out and "Devices" in out and "cpu" in out
    assert "10 tokens in" in out


def test_args_match_jax():
    import argparse
    import dataclasses

    from gemma_tpu import args as jargs
    from gemma_tpu_torch import args as targs

    for name in ("LoaderArgs", "InferenceArgs"):
        jf = {f.name: f.default for f in
              dataclasses.fields(getattr(jargs, name))}
        tf = {f.name: f.default for f in
              dataclasses.fields(getattr(targs, name))}
        extra = {"device": ""} if name == "LoaderArgs" else {}
        assert tf == {**jf, **extra}
    parser = argparse.ArgumentParser()
    targs.add_args(parser, targs.LoaderArgs, targs.InferenceArgs)
    ns = parser.parse_args(["--weights", "w.sbs", "--device", "cpu",
                            "--top_k", "5", "--to_bf16", "yes",
                            "--temperature", "0.5", "--kv_kind", "i8",
                            "--decode_qbatch_size", "4", "--verbosity", "2"])
    loader = targs.extract(ns, targs.LoaderArgs)
    inf = targs.extract(ns, targs.InferenceArgs)
    assert (loader.weights, loader.device, loader.to_bf16) == \
        ("w.sbs", "cpu", True)
    rt = targs.runtime_from_args(inf)
    assert isinstance(rt, RuntimeConfig)
    jparser = argparse.ArgumentParser()
    jargs.add_args(jparser, jargs.InferenceArgs)
    jrt = jargs.runtime_from_args(jargs.extract(jparser.parse_args(
        ["--top_k", "5", "--temperature", "0.5", "--kv_kind", "i8",
         "--decode_qbatch_size", "4", "--verbosity", "2"]),
        jargs.InferenceArgs))
    for f in dataclasses.fields(rt):
        if hasattr(jrt, f.name):
            assert getattr(rt, f.name) == getattr(jrt, f.name), f.name
    assert (rt.top_k, rt.decode_qbatch_size, rt.verbosity) == (5, 4, 2)
