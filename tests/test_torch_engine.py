"""The port's engine (gemma_tpu_torch/engine, plain path on CPU) vs the JAX
package's GemmaEngine on the same bridged i8 weights: greedy decode with
decode_chunk=1, an i8 KV cache and ragged prompts prefilled in 16-token
rounds with padded slots.  tests/test_torch_decode.py covers the default
runtime (decode chunks through the fused head, bf16 KV)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gemma_tpu.engine import GemmaEngine as JEngine
from gemma_tpu.engine import RuntimeConfig as JRuntime
from gemma_tpu.models.gemma import forward as j_forward
from gemma_tpu.models.kv_cache import KVCache as JKVCache
from gemma_tpu_torch.engine import GemmaEngine, RuntimeConfig
from gemma_tpu_torch.models.bridge import params_from_numpy
from gemma_tpu_torch.models.gemma import forward as t_forward
from gemma_tpu_torch.models.kv_cache import KVCache as TKVCache
from tests.test_torch_matmul import (flatten_params, jax_i8_params,
                                     small_configs)

torch.set_num_threads(1)

SEQ, NEW = 64, 8
# Logit tolerance, relative to max|logit|: the port's plain path and the
# JAX forward differ by f32 summation order and, rarely, one KV code
# (test_torch_model.py measures ~2e-3 on the same kind of model); 5e-3
# bounds it.  Greedy tokens must agree wherever JAX's top1-top2 margin
# exceeds twice that.
LOGIT_TOL = 5e-3


@pytest.fixture(scope="module")
def engines():
    jc, tc = small_configs(num_layers=2, seq=SEQ, windows=(16, SEQ))
    rng = np.random.default_rng(7)
    jparams = jax_i8_params(jc, rng)
    tparams = params_from_numpy(flatten_params(jparams), tc, "cpu")
    jeng = JEngine(jparams, jc, JRuntime(
        prefill_tbatch_size=16, seq_len=SEQ, decode_chunk=1, kv_kind="i8",
        top_k=1, verbosity=0))
    teng = GemmaEngine(tparams, tc, RuntimeConfig(
        prefill_tbatch_size=16, seq_len=SEQ, decode_chunk=1, kv_kind="i8",
        top_k=1), device="cpu")
    prompts = [rng.integers(2, jc.vocab_size, n).tolist() for n in (5, 23, 40)]
    return jc, tc, jparams, tparams, jeng, teng, prompts


def _teacher_logits(jc, tc, jparams, tparams, seq):
    """Teacher-forced logits over `seq` from both packages, [len, vocab]."""
    jcache = JKVCache.create(jc, 1, SEQ, kind="i8")
    want, _ = j_forward(jparams, jnp.asarray(seq, jnp.int32)[None],
                        jnp.arange(len(seq), dtype=jnp.int32)[None], jcache,
                        jc, return_logits="all")
    tcache = TKVCache.create(tc, 1, SEQ, kind="i8", device="cpu")
    got, _ = t_forward(tparams, torch.tensor(seq)[None],
                       torch.arange(len(seq))[None], tcache, tc,
                       return_logits="all")
    return got[0].numpy(), np.asarray(want[0])


def test_generate_batch_matches_jax_engine(engines):
    jc, tc, jparams, tparams, jeng, teng, prompts = engines
    want = jeng.generate_batch(prompts, max_generated_tokens=NEW)
    got = teng.generate_batch(prompts, max_generated_tokens=NEW)
    assert [len(g) for g in got] == [len(w) for w in want]
    compared = 0
    for p, g, w in zip(prompts, got, want):
        seq = p + w
        t_log, j_log = _teacher_logits(jc, tc, jparams, tparams, seq)
        scale = np.abs(j_log).max()
        assert np.abs(t_log - j_log).max() <= LOGIT_TOL * scale
        for i, tok in enumerate(w):
            row = j_log[len(p) - 1 + i]
            top2 = np.sort(row)[-2:]
            if top2[1] - top2[0] <= 2 * LOGIT_TOL * scale:
                break  # a near tie: the teacher-forced logits above decide
            assert g[i] == tok, (i, g, w)
            compared += 1
    assert compared >= 6  # the margin rule must leave real comparisons


def test_streaming_protocol(engines):
    *_, teng, prompts = engines
    seen = []

    def stream(qi, pos, token, prob):
        seen.append((qi, pos, token))
        return True

    out = teng.generate_batch(prompts[:2], max_generated_tokens=3,
                              stream_token=stream)
    for qi, prompt in enumerate(prompts[:2]):
        mine = [(p, t) for (q, p, t) in seen if q == qi]
        assert [t for _, t in mine] == prompt + out[qi]
        assert [p for p, _ in mine] == list(range(len(mine)))


def test_engine_defaults_to_cuda(engines):
    _, tc, _, tparams, *_ = engines
    if torch.cuda.is_available():
        assert GemmaEngine(tparams, tc).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            GemmaEngine(tparams, tc)


@pytest.mark.parametrize("entry", ["kv_cache", "synth", "params", "cache_tree"])
def test_entry_points_default_to_cuda(engines, entry):
    """Every entry point that makes tensors puts them on CUDA unless the
    caller names a device, and raises when CUDA is absent."""
    from gemma_tpu_torch.models.bridge import kv_cache_from_numpy
    from gemma_tpu_torch.utils.synth import synth_params

    jc, tc, jparams, *_ = engines
    make = {
        "kv_cache": lambda dev: TKVCache.create(tc, 1, SEQ, kind="i8",
                                                device=dev).kv,
        "synth": lambda dev: synth_params(tc, seed=0,
                                          device=dev).embedding.arrays["codes"],
        "params": lambda dev: params_from_numpy(
            flatten_params(jparams), tc, dev).final_norm,
        "cache_tree": lambda dev: kv_cache_from_numpy(
            {"kv": np.zeros((1, 2, 2, 1, 32, 8), np.int8), "seq_len": 16},
            dev).kv,
    }[entry]
    assert make("cpu").device.type == "cpu"
    if torch.cuda.is_available():
        assert make(None).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make(None)


@pytest.fixture(scope="module")
def model_file(tmp_path_factory):
    from tests.test_frontends import tiny_model_file

    return tiny_model_file(tmp_path_factory.mktemp("model"))


@pytest.mark.parametrize("entry", ["gemma_load", "context_create",
                                   "gemma_model", "cli"])
def test_frontends_default_to_cuda(model_file, entry):
    """Gemma.load, ContextGemma.create, GemmaModel and the CLIs' --device
    (args.load_gemma, which run.py and api_server.py call) put the model on
    CUDA unless the caller names a device, and raise when CUDA is absent."""
    import argparse

    from gemma_tpu_torch import args as targs
    from gemma_tpu_torch.bindings.context import ContextGemma
    from gemma_tpu_torch.gemma import Gemma
    from gemma_tpu_torch.gemma_py import GemmaModel

    def cli(dev):
        parser = argparse.ArgumentParser()
        targs.add_args(parser, targs.LoaderArgs, targs.InferenceArgs)
        argv = ["--weights", model_file, "--seq_len", "64"]
        ns = parser.parse_args(argv + (["--device", dev] if dev else []))
        return targs.load_gemma(targs.extract(ns, targs.LoaderArgs),
                                targs.extract(ns, targs.InferenceArgs))

    make = {
        "gemma_load": lambda dev: Gemma.load(model_file, device=dev),
        "context_create": lambda dev: ContextGemma.create(
            model_file, device=dev).gemma,
        "gemma_model": lambda dev: GemmaModel("", model_file, seq_len=64,
                                              device=dev)._gemma,
        "cli": cli,
    }[entry]
    g = make("cpu")
    assert g.params.device.type == g.engine.device.type == "cpu"
    if torch.cuda.is_available():
        assert make(None).params.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make(None)


@pytest.mark.parametrize("kw,match", [
    (dict(kind="i4"), "slice 4"),
    (dict(kind="nuq4"), "slice 4"),
])
def test_later_slices_raise(engines, kw, match):
    """Nothing on the serving path is left to a later slice: the 4.5-bit
    weight codecs (slice 4) synthesize and serve, sampled decode (top_k >
    1) works, and only a bad top_k raises."""
    from gemma_tpu_torch.utils.synth import synth_params

    _, tc, _, tparams, *_, prompts = engines
    params = synth_params(tc, device="cpu", **kw)
    assert params.embedding.kind == params.layers[0].linear.kind == kw["kind"]
    out = GemmaEngine(params, tc, RuntimeConfig(seq_len=SEQ),
                      device="cpu").generate_batch(prompts[:1],
                                                   max_generated_tokens=2)
    assert len(out[0]) == 2
    assert GemmaEngine(tparams, tc, RuntimeConfig(top_k=40),
                       device="cpu").runtime.top_k == 40
    with pytest.raises(ValueError, match="top_k"):
        GemmaEngine(tparams, tc, RuntimeConfig(top_k=0), device="cpu")


def test_accept_token_raises(engines):
    """An exception raised by the accept_token callback reaches the
    caller (the host loop neither swallows it nor falls back)."""
    *_, teng, prompts = engines

    def accept(token, logit):
        raise KeyError("rejected by the caller")

    with pytest.raises(KeyError, match="rejected by the caller"):
        teng.generate_batch(prompts[:1], max_generated_tokens=2,
                            accept_token=accept)
