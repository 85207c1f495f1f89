"""Split-weight decode: the port's K8, K9, K10 and K11 (their plain
versions on the CPU) against the JAX package's Pallas kernels in
interpret mode, and models whose q and kv projections stay split
(`qkv1` / `qkv2`) against the JAX package's forward pass, engine and
loader.

Kernels (the reduced shapes of tests/test_decode_fused.py: batch 2, 8
query heads over 4 KV heads of 256, a ring of 32; 255 for the S-blocked
cases):
  - K8 `decode_attention_write` vs `_decode_fused_kernel`: i8, bf16 and f32
    pools, rows pre-encoded and with RoPE (and QK norms) in the kernel,
    ring wrap, a local window, an invalid slot;
  - K9 `kv_write_decode` vs `_kv_write_pallas` / `_kv_write_q_pallas`, on
    f32 rows, bf16 rows and strided views of one interleaved kv row;
  - K10 `decode_attention` vs `_decode_att_pallas` / `_decode_att_q_pallas`;
  - K11: both packages under GEMMA_SBLOCK_DECODE=1;
  - `pick_s_block` and the pools' sizes it reads.

Tolerances.  Outputs: both compute the same softmax in another f32
summation order; where the pool is bf16 or i8 a bf16-rounded probability
(an exp weight in K11) may flip by one ulp, which moves a small output by
up to one bf16 ulp of the largest: rtol 8e-3 plus atol 2^-8 * max|out|
(the bound tests/test_torch_attention.py holds K4 to).  f32 pools round
nothing: rtol 1e-4, atol 1e-4 * max|out|.  Written rows: exact when the
rows come pre-encoded (both quantize with the same f32 ops); with RoPE in
the kernel an i8 code may move by one on at most 1% of the new row's
codes, a bf16 value by one bf16 ulp, an f32 one by 1e-5 relative (sin and
cos may differ by an ulp between XLA and PyTorch).

Models: the reduced Gemma2 shape of tests/test_torch_decode.py with its
q and kv weights split and the kv projection's tensor scale set apart
(1.25), so that neither package can row-concatenate them; logits within
5e-3 of max|logit| (that file's bound), greedy tokens equal wherever the
JAX top1-top2 margin exceeds twice that.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gemma_tpu.engine import GemmaEngine as JEngine
from gemma_tpu.engine import RuntimeConfig as JRuntime
from gemma_tpu.io.blob_store import BlobReader as JBlobReader
from gemma_tpu.io.model_store import ModelStore as JModelStore
from gemma_tpu.models import configs as jcfg
from gemma_tpu.models.gemma import forward as j_forward
from gemma_tpu.models.gemma import load_params as j_load_params
from gemma_tpu.models.kv_cache import KVCache as JKVCache
from gemma_tpu.ops import decode_attention as jda
from gemma_tpu.ops import matmul as jmm
from gemma_tpu.ops import ops as jops
from gemma_tpu_torch import compression as tcomp
from gemma_tpu_torch.engine import GemmaEngine, RuntimeConfig
from gemma_tpu_torch.gemma import Gemma
from gemma_tpu_torch.io.blob_store import BlobReader
from gemma_tpu_torch.io.model_store import ModelStore, write_model
from gemma_tpu_torch.models import configs as tcfg
from gemma_tpu_torch.models.bridge import (kv_cache_from_numpy,
                                           params_from_numpy)
from gemma_tpu_torch.models.gemma import forward as t_forward
from gemma_tpu_torch.models.gemma import load_params
from gemma_tpu_torch.models.kv_cache import KVCache as TKVCache
from gemma_tpu_torch.ops import decode_attention as tda
from gemma_tpu_torch.utils.synth import synth_params
from tests.test_torch_loader import (LAYERS, assert_same_quant, same_bits,
                                     tensor_values, tiny_config)
from tests.test_torch_matmul import (flatten_cache, flatten_params,
                                     jax_i8_params, small_configs)

torch.set_num_threads(1)

CONFIG = jcfg.config_gemma2_2b()
B, SEQ, KVH, H, D = 2, 32, 4, 8, 256
G = H // KVH
QSCALE = 0.0625
SWITCHES = ("GEMMA_FUSED_DECODE", "GEMMA_PACKED_DECODE", "GEMMA_SBLOCK_DECODE")


@pytest.fixture(autouse=True)
def _default_switches(monkeypatch):
    """Every test starts from the JAX package's defaults."""
    for name in SWITCHES:
        monkeypatch.delenv(name, raising=False)


def _prefilled(rng, kind, n_pos, seq=SEQ):
    """A JAX cache with n_pos random rows written (ring wrap past seq),
    and the port's copy of it."""
    cache = JKVCache.create(CONFIG, B, seq, kind=kind)
    k = jnp.asarray(rng.normal(0, 0.5, (B, n_pos, KVH, D)).astype(np.float32))
    v = jnp.asarray(rng.normal(0, 0.5, (B, n_pos, KVH, D)).astype(np.float32))
    pos = jnp.tile(jnp.arange(n_pos, dtype=jnp.int32), (B, 1))
    cache = cache.update(0, pos, k, v)
    return cache, kv_cache_from_numpy(flatten_cache(cache), "cpu")


def _step_inputs(rng, n_pos, rope_mode, with_valid):
    """q, k, v [B, 1, *, D], positions, valid, and the two RopeSpecs (None
    when the inputs come pre-encoded)."""
    q = rng.normal(0, 1, (B, 1, H, D)).astype(np.float32)
    if rope_mode is None:
        q *= QSCALE
    k = rng.normal(0, 0.5, (B, 1, KVH, D)).astype(np.float32)
    v = rng.normal(0, 0.5, (B, 1, KVH, D)).astype(np.float32)
    positions = np.full((B, 1), n_pos, np.int32)
    valid = np.array([[True], [False]]) if with_valid else None
    specs = (None, None)
    if rope_mode is not None:
        post_qk = 1 if rope_mode == "half_norms" else 0
        inv = jops.create_inv_timescale(D, post_qk == 1)
        kn = qn = None
        if rope_mode == "half_norms":
            kn = rng.normal(0, 0.1, (D,)).astype(np.float32)
            qn = rng.normal(0, 0.1, (D,)).astype(np.float32)
        specs = (jda.RopeSpec(
            jnp.asarray(inv), post_qk, QSCALE,
            key_norm=None if kn is None else jnp.asarray(kn),
            query_norm=None if qn is None else jnp.asarray(qn)),
            tda.RopeSpec(
                torch.from_numpy(inv), post_qk, QSCALE,
                key_norm=None if kn is None else torch.from_numpy(kn),
                query_norm=None if qn is None else torch.from_numpy(qn)))
    return q, k, v, positions, valid, specs


def _assert_out(got, want, kind, rows):
    got, want = np.asarray(got, np.float32)[rows], np.asarray(want)[rows]
    if kind == "f32":
        rtol, atol = 1e-4, 1e-4 * np.abs(want).max()
    else:
        rtol, atol = 8e-3, 2 ** -8 * np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


def _assert_pools(tcache, jcache, kind, exact, valid=None):
    tp = tcache.kv.float().numpy() if kind != "i8" else tcache.kv.numpy()
    jp = np.asarray(jcache.kv, np.float32 if kind != "i8" else np.int8)
    if exact:
        np.testing.assert_array_equal(tp, jp)
    elif kind == "i8":
        diff = np.abs(tp.astype(np.int32) - jp.astype(np.int32))
        assert diff.max() <= 1
        assert (diff > 0).sum() <= 0.01 * B * 2 * KVH * D
    else:
        np.testing.assert_allclose(tp, jp, atol=1e-6,
                                   rtol=2 ** -7 if kind == "bf16" else 1e-5)
    if kind == "i8":
        np.testing.assert_allclose(tcache.kv_scale.numpy(),
                                   np.asarray(jcache.kv_scale),
                                   rtol=0 if exact else 1e-5)
    if valid is not None:  # the masked slot wrote only the garbage row
        np.testing.assert_array_equal(tp[1, :, :, :, :SEQ],
                                      np.asarray(jcache.kv)[1, :, :, :, :SEQ])


def _j_write_attend(jcache, q, positions, k, v, window, valid, jspec,
                    **kw):
    return jda.decode_attention_write(
        jcache, 0, jnp.asarray(q), jnp.asarray(positions), jnp.asarray(k),
        jnp.asarray(v), window, att_cap=50.0,
        valid=None if valid is None else jnp.asarray(valid), rope=jspec,
        use_pallas=True, interpret=True, **kw)


def _t_write_attend(tcache, q, positions, k, v, window, valid, tspec):
    return tda.decode_attention_write(
        tcache, 0, torch.from_numpy(q), torch.from_numpy(positions),
        torch.from_numpy(k), torch.from_numpy(v), window, att_cap=50.0,
        valid=None if valid is None else torch.from_numpy(valid), rope=tspec)


# --- K8 --------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["i8", "bf16", "f32"])
@pytest.mark.parametrize("n_pos,window,rope_mode,with_valid", [
    (24, SEQ, None, False),          # pre-encoded, global, no wrap
    (40, 16, None, False),           # pre-encoded, ring wrap, local window
    (40, SEQ, "rope", True),         # RoPE in the kernel, an invalid slot
    (24, 16, "half_norms", False),   # QK norms + half-RoPE, local window
])
def test_write_attend_matches_jax_kernel(kind, n_pos, window, rope_mode,
                                         with_valid):
    """K8: output [B, 1, H, D] f32, the pool and its scales."""
    rng = np.random.default_rng(10 * n_pos + window)
    jcache, tcache = _prefilled(rng, kind, n_pos)
    q, k, v, positions, valid, (jspec, tspec) = _step_inputs(
        rng, n_pos, rope_mode, with_valid)
    want, jcache = _j_write_attend(jcache, q, positions, k, v, window, valid,
                                   jspec)
    got = _t_write_attend(tcache, q, positions, k, v, window, valid, tspec)
    assert got.dtype == torch.float32 and got.shape == (B, 1, H, D)
    _assert_out(got, want, kind, [0] if with_valid else [0, 1])
    _assert_pools(tcache, jcache, kind, exact=rope_mode is None, valid=valid)


# --- K9 and K10 -------------------------------------------------------------


@pytest.mark.parametrize("kind", ["i8", "bf16", "f32"])
@pytest.mark.parametrize("n_pos,with_valid", [(24, True), (40, False)])
def test_kv_write_matches_jax_kernel(kind, n_pos, with_valid):
    """K9: the same rows (and scales) written, nothing else moved."""
    rng = np.random.default_rng(50 + n_pos)
    jcache, tcache = _prefilled(rng, kind, n_pos)
    before = tcache.kv.clone()
    _, k, v, positions, valid, _ = _step_inputs(rng, n_pos, None, with_valid)
    pool, idx, ring = jcache.pool(0)
    rows = jnp.asarray(positions[:, 0] % ring, jnp.int32)
    if valid is not None:
        rows = jnp.where(jnp.asarray(valid[:, 0]), rows, ring)
    newkv = jnp.stack([jnp.asarray(k)[:, 0], jnp.asarray(v)[:, 0]], axis=1)
    if kind == "i8":
        from gemma_tpu.ops.kv_quant import quantize_rows

        codes, scale = quantize_rows(newkv)
        jpool, jsc = jda._kv_write_q_pallas(pool, jcache.kv_scale, codes,
                                            scale, rows, idx, interpret=True)
        jcache = dataclasses.replace(jcache, kv=jpool, kv_scale=jsc)
    else:
        jpool = jda._kv_write_pallas(pool, newkv.astype(pool.dtype), rows, idx,
                                     interpret=True)
        jcache = dataclasses.replace(jcache, kv=jpool)
    tda.kv_write_decode(tcache, 0, torch.from_numpy(positions),
                        torch.from_numpy(k), torch.from_numpy(v),
                        valid=None if valid is None
                        else torch.from_numpy(valid))
    _assert_pools(tcache, jcache, kind, exact=True)
    changed = tcache.kv != before  # [B, NL, 2, KVH, S, D]
    assert not changed[:, 1:].any()  # layer 0's rows only
    moved = changed[:, 0].any(-1).any(1).any(1)  # [B, S]
    for b in range(B):  # only each slot's target row
        assert set(np.nonzero(moved[b].numpy())[0]) <= {int(rows[b])}


@pytest.mark.parametrize("kind", ["i8", "bf16", "f32"])
@pytest.mark.parametrize("rows", ["bf16", "strided f32", "strided bf16"])
def test_kv_write_raw_rows_match_jax_kernel(kind, rows):
    """K9 on the rows it takes raw: bf16 rows, and k / v as strided views
    into one [B, 1, KVH, 2, D] row (the fused qkv row's interleave), the
    same values through the JAX kernels; an invalid slot."""
    rng = np.random.default_rng(90 + len(rows))
    jcache, tcache = _prefilled(rng, kind, 24)
    kv = rng.normal(0, 0.5, (B, 1, KVH, 2, D)).astype(np.float32)
    kv[0, 0, 1, 0] = 0.0  # an all-zero K row: scale 0
    dt = jnp.bfloat16 if "bf16" in rows else jnp.float32
    jk = jnp.asarray(kv[..., 0, :]).astype(dt)
    jv = jnp.asarray(kv[..., 1, :]).astype(dt)
    positions = np.array([[24], [30]], np.int32)
    valid = np.array([[True], [False]])
    pool, idx, ring = jcache.pool(0)
    jrows = jnp.where(jnp.asarray(valid[:, 0]),
                      jnp.asarray(positions[:, 0] % ring, jnp.int32), ring)
    newkv = jnp.stack([jk[:, 0], jv[:, 0]], axis=1)
    if kind == "i8":
        from gemma_tpu.ops.kv_quant import quantize_rows

        codes, scale = quantize_rows(newkv)
        jpool, jsc = jda._kv_write_q_pallas(pool, jcache.kv_scale, codes,
                                            scale, jrows, idx, interpret=True)
        jcache = dataclasses.replace(jcache, kv=jpool, kv_scale=jsc)
    else:
        jpool = jda._kv_write_pallas(pool, newkv.astype(pool.dtype), jrows,
                                     idx, interpret=True)
        jcache = dataclasses.replace(jcache, kv=jpool)
    tkv = torch.from_numpy(kv)
    if "bf16" in rows:
        tkv = tkv.to(torch.bfloat16)
    if "strided" in rows:
        k, v = tkv[..., 0, :], tkv[..., 1, :]
        assert k.stride(2) == 2 * D
    else:
        k, v = tkv[..., 0, :].contiguous(), tkv[..., 1, :].contiguous()
    tda.kv_write_decode(tcache, 0, torch.from_numpy(positions), k, v,
                        valid=torch.from_numpy(valid))
    _assert_pools(tcache, jcache, kind, exact=True, valid=valid)


@pytest.mark.parametrize("kind", ["i8", "bf16", "f32"])
@pytest.mark.parametrize("n_pos,window", [(24, SEQ), (40, 16)])
def test_attend_matches_jax_kernel(kind, n_pos, window):
    """K10 on a pre-encoded q: output [B, 1, H, D] f32."""
    rng = np.random.default_rng(70 + n_pos + window)
    jcache, tcache = _prefilled(rng, kind, n_pos)
    q, _, _, positions, _, _ = _step_inputs(rng, n_pos, None, False)
    pool, idx, ring = jcache.pool(0)
    qk = jnp.asarray(q).reshape(B, KVH, G, D)
    pos = jnp.asarray(positions[:, 0])
    if kind == "i8":
        want = jda._decode_att_q_pallas(pool, jcache.kv_scale, qk, pos, idx,
                                        ring, window, 50.0, interpret=True)
    else:
        want = jda._decode_att_pallas(pool, qk, pos, idx, ring, window, 50.0,
                                      interpret=True)
    got = tda.decode_attention(tcache, 0, torch.from_numpy(q),
                               torch.from_numpy(positions), window, 50.0)
    assert got.dtype == torch.float32 and got.shape == (B, 1, H, D)
    _assert_out(got.reshape(B, H, D), want, kind, [0, 1])


# --- K11 --------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["bf16", "i8"])
@pytest.mark.parametrize("n_pos,window,rope_mode,with_valid", [
    (60, 255, None, False),     # frontier clamp: 2 of 8 (bf16) blocks live
    (300, 64, "rope", True),    # past the wrap, windowed, RoPE, a masked slot
])
def test_sblocked_matches_jax_kernel(kind, n_pos, window, rope_mode,
                                     with_valid, monkeypatch):
    """K11: GEMMA_SBLOCK_DECODE=1 on both packages; both pick the same S
    block and run the online softmax (the port's plain version is
    counted); outputs, pools and scales as for K8."""
    seq = 255
    rng = np.random.default_rng(n_pos + window)
    jcache, tcache = _prefilled(rng, kind, n_pos, seq=seq)
    q, k, v, positions, valid, (jspec, tspec) = _step_inputs(
        rng, n_pos, rope_mode, with_valid)
    pool = jcache.pool(0)[0]
    row_bytes = pool.shape[3] * pool.shape[5] * pool.dtype.itemsize
    block = jda.pick_s_block(pool.shape[4], jda._sublane(pool.dtype),
                             row_bytes, lane_multiple=128 if kind == "i8"
                             else None)
    assert block is not None and tda._s_block(tcache, 0) == block
    monkeypatch.setenv("GEMMA_SBLOCK_DECODE", "1")
    calls = []
    plain = tda.decode_attention_write_sblocked_plain
    monkeypatch.setattr(tda, "decode_attention_write_sblocked_plain",
                        lambda *a, **kw: calls.append(a[7]) or plain(*a, **kw))
    want, jcache = _j_write_attend(jcache, q, positions, k, v, window, valid,
                                   jspec)
    got = _t_write_attend(tcache, q, positions, k, v, window, valid, tspec)
    assert calls == [block]
    _assert_out(got, want, kind, [0] if with_valid else [0, 1])
    _assert_pools(tcache, jcache, kind, exact=rope_mode is None)


def test_pick_s_block_matches_jax():
    for dt, jdt in ((torch.int8, jnp.int8), (torch.bfloat16, jnp.bfloat16),
                    (torch.float32, jnp.float32)):
        assert tda._sublane(dt) == jda._sublane(jdt)
    for s_alloc in range(16, 1040, 16):
        for sublane in (8, 16, 32):
            for row_bytes in (256, 1024, 2048, 4096):
                for lane in (None, 128):
                    assert tda.pick_s_block(
                        s_alloc, sublane, row_bytes, lane_multiple=lane) == \
                        jda.pick_s_block(s_alloc, sublane, row_bytes,
                                         lane_multiple=lane)


@pytest.mark.parametrize("kind,s_alloc,block", [("bf16", 8208, 48),
                                                ("i8", 8224, None),
                                                ("f32", 8208, 16)])
def test_s_block_of_gemma2_2b_cache(kind, s_alloc, block):
    """At Gemma2-2B's shape and seq_len 8192 the global pool has 8208 rows
    (bf16, f32) or 8224 (i8), as the JAX cache has: K11 takes 48-row (bf16)
    or 16-row (f32) blocks, and an i8 pool, with no 128-multiple divisor,
    stays with the one-shot K8."""
    cfg = tcfg.config_gemma2_2b()
    cfg = dataclasses.replace(cfg, num_layers=2,
                              layer_configs=cfg.layer_configs[:2],
                              attention_window_sizes=[4096, 8192])
    cache = TKVCache.create(cfg, 1, 8192, kind=kind, device="cpu")
    jc = jcfg.config_gemma2_2b()
    jc.num_layers = 2
    jc.layer_configs = jc.layer_configs[:2]
    jc.attention_window_sizes = [4096, 8192]
    jcache = JKVCache.create(jc, 1, 8192, kind=kind)
    assert cache.s_alloc == jcache.s_alloc == s_alloc
    assert cache.garbage_row == jcache.garbage_row == 8192
    assert tda._s_block(cache, 1) == block


# --- models -----------------------------------------------------------------


NEW, LOGIT_TOL = 9, 5e-3


def _split(jq, n1, scale2=1.0):
    """A JAX QuantTensor's rows [:n1] and [n1:], the second with its tensor
    scale multiplied by scale2."""
    a1 = {k: v[:n1] for k, v in jq.arrays.items()}
    a2 = {k: v[n1:] for k, v in jq.arrays.items()}
    return (jmm.QuantTensor(jq.kind, (n1, jq.k), jq.scale, a1),
            jmm.QuantTensor(jq.kind, (jq.n - n1, jq.k), jq.scale * scale2,
                            a2))


@pytest.fixture(scope="module")
def split_model():
    """The reduced Gemma2 model of tests/test_torch_decode.py with split q
    and kv weights (the kv projection's scale 1.25 apart), bridged; the
    JAX engine's greedy transcripts at its default runtime, and its
    teacher-forced logits over them."""
    jc, tc = small_configs(num_layers=2, seq=64, windows=(16, 64))
    rng = np.random.default_rng(7)
    jparams = jax_i8_params(jc, rng)
    emb = jparams.embedding
    jparams = dataclasses.replace(
        jparams, embedding=jmm.QuantTensor(
            emb.kind, emb.shape, emb.scale,
            dict(emb.arrays, inv_scales=emb.arrays["inv_scales"] * 0.03)),
        final_norm=jparams.final_norm + 9.0)
    lc = jc.layer_configs[0]
    layers = []
    for lp in jparams.layers:
        q1, q2 = _split(lp.qkv_cat, lc.heads * lc.qkv_dim, 1.25)
        assert jmm.concat_rows(q1, q2) is None
        layers.append(dataclasses.replace(lp, qkv1=q1, qkv2=q2, qkv_cat=None))
    jparams = dataclasses.replace(jparams, layers=layers)
    tparams = params_from_numpy(flatten_params(jparams), tc, "cpu")
    prompts = [rng.integers(2, jc.vocab_size, n).tolist() for n in (5, 23, 40)]
    want = JEngine(jparams, jc, JRuntime(verbosity=0)).generate_batch(
        prompts, max_generated_tokens=NEW)
    # One batched teacher-forced pass: each sequence padded to the longest
    # (causal attention: the padding moves no earlier logit).
    seqs = [p + w for p, w in zip(prompts, want)]
    n = max(len(x) for x in seqs)
    logits, _ = j_forward(
        jparams, jnp.asarray([x + [2] * (n - len(x)) for x in seqs],
                             jnp.int32),
        jnp.tile(jnp.arange(n, dtype=jnp.int32), (len(seqs), 1)),
        JKVCache.create(jc, len(seqs), 64), jc, return_logits="all")
    return jc, tc, jparams, tparams, prompts, want, np.asarray(logits)


def test_bridge_keeps_split_weights(split_model):
    jc, tc, jparams, tparams, *_ = split_model
    for jl, tl in zip(jparams.layers, tparams.layers):
        assert tl.qkv_cat is None
        for name in ("qkv1", "qkv2"):
            assert_same_quant(getattr(jl, name), getattr(tl, name), name)
        assert tl.qkv2.scale == 1.25 * tl.qkv1.scale


@pytest.mark.parametrize("kv_kind", ["i8", "bf16"])
def test_split_forward_matches_jax(split_model, kv_kind):
    """Prefill 22 tokens, then two decode steps (K8's plain version), last
    logits against JAX's forward (its composed decode on the CPU)."""
    jc, tc, jparams, tparams, prompts, *_ = split_model
    seq = prompts[1] + [11, 12]
    jcache = JKVCache.create(jc, 1, 64, kind=kv_kind)
    tcache = TKVCache.create(tc, 1, 64, kind=kv_kind, device="cpu")
    n = len(prompts[1])
    _, jcache = j_forward(jparams, jnp.asarray(seq[:n], jnp.int32)[None],
                          jnp.arange(n, dtype=jnp.int32)[None], jcache, jc,
                          return_logits="none")
    t_forward(tparams, torch.tensor(seq[:n])[None], torch.arange(n)[None],
              tcache, tc, return_logits="none")
    for i in range(n, len(seq)):
        want, jcache = j_forward(
            jparams, jnp.asarray([[seq[i]]], jnp.int32),
            jnp.asarray([[i]], jnp.int32), jcache, jc, return_logits="last")
        got, _ = t_forward(tparams, torch.tensor([[seq[i]]]),
                           torch.tensor([[i]]), tcache, tc,
                           return_logits="last")
        want = np.asarray(want)
        assert np.abs(got.numpy() - want).max() <= \
            LOGIT_TOL * np.abs(want).max()


@pytest.mark.parametrize("split,switch", [
    (True, None), (True, "GEMMA_FUSED_DECODE=0"),
    (True, "GEMMA_SBLOCK_DECODE=1"), (False, "GEMMA_FUSED_DECODE=0"),
    (False, "GEMMA_SBLOCK_DECODE=1"), (False, "GEMMA_PACKED_DECODE=0")])
def test_engine_greedy_matches_jax(split_model, split, switch, monkeypatch):
    """The port's engine at the default runtime (bf16 KV, chunks of 4),
    split weights or the same weights row-concatenated (whose default path
    tests/test_torch_decode.py holds), under each of the JAX package's
    switches, against the JAX engine's transcripts (which the switches
    leave alone on the CPU)."""
    jc, tc, jparams, tparams, prompts, want, teacher = split_model
    if not split:
        tparams = dataclasses.replace(tparams, layers=[
            dataclasses.replace(lp, qkv1=None, qkv2=None,
                                qkv_cat=_cat(lp.qkv1, lp.qkv2))
            for lp in tparams.layers])
    if switch is not None:
        name, value = switch.split("=")
        monkeypatch.setenv(name, value)
    got = GemmaEngine(tparams, tc, RuntimeConfig(), device="cpu"
                      ).generate_batch(prompts, max_generated_tokens=NEW)
    compared = 0
    for p, g, w, logits in zip(prompts, got, want, teacher):
        scale = np.abs(logits).max()
        for i, tok in enumerate(w):
            top2 = np.sort(logits[len(p) - 1 + i])[-2:]
            if top2[1] - top2[0] <= 2 * LOGIT_TOL * scale:
                break
            assert g[i] == tok, (i, g, w)
            compared += 1
    assert compared >= 6


def _cat(q1, q2):
    """Row-concatenate two port QuantTensors whatever their scales, folding
    each one's scale into its rows (i8: the group inverse scales)."""
    arrays = {}
    for key in q1.arrays:
        a1, a2 = q1.arrays[key], q2.arrays[key]
        if key == "inv_scales":
            a1, a2 = a1 * q1.scale, a2 * q2.scale
        arrays[key] = torch.cat([a1, a2], dim=0)
    return dataclasses.replace(q1, shape=(q1.n + q2.n, q1.k), scale=1.0,
                               arrays=arrays)


# --- the loader --------------------------------------------------------------


@pytest.fixture(scope="module")
def split_scaled_file(tmp_path_factory):
    """An SFP-typed file under the split tensor names whose kv projection
    holds one weight beyond SFP's 1.875: compress_tensor gives qkv2_w its
    own tensor scale, so its rows cannot join qkv1_w's."""
    values = tensor_values("split", 9)
    for i in range(LAYERS):
        values[f"qkv2_w_{i}"][3, 5] = 2.5
    path = str(tmp_path_factory.mktemp("split") / "split_scaled.sbs")
    write_model(path, tiny_config(tcfg), [
        tcomp.compress_tensor(tcomp.Type.SFP if v.shape[0] > 1
                              else tcomp.Type.F32, name, v)
        for name, v in values.items()])
    return path


def test_split_file_loads_split_in_both_packages(split_scaled_file):
    """Both loaders keep qkv1 / qkv2 apart, byte for byte and scale for
    scale; last logits (prefill 11 tokens, one decode step) within 5e-3
    of max|logit|."""
    jstore = JModelStore(JBlobReader(split_scaled_file))
    jp = j_load_params(jstore)
    tp = load_params(ModelStore(BlobReader(split_scaled_file)),
                     device="cpu")
    for i, (jl, tl) in enumerate(zip(jp.layers, tp.layers)):
        assert jl.qkv_cat is None and tl.qkv_cat is None
        for name in ("qkv1", "qkv2", "att_w", "gating1", "linear"):
            assert_same_quant(getattr(jl, name), getattr(tl, name),
                              f"{name}_{i}")
        assert tl.qkv1.scale == 1.0 != tl.qkv2.scale
        same_bits(jl.pre_att_norm, tl.pre_att_norm.numpy())
    g = Gemma.load(split_scaled_file, runtime=RuntimeConfig(seq_len=64),
                   device="cpu")
    assert g.params.layers[0].qkv_cat is None
    tokens = [2, 17, 45, 99, 120, 7, 33, 250, 3, 61, 18, 200]
    n = len(tokens) - 1
    jcache = JKVCache.create(jstore.config, 1, 64)
    _, jcache = j_forward(jp, jnp.asarray(tokens[:n], jnp.int32)[None],
                          jnp.arange(n, dtype=jnp.int32)[None], jcache,
                          jstore.config, return_logits="none")
    want, _ = j_forward(jp, jnp.asarray([[tokens[n]]], jnp.int32),
                        jnp.asarray([[n]], jnp.int32), jcache, jstore.config,
                        return_logits="last")
    cache = g.new_cache(1)
    t_forward(g.params, torch.tensor(tokens[:n])[None], torch.arange(n)[None],
              cache, g.config, return_logits="none")
    got, _ = t_forward(g.params, torch.tensor([[tokens[n]]]),
                       torch.tensor([[n]]), cache, g.config,
                       return_logits="last")
    want = np.asarray(want)
    assert np.abs(got.numpy() - want).max() <= LOGIT_TOL * np.abs(want).max()
    # Asked for the split layout, a file whose halves could join stays split.
    jp2 = j_load_params(jstore, fuse_qkv=False)
    tp2 = load_params(ModelStore(BlobReader(split_scaled_file)),
                      device="cpu", fuse_qkv=False)
    assert jp2.layers[0].qkv_cat is None and tp2.layers[0].qkv_cat is None


@pytest.mark.parametrize("kind", ["i8", "sfp"])
def test_synth_split_holds_the_fused_weights(kind):
    """synth_params(fuse_qkv=False) splits the very rows the fused draw
    makes, so both layouts (and every other tensor) are the same model."""
    _, tc = small_configs(num_layers=2)
    fused = synth_params(tc, kind=kind, seed=5, device="cpu")
    split = synth_params(tc, kind=kind, seed=5, device="cpu", fuse_qkv=False)
    for lf, ls in zip(fused.layers, split.layers):
        assert lf.qkv1 is None and ls.qkv_cat is None
        for key, arr in lf.qkv_cat.arrays.items():
            assert torch.equal(arr, torch.cat([ls.qkv1.arrays[key],
                                               ls.qkv2.arrays[key]]))
        assert torch.equal(lf.linear.arrays[next(iter(lf.linear.arrays))],
                           ls.linear.arrays[next(iter(ls.linear.arrays))])
