"""The port's attention entry points (plain path on CPU) vs the JAX
package's Pallas kernels run in interpret mode, on i8, bf16 and f32 KV
caches carried across with the bridge:

  - decode_attention_write_packed vs _decode_fused_packed_kernel (K4);
  - flash_prefill_attention vs _flash_kernel (K5).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gemma_tpu.models.configs import config_gemma2_2b
from gemma_tpu.models.kv_cache import KVCache as JKVCache
from gemma_tpu.ops import ops as jops
from gemma_tpu.ops.decode_attention import RopeSpec as JRopeSpec
from gemma_tpu.ops.decode_attention import decode_attention_write_packed as \
    j_decode
from gemma_tpu.ops.flash_attention import flash_prefill_attention as j_flash
from gemma_tpu_torch.models.bridge import kv_cache_from_numpy
from gemma_tpu_torch.ops import decode_attention as tda
from gemma_tpu_torch.ops import flash_attention as tfa
from tests.test_torch_matmul import flatten_cache

torch.set_num_threads(1)

CONFIG = config_gemma2_2b()
B, SEQ, KVH, H, D = 2, 32, 4, 8, 256


def _prefilled(rng, n_pos, kind="i8"):
    cache = JKVCache.create(CONFIG, B, SEQ, kind=kind)
    k = jnp.asarray(rng.normal(0, 0.5, (B, n_pos, KVH, D)).astype(np.float32))
    v = jnp.asarray(rng.normal(0, 0.5, (B, n_pos, KVH, D)).astype(np.float32))
    pos = jnp.tile(jnp.arange(n_pos, dtype=jnp.int32), (B, 1))
    return cache.update(0, pos, k, v)


@pytest.mark.parametrize("n_pos,window,post_qk,with_norms,with_valid", [
    (24, SEQ, 0, False, False),   # global, no wrap
    (40, SEQ, 0, False, False),   # ring wraparound (40 > 32)
    (40, 16, 0, False, False),    # window < ring
    (24, SEQ, 0, False, True),    # invalid slot -> garbage row
    (24, SEQ, 1, True, False),    # QK norms + half-RoPE
])
def test_decode_packed_matches_jax_kernel(n_pos, window, post_qk, with_norms,
                                          with_valid):
    """Output, pool codes and scales vs the interpret-mode packed kernel.

    Tolerances: the port's plain path computes the same exact softmax; the
    bf16 output may differ by one bf16 ulp where f32 sums reorder, and a
    bf16-rounded probability may flip by one ulp, which moves a small
    output by up to one bf16 ulp of the largest: rtol 8e-3 (the JAX
    suite's packed-vs-unpacked bound) plus atol 2^-8 * max|out|.  RoPE's
    sin/cos may differ by an ulp between XLA and PyTorch, which can move a
    quantized code by one: at most 1 code, on at most 1% of the new row's
    codes.  An invalid slot's output is unspecified and not compared."""
    rng = np.random.default_rng(100 + n_pos + window + 7 * post_qk)
    jcache = _prefilled(rng, n_pos)
    tcache = kv_cache_from_numpy(flatten_cache(jcache), "cpu")
    qkv = rng.normal(0, 1, (B, (H + 2 * KVH) * D)).astype(np.float32)
    positions = np.full((B, 1), n_pos, np.int32)
    valid = np.array([[True], [False]]) if with_valid else None
    inv = jops.create_inv_timescale(D, post_qk == 1)
    kn = qn = None
    if with_norms:
        kn = rng.normal(0, 0.1, (D,)).astype(np.float32)
        qn = rng.normal(0, 0.1, (D,)).astype(np.float32)
    qscale = 0.0625
    jspec = JRopeSpec(jnp.asarray(inv), post_qk, qscale,
                      key_norm=None if kn is None else jnp.asarray(kn),
                      query_norm=None if qn is None else jnp.asarray(qn))
    tspec = tda.RopeSpec(torch.from_numpy(inv), post_qk, qscale,
                         key_norm=None if kn is None else torch.from_numpy(kn),
                         query_norm=None if qn is None
                         else torch.from_numpy(qn))
    want, jcache = j_decode(
        jcache, 0, jnp.asarray(qkv), jnp.asarray(positions), window, heads=H,
        att_cap=50.0, valid=None if valid is None else jnp.asarray(valid),
        rope=jspec, use_pallas=True, interpret=True)
    got = tda.decode_attention_write_packed(
        tcache, 0, torch.from_numpy(qkv), torch.from_numpy(positions), window,
        heads=H, att_cap=50.0,
        valid=None if valid is None else torch.from_numpy(valid), rope=tspec)
    assert got.dtype == torch.bfloat16 and got.shape == (B, H * D)
    want = np.asarray(want, np.float32)
    got = got.float().numpy()
    rows = [0, 1] if valid is None else [0]
    np.testing.assert_allclose(got[rows], want[rows], rtol=8e-3,
                               atol=2 ** -8 * np.abs(want[rows]).max())
    diff = np.abs(tcache.kv.numpy().astype(np.int32)
                  - np.asarray(jcache.kv).astype(np.int32))
    assert diff.max() <= 1
    assert (diff > 0).sum() <= 0.01 * B * 2 * KVH * D
    np.testing.assert_allclose(tcache.kv_scale.numpy(),
                               np.asarray(jcache.kv_scale), rtol=1e-5)
    if valid is not None:  # the masked slot wrote only the garbage row
        np.testing.assert_array_equal(tcache.kv.numpy()[1, :, :, :, :SEQ],
                                      np.asarray(jcache.kv)[1, :, :, :, :SEQ])


@pytest.mark.parametrize("window,prefix,start", [
    (SEQ, 0, 8),      # global attention
    (8, 0, 8),        # sliding window
    (SEQ, 20, 8),     # prefix-LM bidirectional prefix
    (SEQ, 0, 40),     # ring wraparound
])
def test_flash_prefill_matches_jax_kernel(window, prefix, start):
    """Port (exact softmax) vs the interpret-mode flash kernel (online
    softmax; its probabilities round to bf16 relative to a running max):
    the JAX suite's own kernel-vs-reference bound, rtol 2e-2 / atol 8e-3."""
    rng = np.random.default_rng(window + prefix + start)
    t = 16
    jcache = _prefilled(rng, start + t)
    tcache = kv_cache_from_numpy(flatten_cache(jcache), "cpu")
    q = rng.normal(0, 1, (B, t, H, D)).astype(np.float32)
    positions = np.tile(np.arange(start, start + t, dtype=np.int32), (B, 1))
    pe_j = jnp.full((B,), prefix, jnp.int32) if prefix else 0
    pe_t = torch.full((B,), prefix, dtype=torch.int32) if prefix else 0
    want = j_flash(jcache, 0, jnp.asarray(q), jnp.asarray(positions), window,
                   att_cap=50.0, prefix_end=pe_j, use_pallas=True,
                   interpret=True)
    got = tfa.flash_prefill_attention(
        tcache, 0, torch.from_numpy(q), torch.from_numpy(positions), window,
        att_cap=50.0, prefix_end=pe_t)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-2,
                               atol=8e-3)


def _rope_specs(rng, post_qk, with_norms):
    inv = jops.create_inv_timescale(D, post_qk == 1)
    kn = qn = None
    if with_norms:
        kn = rng.normal(0, 0.1, (D,)).astype(np.float32)
        qn = rng.normal(0, 0.1, (D,)).astype(np.float32)
    jspec = JRopeSpec(jnp.asarray(inv), post_qk, 0.0625,
                      key_norm=None if kn is None else jnp.asarray(kn),
                      query_norm=None if qn is None else jnp.asarray(qn))
    tspec = tda.RopeSpec(torch.from_numpy(inv), post_qk, 0.0625,
                         key_norm=None if kn is None else torch.from_numpy(kn),
                         query_norm=None if qn is None
                         else torch.from_numpy(qn))
    return jspec, tspec


@pytest.mark.parametrize("kind", ["bf16", "f32"])
@pytest.mark.parametrize("n_pos,window,post_qk,with_norms,with_valid", [
    (40, SEQ, 0, False, False),   # ring wraparound (40 > 32)
    (40, 16, 0, False, True),     # window < ring, invalid slot
    (24, SEQ, 1, True, False),    # QK norms + half-RoPE
])
def test_decode_packed_unquantized_matches_jax_kernel(
        kind, n_pos, window, post_qk, with_norms, with_valid):
    """bf16 and f32 pools vs the interpret-mode packed kernel with
    quant=False (decode_attention.py:636-711): the new row is cast to the
    pool's type before it is written and used, and q and the probabilities
    round to the compute type (bf16 on a bf16 pool, f32 on an f32 pool).

    Tolerances: the output is bf16 from an exact softmax in both, so one
    bf16 ulp where f32 sums reorder plus a flipped bf16 probability on a
    bf16 pool: rtol 8e-3 plus atol 2^-8 * max|out|, as for i8.  The
    written rows: RoPE's sin/cos may differ by an f32 ulp between XLA and
    PyTorch, which can move a bf16 row value by one bf16 ulp (2^-7
    relative at most) and an f32 one by a few f32 ulps (rtol 1e-5)."""
    rng = np.random.default_rng(200 + n_pos + window + 7 * post_qk)
    jcache = _prefilled(rng, n_pos, kind)
    tcache = kv_cache_from_numpy(flatten_cache(jcache), "cpu")
    assert tcache.kv.dtype == {"bf16": torch.bfloat16,
                               "f32": torch.float32}[kind]
    qkv = rng.normal(0, 1, (B, (H + 2 * KVH) * D)).astype(np.float32)
    positions = np.full((B, 1), n_pos, np.int32)
    valid = np.array([[True], [False]]) if with_valid else None
    jspec, tspec = _rope_specs(rng, post_qk, with_norms)
    want, jcache = j_decode(
        jcache, 0, jnp.asarray(qkv), jnp.asarray(positions), window, heads=H,
        att_cap=50.0, valid=None if valid is None else jnp.asarray(valid),
        rope=jspec, use_pallas=True, interpret=True)
    got = tda.decode_attention_write_packed(
        tcache, 0, torch.from_numpy(qkv), torch.from_numpy(positions), window,
        heads=H, att_cap=50.0,
        valid=None if valid is None else torch.from_numpy(valid), rope=tspec)
    assert got.dtype == torch.bfloat16 and got.shape == (B, H * D)
    want = np.asarray(want, np.float32)
    got = got.float().numpy()
    rows = [0, 1] if valid is None else [0]
    np.testing.assert_allclose(got[rows], want[rows], rtol=8e-3,
                               atol=2 ** -8 * np.abs(want[rows]).max())
    pool_t = tcache.kv.float().numpy()
    pool_j = np.asarray(jcache.kv, np.float32)
    rtol = 2 ** -7 if kind == "bf16" else 1e-5
    np.testing.assert_allclose(pool_t, pool_j, rtol=rtol, atol=1e-6)
    if valid is not None:  # the masked slot wrote only the garbage row
        np.testing.assert_array_equal(pool_t[1, :, :, :, :SEQ],
                                      pool_j[1, :, :, :, :SEQ])


@pytest.mark.parametrize("kind", ["bf16", "f32"])
@pytest.mark.parametrize("window,prefix,start", [
    (8, 0, 8),        # sliding window
    (SEQ, 20, 8),     # prefix-LM bidirectional prefix
    (SEQ, 0, 40),     # ring wraparound
])
def test_flash_prefill_unquantized_matches_jax_kernel(kind, window, prefix,
                                                      start):
    """bf16 and f32 pools vs the interpret-mode flash kernel with
    quant=False.  bf16: the JAX suite's kernel-vs-reference bound, rtol
    2e-2 / atol 8e-3 (its online softmax rounds unnormalized
    probabilities to bf16, the port normalized ones).  f32: no bf16
    rounding anywhere, only summation order and the online rescaling:
    rtol 1e-4 / atol 1e-5."""
    rng = np.random.default_rng(300 + window + prefix + start)
    t = 16
    jcache = _prefilled(rng, start + t, kind)
    tcache = kv_cache_from_numpy(flatten_cache(jcache), "cpu")
    q = rng.normal(0, 1, (B, t, H, D)).astype(np.float32)
    positions = np.tile(np.arange(start, start + t, dtype=np.int32), (B, 1))
    pe_j = jnp.full((B,), prefix, jnp.int32) if prefix else 0
    pe_t = torch.full((B,), prefix, dtype=torch.int32) if prefix else 0
    want = j_flash(jcache, 0, jnp.asarray(q), jnp.asarray(positions), window,
                   att_cap=50.0, prefix_end=pe_j, use_pallas=True,
                   interpret=True)
    got = tfa.flash_prefill_attention(
        tcache, 0, torch.from_numpy(q), torch.from_numpy(positions), window,
        att_cap=50.0, prefix_end=pe_t)
    rtol, atol = (2e-2, 8e-3) if kind == "bf16" else (1e-4, 1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol,
                               atol=atol)
