"""The port's elementwise ops, KV quantization and attention references
(gemma_tpu_torch/ops/{ops,kv_quant,attention}.py) vs the JAX package's
gemma_tpu/ops/{ops,kv_quant,attention}.py on the same numpy inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gemma_tpu.ops import attention as jatt
from gemma_tpu.ops import kv_quant as jkq
from gemma_tpu.ops import ops as jops
from gemma_tpu_torch.ops import attention as tatt
from gemma_tpu_torch.ops import kv_quant as tkq
from gemma_tpu_torch.ops import ops as tops

torch.set_num_threads(1)


def t(a):
    return torch.from_numpy(np.array(a))


def close(got, want, rtol, atol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("op", ["rms_norm", "gelu", "soft_cap", "softmax"])
def test_elementwise_matches_jax(op):
    """Same f32 formulas; libm tanh/exp/rsqrt may differ by an ulp or two
    between XLA and PyTorch on CPU, and sums reorder: rtol 2e-6."""
    rng = np.random.default_rng(0)
    x = rng.normal(0, 3, (3, 5, 64)).astype(np.float32)
    w = rng.normal(0, 0.2, (64,)).astype(np.float32)
    if op == "rms_norm":
        got, want = tops.rms_norm(t(x), t(w)), jops.rms_norm(x, w)
    elif op == "gelu":
        got, want = tops.gelu(t(x)), jops.gelu(x)
    elif op == "soft_cap":
        got, want = tops.soft_cap(5.0, t(x)), jops.soft_cap(5.0, x)
    else:
        got, want = tops.softmax(t(x)), jops.softmax(x)
    close(got, want, rtol=2e-6, atol=1e-6)


@pytest.mark.parametrize("half", [False, True])
def test_rope_matches_jax(half):
    """Split-halves RoPE and half-RoPE with a folded query scale, over
    positions up to 8191 (large angles: sin/cos differ by an ulp at most)."""
    rng = np.random.default_rng(1)
    d = 128
    x = rng.normal(0, 1, (2, 7, 4, d)).astype(np.float32)
    pos = rng.integers(0, 8192, (2, 7, 1)).astype(np.int32)
    inv = jops.create_inv_timescale(d, half)
    np.testing.assert_array_equal(tops.create_inv_timescale(d, half), inv)
    fj, ft = (jops.half_rope, tops.half_rope) if half else (jops.rope,
                                                           tops.rope)
    close(ft(t(x), t(pos), t(inv), 0.0625), fj(x, pos, inv, 0.0625),
          rtol=1e-5, atol=1e-6)


def test_embedding_scaling_matches_jax():
    for dim in (256, 2304, 3584):
        assert tops.embedding_scaling(dim) == jops.embedding_scaling(dim)


def test_kv_quant_matches_jax():
    """quantize_rows: codes equal, scales equal (same f32 ops; rint and
    torch.round both round half to even), including an all-zero row."""
    rng = np.random.default_rng(2)
    x = rng.normal(0, 2, (3, 4, 5, 64)).astype(np.float32)
    x[0, 0, 0] = 0.0
    x[1, 1, 1, :8] = np.float32(127.5) * x[1, 1, 1].max() / 127.0
    cj, sj = jkq.quantize_rows(jnp.asarray(x))
    ct, st = tkq.quantize_rows(t(x))
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    close(tkq.dequantize_rows(ct, st), jkq.dequantize_rows(cj, sj), 0, 0)


@pytest.mark.parametrize("seq,window,prefix", [
    (32, 32, 0),     # global
    (32, 8, 0),      # sliding window
    (32, 32, 20),    # prefix-LM
    (16, 16, 0),     # ring wrap: positions past the ring length
])
def test_masks_match_jax(seq, window, prefix):
    q_pos = np.stack([np.arange(10, 26), np.arange(3, 19)]).astype(np.int32)
    np.testing.assert_array_equal(
        tatt.ring_key_positions(t(q_pos[:, -1]), seq).numpy(),
        np.asarray(jatt.ring_key_positions(jnp.asarray(q_pos[:, -1]), seq)))
    pe_j = jnp.full((2,), prefix, jnp.int32) if prefix else 0
    pe_t = torch.full((2,), prefix, dtype=torch.int32) if prefix else 0
    np.testing.assert_array_equal(
        tatt.attention_mask(t(q_pos), seq, window, pe_t).numpy(),
        np.asarray(jatt.attention_mask(jnp.asarray(q_pos), seq, window,
                                       pe_j)))


@pytest.mark.parametrize("quant", [False, True])
def test_dot_softmax_weighted_sum_matches_jax(quant):
    """Dense attention references: same bf16 operand rounding, f32 sums in
    another order; no row is fully masked (where the port returns 0 and
    the JAX reference a uniform row, by design)."""
    rng = np.random.default_rng(3)
    b, tt, h, kvh, s, d = 2, 5, 4, 2, 24, 64
    q = rng.normal(0, 1, (b, tt, h, d)).astype(np.float32)
    q_pos = np.stack([np.arange(12, 17)] * b).astype(np.int32)
    mask = np.asarray(jatt.attention_mask(jnp.asarray(q_pos), s, 8))
    if quant:
        kc = rng.integers(-127, 128, (b, kvh, s, d)).astype(np.int8)
        vc = rng.integers(-127, 128, (b, kvh, s, d)).astype(np.int8)
        sk = rng.uniform(0, 0.02, (b, kvh, s)).astype(np.float32)
        sv = rng.uniform(0, 0.02, (b, kvh, s)).astype(np.float32)
        want = jatt.dot_softmax_weighted_sum_q(q, kc, vc, sk, sv, mask, 50.0)
        got = tatt.dot_softmax_weighted_sum_q(t(q), t(kc), t(vc), t(sk),
                                              t(sv), t(mask), 50.0)
    else:
        k = rng.normal(0, 1, (b, kvh, s, d)).astype(np.float32)
        v = rng.normal(0, 1, (b, kvh, s, d)).astype(np.float32)
        want = jatt.dot_softmax_weighted_sum(q, k, v, mask, 50.0)
        got = tatt.dot_softmax_weighted_sum(t(q), t(k), t(v), t(mask), 50.0)
    close(got, want, rtol=1e-4, atol=1e-5)
