"""The port's sampling (gemma_tpu_torch/ops/sampling.py and the stream of
gemma_tpu_torch/utils/basics.py, on CPU) vs the JAX package's.

How far the two agree: the stream's key words, its 32-bit words and its
uniforms are equal bit for bit (Threefry-2x32 is integer arithmetic);
`_draw_from_topk`'s returned prob (the pre-temperature softmax) agrees to
rtol 1e-6 and the T = 0 tokens exactly; the sampled tokens agree wherever
the Gumbel-max margin is clear of float rounding (log, exp and pow differ
in the last ulp between the libraries), which the seeds below leave on
every row.  The distribution is held to its analytic form by a chi-square
test with fixed seeds."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gemma_tpu.ops import sampling as jsampling
from gemma_tpu.utils.basics import sample_key as j_sample_key
from gemma_tpu_torch.ops import sampling
from gemma_tpu_torch.utils.basics import (sample_key, stream_bits,
                                          stream_uniform)

torch.set_num_threads(1)


@pytest.mark.parametrize("seed,qi,pos", [
    (0, 0, 0), (1, 3, 17), (12345, 7, 8191), (2 ** 31 - 1, 4095, 5),
    (7, 0, 1), (7, 1, 0)])
def test_stream_equals_jax_threefry(seed, qi, pos):
    """Key words, random words and uniforms, bit for bit."""
    jkey = j_sample_key(seed, qi, pos)
    key = sample_key(seed, qi, pos)
    assert key.dtype == torch.int64 and key.shape == (2,)
    np.testing.assert_array_equal(
        key.numpy().astype(np.uint32), np.asarray(jax.random.key_data(jkey)))
    np.testing.assert_array_equal(
        stream_bits(key, 9).numpy().astype(np.uint32),
        np.asarray(jax.random.bits(jkey, (9,))))
    u = stream_uniform(key, 9)
    assert u.dtype == torch.float32
    np.testing.assert_array_equal(u.numpy(),
                                  np.asarray(jax.random.uniform(jkey, (9,))))
    assert float(stream_uniform(key, 1)[0]) == float(jax.random.uniform(jkey))


def test_stream_keys_broadcast_over_tensors():
    qi = torch.arange(5, dtype=torch.int32)
    pos = torch.tensor([3, 9, 27, 81, 243], dtype=torch.int32)
    keys = sample_key(11, qi, pos)
    assert keys.shape == (5, 2)
    for i in range(5):
        assert keys[i].tolist() == sample_key(11, i, int(pos[i])).tolist()


def _rows(rng, b, k):
    vals = -np.sort(-rng.normal(0, 2, (b, k)).astype(np.float32), axis=-1)
    idxs = rng.permutation(100000)[:b * k].reshape(b, k).astype(np.int32)
    return vals, idxs


@pytest.mark.parametrize("temperature", [0.0, 0.5, 1.0, 2.0])
def test_draw_from_topk_matches_jax(temperature):
    rng = np.random.default_rng(int(temperature * 10))
    b, k = 6, 16
    vals, idxs = _rows(rng, b, k)
    jkeys = jnp.stack([j_sample_key(5, qi, 40 + qi) for qi in range(b)])
    keys = sample_key(5, torch.arange(b), torch.arange(b) + 40)
    wt, wp = jsampling.sample_from_topk(jnp.asarray(vals), jnp.asarray(idxs),
                                        jkeys, temperature)
    gt, gp = sampling.sample_from_topk(torch.from_numpy(vals),
                                       torch.from_numpy(idxs), keys,
                                       temperature)
    assert gt.dtype == torch.int32 and gp.dtype == torch.float32
    if temperature == 0.0:
        np.testing.assert_array_equal(gt.numpy(), idxs[:, 0])
    # The Gumbel margin of every row is far above float rounding here.
    probs = torch.softmax(torch.from_numpy(vals), -1)
    adj = probs if temperature in (0.0, 1.0) else probs ** (1 / temperature)
    score = torch.log(adj / adj.sum(-1, keepdim=True)) + sampling.gumbel(
        keys, k)
    top2 = score.topk(2, dim=-1).values
    assert float((top2[:, 0] - top2[:, 1]).min()) > 1e-3
    np.testing.assert_array_equal(gt.numpy(), np.asarray(wt))
    np.testing.assert_allclose(gp.numpy(), np.asarray(wp), rtol=1e-6)
    # The prob is the chosen entry's softmax prob before the temperature.
    chosen = (torch.from_numpy(idxs) == gt[:, None]).float().argmax(-1)
    np.testing.assert_allclose(gp.numpy(),
                               probs.gather(-1, chosen[:, None])[:, 0],
                               rtol=1e-6)


@pytest.mark.parametrize("top_k", [1, 8])
def test_make_sampler_matches_jax(top_k):
    """Full logits -> top-k (ties to the lower index) -> draw."""
    rng = np.random.default_rng(3 + top_k)
    b, v = 4, 300
    logits = rng.normal(0, 3, (b, v)).astype(np.float32)
    logits[0, 17] = logits[0, 5] = logits[0].max() + 1.0  # a tie at the top
    jkeys = jnp.stack([j_sample_key(9, qi, 7) for qi in range(b)])
    keys = sample_key(9, torch.arange(b), 7)
    wt, wp = jsampling.make_sampler(top_k, 0.8)(jnp.asarray(logits), jkeys)
    gt, gp = sampling.make_sampler(top_k, 0.8)(torch.from_numpy(logits), keys)
    np.testing.assert_array_equal(gt.numpy(), np.asarray(wt))
    np.testing.assert_allclose(gp.numpy(), np.asarray(wp), rtol=1e-6)
    vals, idxs = sampling.top_k_sorted(torch.from_numpy(logits), 2)
    assert idxs[0].tolist() == [5, 17] and vals[0, 0] == vals[0, 1]


# Chi-square of 20 000 draws over 8 categories (7 degrees of freedom): the
# 99.9th percentile is 24.32.  Seeds are fixed, so the statistic is a
# constant of the code: it cannot flake, and a wrong distribution (say,
# the temperature ignored) gives a statistic in the thousands.
CHI2_7_999 = 24.32


@pytest.mark.parametrize("temperature", [1.0, 0.7])
def test_draws_follow_the_analytic_distribution(temperature):
    n = 20000
    vals = torch.tensor([[2.0, 1.5, 1.2, 0.4, 0.0, -0.3, -1.0, -2.5]])
    idxs = torch.arange(8, dtype=torch.int32)[None]
    p = torch.softmax(vals[0].double(), -1) ** (1.0 / temperature)
    p = (p / p.sum()).numpy()
    tok, prob = sampling.sample_stream(
        vals.expand(n, 8), idxs.expand(n, 8), 2024,
        torch.zeros(n, dtype=torch.int32), torch.arange(n, dtype=torch.int32),
        temperature)
    counts = np.bincount(tok.numpy(), minlength=8)
    chi2 = float(((counts - n * p) ** 2 / (n * p)).sum())
    assert chi2 < CHI2_7_999, (chi2, counts.tolist())
    # The reported prob is the pre-temperature softmax of the chosen entry.
    np.testing.assert_allclose(
        prob.numpy(), torch.softmax(vals[0], -1)[tok.long()].numpy(),
        rtol=1e-6)
    if temperature != 1.0:
        # The same draws held to the T = 1 distribution must fail.
        p1 = torch.softmax(vals[0].double(), -1).numpy()
        assert float(((counts - n * p1) ** 2 / (n * p1)).sum()) > 10 * CHI2_7_999


def test_stream_invariances():
    """The same (seed, query, position) gives the same token alone, in a
    batch of 5 and with the rows permuted; another seed gives another
    transcript."""
    rng = np.random.default_rng(8)
    b, k = 5, 32
    vals, idxs = _rows(rng, b, k)
    vals, idxs = torch.from_numpy(vals), torch.from_numpy(idxs)
    qi = torch.arange(b, dtype=torch.int32)
    pos = torch.tensor([4, 90, 17, 17, 2000], dtype=torch.int32)
    tok, prob = sampling.sample_stream(vals, idxs, 3, qi, pos, 0.8)
    for r in range(b):
        t1, p1 = sampling.sample_stream(vals[r:r + 1], idxs[r:r + 1], 3,
                                        qi[r:r + 1], pos[r:r + 1], 0.8)
        assert int(t1[0]) == int(tok[r]) and float(p1[0]) == float(prob[r])
    perm = torch.tensor([3, 0, 4, 2, 1])
    tp, _ = sampling.sample_stream(vals[perm], idxs[perm], 3, qi[perm],
                                   pos[perm], 0.8)
    assert tp.tolist() == tok[perm].tolist()
    # Many positions of one row: two seeds give different transcripts.
    n = 64
    many = [sampling.sample_stream(
        vals[:1].expand(n, k), idxs[:1].expand(n, k), seed,
        torch.zeros(n, dtype=torch.int32), torch.arange(n, dtype=torch.int32),
        1.0)[0].tolist() for seed in (3, 4)]
    assert many[0] != many[1]
    # ... and the query index alone changes the stream too.
    other, _ = sampling.sample_stream(
        vals[:1].expand(n, k), idxs[:1].expand(n, k), 3,
        torch.ones(n, dtype=torch.int32), torch.arange(n, dtype=torch.int32),
        1.0)
    assert other.tolist() != many[0]
