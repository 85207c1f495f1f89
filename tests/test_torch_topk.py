"""The port's fused top-k head (gemma_tpu_torch/ops/matmul.py:matmul_topk,
plain path on CPU) vs the JAX package's `matmul_topk` run through its
Pallas kernel (_topk_kernel) in interpret mode, on the same numpy-made
weights of each of the five kinds: with and without the soft cap, the
final-norm prologue and an allowed mask, at k_top 1, 4 and 128 and an N
that is no multiple of JAX's column block; a constructed tie across block
boundaries (the twin of tests/test_matmul.py:555), a row with fewer live
columns than k_top, a fully banned row, and k_top = 200 through the
composed path.

Tolerances (those of tests/test_torch_top1.py for the same product): the
port computes the same logits in another f32 summation order, so values
agree to 1e-4 of max|logit| and indices must be equal wherever the
neighbouring values (in the port's own descending list) differ by more
than that; closer neighbours may swap."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gemma_tpu.ops import matmul as jmm
from gemma_tpu_torch.ops import matmul as tmm
from gemma_tpu_torch.utils.synth import sfp_rms
from tests.test_torch_codecs import weights
from tests.test_torch_matmul import i8_arrays, jax_qt, torch_qt

torch.set_num_threads(1)

M, K, N = 5, 384, 1000          # N pads to 1024 in JAX's 256-column blocks
BLOCKS = (8, 256, K)            # one K step, so the prologue norm fuses
CAP = 30.0
MARGIN = 1e-4
KINDS = ["i8", "sfp", "nuq", "bf16", "f32"]


def _weights(kind, rng, n=N):
    """Weights whose logits have std ~4: below the cap's saturation."""
    if kind == "i8":
        w = i8_arrays(rng, n, K)
        w["inv_scales"] *= np.float32(4.0)
        return jax_qt(w), torch_qt(w)
    if kind in ("sfp", "nuq"):
        return weights(rng, kind, n=n, scale=4.0 / (np.sqrt(K) * sfp_rms()))
    return weights(rng, kind, n=n, scale=4.0)


def _run(wj, wt, a, nw, k_top, cap, mask, blocks=BLOCKS):
    """(JAX (vals, idxs), port (vals, idxs)) as numpy.  `a` is f32 with a
    prologue norm `nw`, else bf16-representable f32 fed as bf16."""
    if nw is None:
        aj = jnp.asarray(a).astype(jnp.bfloat16)
        at = torch.from_numpy(a).to(torch.bfloat16)
    else:
        aj, at = jnp.asarray(a), torch.from_numpy(a)
    want = jmm.matmul_topk(
        aj, wj, k_top, final_cap=cap,
        prologue_norm=None if nw is None else jnp.asarray(nw),
        allowed_mask=None if mask is None else jnp.asarray(mask),
        blocks=blocks, interpret=True)
    got = tmm.matmul_topk(
        at, wt, k_top, final_cap=cap,
        prologue_norm=None if nw is None else torch.from_numpy(nw),
        allowed_mask=None if mask is None else torch.from_numpy(mask))
    return [np.asarray(x) for x in want], [x.numpy() for x in got]


def _check(want, got, k_top):
    (wv, wi), (gv, gi) = want, got
    assert gv.shape == gi.shape == (M, k_top)
    assert gv.dtype == np.float32 and gi.dtype == np.int32
    live = np.isfinite(wv)
    np.testing.assert_array_equal(np.isfinite(gv), live)
    scale = np.abs(wv[live]).max()
    assert np.abs(gv[live] - wv[live]).max() <= MARGIN * scale
    assert (np.diff(gv, axis=1)[live[:, 1:]] <= 0).all()  # descending
    # An index is pinned where both neighbours are further than the margin.
    gap = np.abs(np.diff(np.where(live, gv, -1e30), axis=1)) > MARGIN * scale
    pinned = np.ones_like(live)
    pinned[:, 1:] &= gap
    pinned[:, :-1] &= gap
    pinned &= live
    assert pinned.mean() > 0.5, "the case must leave real comparisons"
    np.testing.assert_array_equal(gi[pinned], wi[pinned])
    np.testing.assert_array_equal(gi[~live], 0)
    np.testing.assert_array_equal(wi[~live], 0)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("k_top", [1, 4, 128])
@pytest.mark.parametrize("variant", ["raw", "cap_prologue", "cap_mask",
                                     "cap_prologue_mask"])
def test_matmul_topk_matches_jax_kernel(kind, k_top, variant):
    rng = np.random.default_rng(KINDS.index(kind) * 100 + k_top
                                + len(variant))
    wj, wt = _weights(kind, rng)
    cap = CAP if "cap" in variant else 0.0
    if "prologue" in variant:
        a = rng.normal(0, 3, (M, K)).astype(np.float32)
        nw = rng.normal(0, 0.1, (K,)).astype(np.float32)
    else:
        a = np.array(jnp.asarray(rng.normal(0, 1, (M, K)).astype(
            np.float32)).astype(jnp.bfloat16).astype(jnp.float32))
        nw = None
    mask = None
    if "mask" in variant:
        mask = rng.random(N) < 0.5
    want, got = _run(wj, wt, a, nw, k_top, cap, mask)
    _check(want, got, k_top)
    if mask is not None:
        assert mask[got[1]].all()


def _exact_case(rng):
    """Small integers in A and W: every logit is exact in f32 in any
    summation order, so ties are exact."""
    a = rng.integers(-2, 3, (M, K)).astype(np.float32)
    w = rng.integers(-1, 2, (N, K)).astype(np.float32)
    return a, w


def _dense(w):
    n = w.shape[0]
    return (jmm.QuantTensor("f32", (n, K), 1.0, {"w": jnp.asarray(w)}),
            tmm.QuantTensor("f32", (n, K), 1.0, {"w": torch.from_numpy(w)}))


def test_matmul_topk_ties_across_blocks():
    """Equal maxima in three different 256-column blocks, and exact ties
    throughout the integer logits: descending values, ties to the lower
    index, exactly as lax.top_k and the JAX kernel order them."""
    rng = np.random.default_rng(80)
    a, w = _exact_case(rng)
    cols = [900, 123, 600]
    for c in cols:
        w[c] = 2.0 * np.sign(a[0])  # the largest logit row 0 can reach
    wj, wt = _dense(w)
    want, got = _run(wj, wt, a, None, 16, 0.0, None)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[1][0, :3].tolist() == sorted(cols)
    logits = a @ w.T
    ref_v, ref_i = [torch.from_numpy(np.asarray(x)) for x in
                    jax.lax.top_k(jnp.asarray(logits), 16)]
    np.testing.assert_array_equal(got[0], ref_v.numpy())
    np.testing.assert_array_equal(got[1], ref_i.numpy())
    assert (np.diff(got[0], axis=1) == 0).any()  # ties beyond the planted


def test_matmul_topk_fewer_live_columns_than_k():
    """Three allowed columns, k_top = 8: the live entries, then (-inf,
    index 0), as the Pallas kernel leaves them."""
    rng = np.random.default_rng(81)
    a, w = _exact_case(rng)
    wj, wt = _dense(w)
    mask = np.zeros(N, bool)
    mask[[7, 300, 999]] = True
    want, got = _run(wj, wt, a, None, 8, CAP, mask)
    for vals, idxs in (want, got):
        assert np.isfinite(vals[:, :3]).all()
        assert np.isneginf(vals[:, 3:]).all()
        assert (idxs[:, 3:] == 0).all()
        assert (np.sort(idxs[:, :3], axis=1) == [7, 300, 999]).all()
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[0][:, :3], want[0][:, :3], rtol=1e-6)


def test_matmul_topk_fully_banned_row():
    rng = np.random.default_rng(82)
    a, w = _exact_case(rng)
    wj, wt = _dense(w)
    want, got = _run(wj, wt, a, None, 4, CAP, np.zeros(N, bool))
    for vals, idxs in (want, got):
        assert np.isneginf(vals).all() and (idxs == 0).all()


@pytest.mark.parametrize("kind", ["i8", "sfp"])
def test_matmul_topk_above_128_is_composed(kind):
    """k_top = 200: both packages leave their kernel for the head GEMM, the
    cap, a NEG_INF mask and a full top-k (real indices everywhere)."""
    rng = np.random.default_rng(83 + KINDS.index(kind))
    wj, wt = _weights(kind, rng)
    a = rng.normal(0, 3, (M, K)).astype(np.float32)
    nw = rng.normal(0, 0.1, (K,)).astype(np.float32)
    mask = rng.random(N) < 0.5
    want, got = _run(wj, wt, a, nw, 200, CAP, mask)
    _check(want, got, 200)
    assert mask[got[1]].all()


def test_matmul_topk_rejects_bad_k():
    _, wt = _weights("f32", np.random.default_rng(0), n=64)
    a = torch.zeros(2, K, dtype=torch.bfloat16)
    for k_top in (0, 65):
        with pytest.raises(ValueError, match="k_top"):
            tmm.matmul_topk(a, wt, k_top)


@pytest.mark.parametrize("k_top", [1, 5, 64])
def test_topk_merge_plain_orders_by_value_then_index(k_top):
    """The merge pass's plain version: the first k_top of all the lists'
    pairs by (value descending, index ascending), dead entries index 0."""
    rng = np.random.default_rng(90 + k_top)
    m, blocks = 3, 7
    vals = rng.integers(-3, 4, (m, blocks, k_top)).astype(np.float32)
    vals = -np.sort(-vals, axis=-1)
    vals[:, -1, k_top // 2:] = -np.inf
    idxs = rng.permutation(m * blocks * k_top).reshape(
        m, blocks, k_top).astype(np.int32)
    gv, gi = tmm.topk_merge_plain(torch.from_numpy(vals),
                                  torch.from_numpy(idxs), k_top)
    for r in range(m):
        pairs = sorted(zip((-vals[r]).ravel().tolist(),
                           idxs[r].ravel().tolist()))[:k_top]
        assert gv[r].tolist() == [-v for v, _ in pairs]
        assert gi[r].tolist() == [0 if v == np.inf else i for v, i in pairs]
