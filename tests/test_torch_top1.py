"""The port's fused greedy head (gemma_tpu_torch/ops/matmul.py:matmul_top1,
plain path on CPU) vs the JAX package's `matmul_top1` run through its
Pallas kernel (_top1_kernel) in interpret mode, on the same numpy-made
weights: i8 and f32 weights, the final-norm prologue, need_prob=False, an
allowed mask (also one that bans every column), a planted tie and
all-negative logits with N padding (tests/test_matmul.py:395-525 are the
JAX package's own cases).

Tolerances: the port computes the same logits in another f32 summation
order (~1e-6 relative), so tokens must be equal wherever the capped
top1-top2 margin exceeds 1e-4 of max|logit| (the cases below have no
closer pair; the planted tie is exact by construction), and probs agree
to rtol 1e-5 (online vs one-pass exp sums, as the JAX suite bounds its
kernel against the composed path)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gemma_tpu.ops import matmul as jmm
from gemma_tpu_torch.ops import matmul as tmm
from tests.test_torch_matmul import i8_arrays, jax_qt, torch_qt

torch.set_num_threads(1)

M, K, N = 5, 384, 1000          # N pads to 1024 in JAX's 256-column blocks
BLOCKS = (8, 256, K)            # one K step, so the prologue norm fuses
CAP = 30.0
MARGIN = 1e-4


def _weights(kind, rng, n=N):
    if kind == "i8":
        w = i8_arrays(rng, n, K)
        # Logits of std ~4: below the cap's saturation, above ties.
        w["inv_scales"] *= np.float32(4.0)
        return jax_qt(w), torch_qt(w)
    dense = rng.normal(0, 0.2, (n, K)).astype(np.float32)
    return (jmm.QuantTensor("f32", (n, K), 1.0, {"w": jnp.asarray(dense)}),
            tmm.QuantTensor("f32", (n, K), 1.0,
                            {"w": torch.from_numpy(dense.copy())}))


def _inputs(case, rng):
    """(A for JAX, A for the port, prologue norm or None)."""
    if case == "prologue":
        a = rng.normal(0, 3, (M, K)).astype(np.float32)
        nw = rng.normal(0, 0.1, (K,)).astype(np.float32)
        return jnp.asarray(a), torch.from_numpy(a), nw
    a = jnp.asarray(rng.normal(0, 1, (M, K)).astype(np.float32)).astype(
        jnp.bfloat16)
    return a, torch.from_numpy(np.asarray(a, np.float32)).to(
        torch.bfloat16), None


def _run(wj, wt, aj, at, nw, mask=None, need_prob=True, cap=CAP):
    mj = None if mask is None else jnp.asarray(mask)
    mt = None if mask is None else torch.from_numpy(mask)
    want = jmm.matmul_top1(
        aj, wj, final_cap=cap,
        prologue_norm=None if nw is None else jnp.asarray(nw),
        allowed_mask=mj, blocks=BLOCKS, interpret=True, need_prob=need_prob)
    got = tmm.matmul_top1(
        at, wt, final_cap=cap,
        prologue_norm=None if nw is None else torch.from_numpy(nw),
        allowed_mask=mt, need_prob=need_prob)
    return [np.asarray(x) for x in want], [x.numpy() for x in got]


def _check(want, got, logits, need_prob=True):
    """Tokens equal where the margin allows; probs within rtol 1e-5."""
    (wt, wp), (gt, gp) = want, got
    assert gt.dtype == np.int32 and gp.dtype == np.float32
    scale = np.abs(logits[np.isfinite(logits)]).max()
    top2 = np.sort(logits, axis=-1)[:, -2:]
    clear = (top2[:, 1] - top2[:, 0]) > MARGIN * scale
    assert clear.sum() >= M - 1, "the case must leave real comparisons"
    np.testing.assert_array_equal(gt[clear], wt[clear])
    if need_prob:
        np.testing.assert_allclose(gp, wp, rtol=1e-5)
    else:
        np.testing.assert_array_equal(gp, np.ones(M, np.float32))
        np.testing.assert_array_equal(wp, np.ones(M, np.float32))


def _ref_logits(wt, at, nw, cap, mask=None):
    """The port's plain logits (capped when cap), masked to -inf."""
    lg = tmm.matmul_plain(at, wt, prologue_norm=None if nw is None
                          else torch.from_numpy(nw))
    if cap:
        lg = cap * torch.tanh(lg / cap)
    lg = lg.numpy()
    if mask is not None:
        lg = np.where(mask[None], lg, -np.inf)
    return lg


@pytest.mark.parametrize("kind", ["i8", "f32"])
@pytest.mark.parametrize("case", ["plain", "prologue", "no_prob", "mask",
                                  "mask_no_prob"])
def test_matmul_top1_matches_jax_kernel(kind, case):
    rng = np.random.default_rng({"i8": 50, "f32": 60}[kind] + len(case))
    wj, wt = _weights(kind, rng)
    aj, at, nw = _inputs("prologue" if case == "prologue" else "plain", rng)
    need_prob = not case.endswith("no_prob")
    mask = None
    if case.startswith("mask"):
        # A sparse allowed set (about 1/8 of the vocab) that bans every
        # row's unconstrained winner.
        free = _ref_logits(wt, at, nw, CAP).argmax(-1)
        mask = np.zeros(N, bool)
        mask[::8] = True
        mask[free] = False
    want, got = _run(wj, wt, aj, at, nw, mask, need_prob)
    logits = _ref_logits(wt, at, nw, CAP if need_prob else 0.0, mask)
    _check(want, got, logits, need_prob)
    if mask is not None:
        assert mask[got[0]].all()


@pytest.mark.parametrize("need_prob", [True, False])
def test_matmul_top1_all_banned(need_prob):
    """A mask that bans every column: token 0 and prob 1/1e-30 (1.0 when
    need_prob is False), as _top1_kernel's final block gives."""
    rng = np.random.default_rng(70)
    wj, wt = _weights("i8", rng)
    aj, at, nw = _inputs("plain", rng)
    (wt_, wp), (gt, gp) = _run(wj, wt, aj, at, nw, np.zeros(N, bool),
                               need_prob)
    np.testing.assert_array_equal(wt_, np.zeros(M, np.int32))
    np.testing.assert_array_equal(gt, np.zeros(M, np.int32))
    prob = np.float32(1.0 / np.float32(1e-30)) if need_prob else 1.0
    np.testing.assert_allclose(wp, np.full(M, prob, np.float32), rtol=1e-6)
    np.testing.assert_allclose(gp, np.full(M, prob, np.float32), rtol=1e-6)


@pytest.mark.parametrize("need_prob", [True, False])
def test_matmul_top1_planted_tie(need_prob):
    """Two equal columns at the row's maximum: the lower index wins.
    Small integers in A and W make every logit exact in f32 (no cap), so
    the tie holds in any summation order."""
    rng = np.random.default_rng(80)
    a = rng.integers(-2, 3, (M, K)).astype(np.float32)
    w = rng.integers(-1, 2, (N, K)).astype(np.float32)
    lo, hi = 123, 877
    w[lo] = w[hi] = 2.0 * np.sign(a[0])  # the largest logit row 0 can reach
    wj = jmm.QuantTensor("f32", (N, K), 1.0, {"w": jnp.asarray(w)})
    wt = tmm.QuantTensor("f32", (N, K), 1.0, {"w": torch.from_numpy(w)})
    aj = jnp.asarray(a).astype(jnp.bfloat16)
    at = torch.from_numpy(a).to(torch.bfloat16)
    (wt_, wp), (gt, gp) = _run(wj, wt, aj, at, None, need_prob=need_prob,
                               cap=0.0)
    assert wt_[0] == lo and gt[0] == lo
    np.testing.assert_array_equal(gt, wt_)
    if need_prob:
        assert gp[0] <= 0.5 + 1e-6  # the two tied columns share the mass
        np.testing.assert_allclose(gp, wp, rtol=1e-5)


def test_matmul_top1_negative_logits_padding():
    """All logits negative, N padded to JAX's block: the argmax never lands
    in a padded column, and both packages pick the same token."""
    rng = np.random.default_rng(90)
    n = 384  # pads to 512 in 256-column blocks
    a = np.abs(rng.normal(0, 1, (M, K))).astype(np.float32) + 0.1
    w = -np.abs(rng.normal(2, 0.5, (n, K))).astype(np.float32) / K
    wj = jmm.QuantTensor("f32", (n, K), 1.0, {"w": jnp.asarray(w)})
    wt = tmm.QuantTensor("f32", (n, K), 1.0, {"w": torch.from_numpy(w)})
    aj = jnp.asarray(a).astype(jnp.bfloat16)
    at = torch.from_numpy(a).to(torch.bfloat16)
    want, got = _run(wj, wt, aj, at, None)
    assert (got[0] < n).all() and np.isfinite(got[1]).all()
    logits = _ref_logits(wt, at, None, CAP)
    assert (logits < 0).all()
    _check(want, got, logits)
