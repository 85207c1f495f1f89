"""The fused top-k head (K6) of gemma_tpu_torch: its plan over the
vocabulary, its selection and merge, and its wrappers, checked without a
card.

A CUDA kernel cannot run here, so ops/matmul.py carries a plain-PyTorch
emulation of the kernel's order (`matmul_topk_emulated`: the logits of the
folded prologue's A, then per slice of `topk_slices` the selection of
matmul.cu:select_sorted, `select_sorted_emulated`, and the same selection
over the slices' lists).  These tests hold:
  - the head's row-group plan (K3's, `top1_plan`) and the selection's
    slices cover N exactly once, at N 256000 and at small N with ragged
    edges;
  - the emulation against the JAX package's `matmul_topk` (its Pallas
    kernel in interpret mode): values and indices equal on integer logits
    (exact in any order of summation, so full of ties) across slices, row
    groups and JAX's column blocks, with a mask, at k_top 1, 8, 64 and 128
    and M 1, 4, 13 and 20, at slice lengths that give 16, 4 and 1 slices;
    tied leaders under the cap; fewer live columns than k_top; a mask that bans
    every column; and, on i8 weights with the final norm and the cap,
    values within 1e-4 of max|logit| and indices equal wherever the
    neighbouring values are further apart;
  - the selection against a sort, with repeated keys;
  - the constants the emulation shares with the source;
  - the wrappers' arguments, with faked entries: the f32 A and the final
    norm go to the head itself (no prologue pass), and the launches count
    the head and its selection."""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gemma_tpu.ops import matmul as jmm
from gemma_tpu_torch.ops import _cuda
from gemma_tpu_torch.ops import matmul as tmm
from tests.test_torch_matmul import i8_arrays, jax_qt, torch_qt

torch.set_num_threads(1)

K, N = 256, 1000
BLOCKS = (8, 256, K)  # JAX's head: one K step, 256-column blocks
SLICES = (64, 256, tmm.TOPK_SLICE)
MARGIN = 1e-4


def _int_head(rng, n=N):
    """f32 weights of small integers (exact in bf16) in both packages:
    with bf16 A of small integers every logit is an exact integer whatever
    the order of the sums, and many are tied."""
    w = rng.integers(-2, 3, (n, K)).astype(np.float32)
    return (jmm.QuantTensor("f32", (n, K), 1.0, {"w": jnp.asarray(w)}),
            tmm.QuantTensor("f32", (n, K), 1.0,
                            {"w": torch.from_numpy(w.copy())}))


def _jax(wj, a, k_top, cap=0.0, nw=None, mask=None):
    aj = jnp.asarray(a) if nw is not None else \
        jnp.asarray(a).astype(jnp.bfloat16)
    v, i = jmm.matmul_topk(
        aj, wj, k_top, final_cap=cap,
        prologue_norm=None if nw is None else jnp.asarray(nw),
        allowed_mask=None if mask is None else jnp.asarray(mask),
        blocks=BLOCKS, interpret=True)
    return np.asarray(v), np.asarray(i)


def _emulated(wt, a, k_top, slice_len, cap=0.0, nw=None, mask=None):
    at = torch.from_numpy(a) if nw is not None else \
        torch.from_numpy(a).to(torch.bfloat16)
    v, i = tmm.matmul_topk_emulated(
        at, wt, k_top, final_cap=cap,
        prologue_norm=None if nw is None else torch.from_numpy(nw),
        allowed_mask=None if mask is None else torch.from_numpy(mask),
        slice_len=slice_len)
    assert v.dtype == torch.float32 and i.dtype == torch.int32
    return v.numpy(), i.numpy()


# --- the plan ---------------------------------------------------------------

@pytest.mark.parametrize("n,blocks", [(256000, 264), (256000, 528),
                                      (256128, 264), (1000, 1), (1000, 3),
                                      (4104, 7), (8, 1)])
def test_plan_covers_every_column_once(n, blocks):
    """Every vocabulary row lies in exactly one warp's row groups of the
    head, and in exactly one slice of the selection; slices are
    contiguous, TOPK_SLICE long but the last, and their lists of 128 fit
    the merging block at Gemma2's vocabulary."""
    plan = tmm.top1_plan(n, blocks)
    cols = np.concatenate([np.arange(16 * r, min(16 * r + 16, n))
                           for groups in plan for r in groups] or [[]])
    assert len(cols) == n
    np.testing.assert_array_equal(np.sort(cols), np.arange(n))
    slices = tmm.topk_slices(n)
    assert [c for s in slices for c in s] == list(range(n))
    assert all(len(s) == tmm.TOPK_SLICE for s in slices[:-1])
    assert 0 < len(slices[-1]) <= tmm.TOPK_SLICE
    if n <= 256128:
        assert len(slices) * tmm.MAX_TOPK <= tmm.TOPK_MAX_MERGE


def test_constants_match_the_source():
    """The emulation's slice and the merge's capacity are the kernel's; K6's
    head is K3's stream, and its entry chains no prologue pass."""
    src = (_cuda.CSRC / "matmul.cu").read_text()
    assert f"constexpr int kSelSlice = {tmm.TOPK_SLICE};" in src
    assert f"constexpr int kSelMaxMerge = {tmm.TOPK_MAX_MERGE};" in src
    assert f"constexpr int kTopkMax = {tmm.MAX_TOPK};" in src
    assert "top1_body<CODEC, NT, true>(q);" in src
    entry = src[src.index("static int topk_entry("):]
    entry = entry[:entry.index("\n}\n")]
    assert "operand_a(" not in entry and "prenorm" not in entry
    assert re.findall(r"launch_(head|select)", entry) == ["head", "head",
                                                          "select"]


# --- the selection ------------------------------------------------------------

@pytest.mark.parametrize("seed", range(20))
def test_selection_matches_a_sort(seed):
    """select_sorted_emulated, and block_topk_emulated (its pruning
    first), against a sort by (value descending, index ascending):
    small-integer values (many ties), -inf, -0.0 beside +0.0, fewer entries
    than k_top or than the block's threads, and repeated (value, index)
    pairs (the empty slots of the lists), which it may take in any order."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 400 if seed % 2 else 5000))
    k_top = int(rng.choice([1, 2, 8, 64, 128]))
    v = (rng.integers(-6, 6, n) * rng.choice([1.0, 0.25])).astype(np.float32)
    v[rng.random(n) < 0.1] = -np.inf
    v[rng.random(n) < 0.05] = -0.0
    i = rng.permutation(4 * n)[:n].astype(np.int32)
    if seed % 4 == 0:  # empty slots, repeated
        v[: n // 3] = -np.inf
        i[: n // 3] = 2 ** 31 - 1
    keys = tmm.topk_keys(v, i)
    order = sorted(range(n), key=lambda j: (-float(v[j]), int(i[j])))
    k = min(k_top, n)
    for select in (tmm.select_sorted_emulated, tmm.block_topk_emulated):
        got_v, got_i = tmm._key_entries(select(keys, k_top))
        np.testing.assert_array_equal(got_v[:k], v[order[:k]])
        np.testing.assert_array_equal(got_i[:k], i[order[:k]])
        assert (got_v[k:] == -np.inf).all()
        assert (got_i[k:] == 2 ** 31 - 1).all()


# --- the emulation against JAX ----------------------------------------------

@pytest.mark.parametrize("m", [1, 4, 13, 20])
@pytest.mark.parametrize("k_top", [1, 8, 64, 128])
def test_emulation_matches_jax_exactly(k_top, m):
    """Integer logits under a 2-in-3 mask: values and indices equal JAX's
    at every slice length, ties broken by the lower index across slices,
    row groups and JAX's column blocks."""
    rng = np.random.default_rng(100 * k_top + m)
    wj, wt = _int_head(rng)
    a = rng.integers(-2, 3, (m, K)).astype(np.float32)
    mask = rng.random(N) < 0.67
    want = _jax(wj, a, k_top, mask=mask)
    if k_top > 1:  # the case has ties among the chosen
        assert (np.diff(want[0], axis=1) == 0).any()
    for slice_len in SLICES:
        got = _emulated(wt, a, k_top, slice_len, mask=mask)
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_array_equal(got[0], want[0])
    assert mask[want[1]].all()


def test_tied_leaders_go_to_the_lowest_index():
    """Four equal weight rows whose capped logits lead every row, tied
    exactly, in four different slices of 64: the list starts with them in
    index order, as JAX's does."""
    rng = np.random.default_rng(5)
    w = rng.normal(0, 0.2, (N, K)).astype(np.float32)
    w[[700, 123, 5, 999]] = 1.0
    wj = jmm.QuantTensor("f32", (N, K), 1.0, {"w": jnp.asarray(w)})
    wt = tmm.QuantTensor("f32", (N, K), 1.0, {"w": torch.from_numpy(w)})
    a = rng.normal(2.0, 1.0, (4, K)).astype(np.float32)
    nw = np.zeros(K, np.float32)
    want = _jax(wj, a, 8, cap=30.0, nw=nw)
    for slice_len in SLICES:
        got = _emulated(wt, a, 8, slice_len, cap=30.0, nw=nw)
        np.testing.assert_array_equal(got[1][:, :4],
                                      np.tile([5, 123, 700, 999], (4, 1)))
        np.testing.assert_array_equal(got[1][:, :4], want[1][:, :4])
        assert (got[0][:, :4] == got[0][:, :1]).all()


@pytest.mark.parametrize("k_top", [8, 64])
def test_fewer_live_columns_than_k(k_top):
    """Five live columns: they lead in JAX's order, the rest of the list is
    (-inf, index 0), whatever the slices."""
    rng = np.random.default_rng(6)
    wj, wt = _int_head(rng)
    a = rng.integers(-2, 3, (4, K)).astype(np.float32)
    mask = np.zeros(N, bool)
    mask[[3, 70, 500, 501, 999]] = True
    want = _jax(wj, a, k_top, mask=mask)
    for slice_len in SLICES:
        got = _emulated(wt, a, k_top, slice_len, mask=mask)
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_array_equal(got[0], want[0])
        assert np.isneginf(got[0][:, 5:]).all() and (got[1][:, 5:] == 0).all()


def test_fully_banned_row():
    """A mask that bans every column: every entry (-inf, index 0)."""
    rng = np.random.default_rng(8)
    wj, wt = _int_head(rng)
    a = rng.integers(-2, 3, (3, K)).astype(np.float32)
    mask = np.zeros(N, bool)
    want = _jax(wj, a, 8, mask=mask)
    for slice_len in SLICES:
        got = _emulated(wt, a, 8, slice_len, mask=mask)
        np.testing.assert_array_equal(got[1], np.zeros((3, 8), np.int32))
        np.testing.assert_array_equal(got[1], want[1])
        assert np.isneginf(got[0]).all() and np.isneginf(want[0]).all()


@pytest.mark.parametrize("m", [4, 20])
def test_emulation_with_norm_and_cap_matches_jax(m):
    """i8 weights, the final norm and the cap: the emulated head's values
    within 1e-4 of max|logit| of JAX's, indices equal wherever both
    neighbouring values are further apart than that (the products are
    summed in another order)."""
    rng = np.random.default_rng(30 + m)
    arrays = i8_arrays(rng, N, K)
    arrays["inv_scales"] *= np.float32(4.0)  # logits of std ~4
    wj, wt = jax_qt(arrays), torch_qt(arrays)
    a = rng.normal(0, 3, (m, K)).astype(np.float32)
    nw = rng.normal(0, 0.1, (K,)).astype(np.float32)
    want_v, want_i = _jax(wj, a, 64, cap=30.0, nw=nw)
    scale = np.abs(want_v).max()
    for slice_len in SLICES:
        got_v, got_i = _emulated(wt, a, 64, slice_len, cap=30.0, nw=nw)
        assert np.abs(got_v - want_v).max() <= MARGIN * scale
        gap = np.diff(got_v, axis=1) < -MARGIN * scale
        pinned = np.ones_like(got_i, bool)
        pinned[:, 1:] &= gap
        pinned[:, :-1] &= gap
        assert pinned.sum() > got_i.size // 2
        np.testing.assert_array_equal(got_i[pinned], want_i[pinned])


# --- the wrappers, faked ----------------------------------------------------

@pytest.fixture
def fake_entries(monkeypatch):
    """K6's two C entries faked: each records its arguments and reports
    what the real one reports (the head and its selection; the selection
    alone)."""
    calls = []

    def check(t, name, dtype, shape=None):
        assert t.dtype == dtype and t.is_contiguous(), name
        assert shape is None or tuple(t.shape) == tuple(shape), name

    monkeypatch.setattr(_cuda, "check", check)
    monkeypatch.setattr(_cuda, "_stream", lambda: 0)
    for kernel, report in ((tmm.TOPK["i8"], 0b11), (tmm.TOPK_MERGE, 0b1)):
        def fn(*args, kernel=kernel, report=report):
            *args, launched, _stream = args
            assert len(args) == len(kernel.argtypes)
            calls.append((kernel.name, args))
            launched._obj.value = report
            return 0

        monkeypatch.setattr(kernel, "_fn", fn)
    return calls


def test_topk_wrapper_folds_the_norm(fake_entries):
    """The head gets the f32 A and the final norm itself (no bf16 scratch,
    no prologue pass), an [M, N] logits buffer, lists for N's slices, the
    device's tickets (one a row at least); one call counts one head and one
    selection launch, and no prologue pass."""
    rng = np.random.default_rng(12)
    w = torch_qt(i8_arrays(rng, 264, K))
    x = torch.from_numpy(rng.normal(0, 3, (4, K)).astype(np.float32))
    nw = torch.from_numpy(rng.normal(0, 0.1, (K,)).astype(np.float32))
    kernels = (tmm.TOPK["i8"], tmm.TOPK_MERGE, tmm.PRENORM)
    before = [k.launches for k in kernels]
    vals, idxs = tmm._topk_cuda(x, w, 64, 30.0, nw, None)
    assert [k.launches - b for k, b in zip(kernels, before)] == [1, 1, 0]
    ((name, args),) = fake_entries
    assert name == "topk_i8"
    assert args[0] == x.data_ptr() and args[1] == nw.data_ptr()
    nb = len(tmm._b_args("i8"))
    cap, mask, k_top = args[2 + nb:5 + nb]
    assert (cap, mask, k_top) == (30.0, None, 64)
    assert args[-5:] == [4, 264, K, tmm.TOPK_BLOCKS, 1]
    tickets = tmm._scratch[x.device][0]
    assert args[-8] == tickets.data_ptr() and tickets.numel() >= 4
    assert args[-7:-5] == [vals.data_ptr(), idxs.data_ptr()]
    assert vals.shape == idxs.shape == (4, 64)


def test_merge_wrapper_takes_the_selection(fake_entries):
    """The merge alone: 528 lists of 64 a row are nine slices of the
    selection, with scratch lists [M, 9, 64] and the device's tickets."""
    pv = torch.zeros(4, 528, 64)
    pi = torch.zeros(4, 528, 64, dtype=torch.int32)
    before = tmm.TOPK_MERGE.launches
    vals, idxs = tmm._merge_cuda(pv, pi, 64)
    assert tmm.TOPK_MERGE.launches - before == 1
    ((name, args),) = fake_entries
    assert name == "topk_merge"
    assert args[:7] == [pv.data_ptr(), pi.data_ptr(), vals.data_ptr(),
                        idxs.data_ptr(), 4, 528, 64]
    assert args[-1] == 9 == len(tmm.topk_slices(528 * 64))
    assert args[-2] == tmm._scratch[pv.device][0].data_ptr()
