"""The norms folded into the decode tile (K1 / K2 / K12 at M <= 16 rows) and
the greedy head (K3) of gemma_tpu_torch, in the kernels' own orders.

A CUDA kernel cannot run here, so ops/matmul.py carries a plain-PyTorch
emulation of each order the kernels sum or merge in, and these tests hold
the emulations against the JAX package on the same numpy-made inputs:
  (a) the post-norm + residual epilogue, each block's partial sums of
      squares added in block order (`postnorm_add_blocks`, at
      `decode_split`'s panels and splits), against JAX's
      `matmul(..., epilogue_norm=, add=)` in interpret mode, every weight
      kind, N not a multiple of the panel, and stacked layers;
  (b) the prologue's fixed-order row multiplier (`norm_multiplier`,
      `prenorm_fixed_order`) against JAX's `_norm_a`, including a K padded
      past the logical K, and through the GEMM against JAX's
      `matmul(..., prologue_norm=)`; the plain versions the kernels are
      held against keep rms_norm's prologue, not the kernels' order;
  (c) K3's row-group plan and merge (`matmul_top1_emulated`) against JAX's
      `matmul_top1` (its Pallas kernel in interpret mode): saturated-cap
      ties, a mask, a mask that bans every column, need_prob=False, M of 1,
      4, 13 and 20;
  (d) the plan covers [0, N) exactly once.
The wrappers' arguments to the fused CUDA entries are checked with faked
kernels, and the constants the emulations share with the sources are read
from the sources.

Tolerances: products and sums in another f32 order than JAX's (~1e-6
relative): 1e-5 of max|out| for f32 outputs; the bf16 prologue A may flip
by one bf16 ulp where the two orders round its f32 value to either side
(at most 1 in 500 elements); K3's tokens equal wherever the capped
top1-top2 margin exceeds 1e-4 of max|logit| (exact at the planted ties),
probs within rtol 1e-5."""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gemma_tpu.ops import matmul as jmm
from gemma_tpu_torch.ops import _cuda
from gemma_tpu_torch.ops import matmul as tmm
from tests.test_torch_decode_gemm import faked  # noqa: F401 (a fixture)
from tests.test_torch_prefill_gemm import KINDS, _a, _weights
from tests.test_torch_scan_decode import jax_weight, port_weight, rel_err

torch.set_num_threads(1)

K = 512
L = 3  # layers of a stacked weight


def _codec(kind):
    return "sfp" if kind == "nuq" else kind


# --- (a) the post-norm epilogue in block order ------------------------------

def _epilogue_case(kind, n, m, seed):
    rng = np.random.default_rng(seed)
    jq, tq = _weights(rng, kind, n=n, k=K)
    a_j, a_t = _a(rng, m)
    pw = rng.normal(0, 0.1, (n,)).astype(np.float32)
    add = rng.normal(0, 1, (m, n)).astype(np.float32)
    want = jmm.matmul(a_j, jq, epilogue_norm=jnp.asarray(pw),
                      add=jnp.asarray(add), interpret=True)
    return tq, a_t, torch.from_numpy(pw), torch.from_numpy(add), \
        np.asarray(want, np.float32)


@pytest.mark.parametrize("split", ["decode_split", (1, 2), (2, 8), (8, 4)])
@pytest.mark.parametrize("kind", KINDS)
def test_epilogue_blocks_match_jax(kind, split):
    """N = 264 is no multiple of any panel (16 to 128 columns), so the last
    panel is ragged, and a cluster's shares of it may be empty; the split
    decode_split picks for the shape, and others the sums must not depend
    on beyond f32 reordering."""
    n, m = 264, 4
    tq, a, pw, add, want = _epilogue_case(kind, n, m, 40 + KINDS.index(kind))
    if split == "decode_split":
        split = tmm.decode_split(n, K, _codec(kind), False)
    got = tmm.postnorm_add_blocks(tmm._product_plain(a, tq), pw, add, split)
    assert got.shape == (m, n) and got.dtype == torch.float32
    assert rel_err(got, want) <= 1e-5


@pytest.mark.parametrize("m", [1, 13])
@pytest.mark.parametrize("kind", KINDS)
def test_epilogue_blocks_stacked_layer_match_jax(kind, m):
    """K12's epilogue: layer 1 of L stacked weights (N = 2304, Gemma2-2B's
    model width), against JAX's matmul(layer=) with the post-norm and the
    residual add."""
    rng = np.random.default_rng(60 + 10 * KINDS.index(kind) + m)
    scale = {"bf16": 1.25, "f32": 0.75, "sfp": 0.04, "nuq": 0.04,
             "nuq4": 0.04}.get(kind, 1.0)
    n = 2304
    jqs = [jax_weight(rng, kind, scale, n=n, k=K) for _ in range(L)]
    js = jmm.stack_quant_tensors(jqs)
    ts = tmm.stack_quant_tensors([port_weight(q) for q in jqs])
    a_j, a_t = _a(rng, m)
    pw = rng.normal(0, 0.1, (n,)).astype(np.float32)
    add = rng.normal(0, 1, (m, n)).astype(np.float32)
    want = jmm.matmul(a_j, js, layer=jnp.int32(1),
                      epilogue_norm=jnp.asarray(pw), add=jnp.asarray(add),
                      interpret=True)
    y = tmm._product_plain(a_t, tmm.take_layer(ts, 1))
    got = tmm.postnorm_add_blocks(
        y, torch.from_numpy(pw), torch.from_numpy(add),
        tmm.decode_split(n, K, _codec(kind), False))
    assert rel_err(got, np.asarray(want, np.float32)) <= 1e-5


def test_epilogue_without_add_and_bf16_out():
    """No residual, bf16 output: one bf16 ulp (2^-8 of max|out|) on top of
    the reordered sums."""
    rng = np.random.default_rng(77)
    jq, tq = _weights(rng, "i8", n=264, k=K)
    a_j, a_t = _a(rng, 4)
    pw = rng.normal(0, 0.1, (264,)).astype(np.float32)
    want = jmm.matmul(a_j, jq, epilogue_norm=jnp.asarray(pw),
                      out_dtype=jnp.bfloat16, interpret=True)
    got = tmm.postnorm_add_blocks(tmm._product_plain(a_t, tq),
                                  torch.from_numpy(pw), None, (4, 1),
                                  torch.bfloat16)
    assert got.dtype == torch.bfloat16
    assert rel_err(got.float(), np.asarray(want, np.float32)) <= 2 ** -8


@pytest.mark.parametrize("n,kw,splits", [(264, 8, 1), (264, 1, 8),
                                         (2304, 2, 4), (4608, 1, 8),
                                         (264, 1, 1)])
def test_decode_blocks_cover_columns_in_order(n, kw, splits):
    """The epilogue's blocks take every column once, in column order, each
    a share of one panel."""
    blocks = tmm.decode_blocks(n, kw, splits)
    pc = tmm.DECODE_WARP_COLS[False] * (8 // kw)
    assert len(blocks) == -(-n // pc) * splits
    assert [c for lo, hi in blocks for c in range(lo, hi)] == list(range(n))
    assert all(lo // pc == (hi - 1) // pc for lo, hi in blocks if hi > lo)


# --- (b) the prologue's fixed-order multiplier ----------------------------

@pytest.mark.parametrize("k,k_logical", [(256, 256), (512, 512),
                                         (2304, 2304), (4608, 4608),
                                         (512, 300), (2560, 2304 + 96)])
def test_prologue_matches_norm_a(k, k_logical):
    """bf16(m + m w) against JAX's _norm_a over A zero-padded past the
    logical K (the mean divides by the logical K): the multipliers within
    2 f32 ulps, the bf16 rows within one ulp, at most 1 in 500 elements
    flipped."""
    rng = np.random.default_rng(k + k_logical)
    a = np.zeros((16, k), np.float32)
    a[:, :k_logical] = rng.normal(0, 3, (16, k_logical))
    w = np.zeros((k,), np.float32)
    w[:k_logical] = rng.normal(0, 0.1, (k_logical,))
    want = np.asarray(jmm._norm_a(jnp.asarray(a), jnp.asarray(w)[None],
                                  k_logical), np.float32)
    got = tmm.prenorm_fixed_order(torch.from_numpy(a), torch.from_numpy(w),
                                  k_logical).float().numpy()
    ref_mul = 1 / np.sqrt((a.astype(np.float64) ** 2).sum(1) / k_logical
                          + 1e-6)
    mul = tmm.norm_multiplier(torch.from_numpy(a), k_logical).numpy()
    np.testing.assert_allclose(mul, ref_mul, rtol=2.5e-7)
    diff = np.abs(got - want)
    assert (diff <= 2 ** -7 * np.abs(want) + 1e-30).all()
    assert (diff > 0).mean() <= 1 / 500
    assert (got[:, k_logical:] == 0).all()


@pytest.mark.parametrize("plain", ["matmul_plain", "gated_ffn_plain"])
def test_plain_versions_keep_rms_norm_prologue(plain):
    """The plain versions the kernels are held against take the prologue
    from rms_norm (prenorm_plain), not from the kernels' order: read back
    through a bf16 identity weight (each output one exact product), their
    A is prenorm_plain's bit for bit; prenorm_fixed_order stays within one
    bf16 ulp of it."""
    rng = np.random.default_rng(11)
    k = 2304
    a = torch.from_numpy(rng.normal(0, 30, (13, k)).astype(np.float32))
    nw = torch.from_numpy(rng.normal(0, 0.05, (k,)).astype(np.float32))
    eye = tmm.QuantTensor("bf16", (k, k), 1.0,
                          {"w": torch.eye(k, dtype=torch.bfloat16)})
    want = tmm.prenorm_plain(a, nw).float()
    if plain == "matmul_plain":
        got = tmm.matmul_plain(a, eye, prologue_norm=nw)
    else:  # gelu_tanh(A) * A, in bf16, from the A the prologue made
        got = tmm.gated_ffn_plain(a, eye, eye, prologue_norm=nw).float()
        want = tmm.gated_ffn_plain(want.to(torch.bfloat16), eye,
                                   eye).float()
    assert torch.equal(got, want)
    fixed = tmm.prenorm_fixed_order(a, nw).float()
    base = tmm.prenorm_plain(a, nw).float()
    assert ((fixed - base).abs() <= 2 ** -7 * base.abs()).all()


def test_prologue_order_ignores_rows_and_split():
    """The multiplier of a row is the same bits whatever rows come with it
    (M = 1 .. 16), and the kernel's split of K cannot move it: segments of
    32 K are summed in an order set by K alone."""
    rng = np.random.default_rng(5)
    a = torch.from_numpy(rng.normal(0, 3, (16, 2304)).astype(np.float32))
    full = tmm.norm_multiplier(a, 2304)
    for m in (1, 4, 13):
        assert torch.equal(tmm.norm_multiplier(a[:m], 2304), full[:m])
    for chunk in tmm.CHUNK.values():
        assert chunk % tmm.NORM_SEG == 0  # split boundaries fall on segments


@pytest.mark.parametrize("m", [1, 4, 13, 16])
@pytest.mark.parametrize("kind", KINDS)
def test_prologue_through_the_gemm_matches_jax(kind, m):
    """K1 with the folded prologue: the fixed-order bf16 A through the
    product against JAX's matmul(prologue_norm=); a flipped bf16 ulp of A
    moves an output by ~1e-6 relative: 1e-5 of max|out|."""
    rng = np.random.default_rng(300 + 10 * KINDS.index(kind) + m)
    jq, tq = _weights(rng, kind, n=264, k=K)
    a = rng.normal(0, 3, (m, K)).astype(np.float32)
    nw = rng.normal(0, 0.1, (K,)).astype(np.float32)
    want = jmm.matmul(jnp.asarray(a), jq, prologue_norm=jnp.asarray(nw),
                      interpret=True)
    got = tmm._product_plain(tmm.prenorm_fixed_order(
        torch.from_numpy(a), torch.from_numpy(nw)), tq)
    assert rel_err(got, np.asarray(want, np.float32)) <= 1e-5


# --- (c) K3's plan and merge -----------------------------------------------

N_HEAD, K_HEAD, CAP = 1000, 384, 30.0
TOP1_BLOCKS_JAX = (8, 256, K_HEAD)


def _head(rng, kind="i8"):
    if kind == "i8":
        from tests.test_torch_matmul import i8_arrays, jax_qt, torch_qt
        w = i8_arrays(rng, N_HEAD, K_HEAD)
        w["inv_scales"] *= np.float32(4.0)  # logits of std ~4
        return jax_qt(w), torch_qt(w)
    dense = rng.normal(0, 0.2, (N_HEAD, K_HEAD)).astype(np.float32)
    return (jmm.QuantTensor("f32", (N_HEAD, K_HEAD), 1.0,
                            {"w": jnp.asarray(dense)}),
            tmm.QuantTensor("f32", (N_HEAD, K_HEAD), 1.0,
                            {"w": torch.from_numpy(dense.copy())}))


@pytest.mark.parametrize("m", [1, 4, 13, 20])
@pytest.mark.parametrize("case", ["prob", "no_prob", "mask", "banned",
                                  "saturated"])
def test_top1_emulation_matches_jax(case, m):
    """The emulated head, over 1 and 3 blocks (16 and 48 warps on 63 row
    groups: warps with two groups, one and none), against JAX's fused head.
    saturated: four columns whose logits pass 25 x the cap on every row,
    where tanh is 1.0 in any implementation: the lowest of them wins, and
    each adds exp(0) to the sum."""
    rng = np.random.default_rng(400 + 7 * m + len(case))
    wj, wt = _head(rng, "f32" if case == "saturated" else "i8")
    need_prob = case != "no_prob"
    mask = None
    a = rng.normal(0, 3, (m, K_HEAD)).astype(np.float32)
    nw = rng.normal(0, 0.1, (K_HEAD,)).astype(np.float32)
    if case == "mask":
        mask = np.zeros(N_HEAD, bool)
        mask[3::7] = True
    if case == "banned":
        mask = np.zeros(N_HEAD, bool)
    if case == "saturated":
        a = rng.normal(2.0, 1.0, (m, K_HEAD)).astype(np.float32)
        w = np.asarray(wj.arrays["w"]).copy()
        w[[700, 123, 5, 999]] = 1.0
        wj = jmm.QuantTensor("f32", wj.shape, 1.0, {"w": jnp.asarray(w)})
        wt = tmm.QuantTensor("f32", wt.shape, 1.0,
                             {"w": torch.from_numpy(w)})
        nw = np.zeros_like(nw)
    aj, at = jnp.asarray(a), torch.from_numpy(a)
    want = [np.asarray(x) for x in jmm.matmul_top1(
        aj, wj, final_cap=CAP, prologue_norm=jnp.asarray(nw),
        allowed_mask=None if mask is None else jnp.asarray(mask),
        blocks=TOP1_BLOCKS_JAX, interpret=True, need_prob=need_prob)]
    logits = tmm.matmul_plain(at, wt, prologue_norm=torch.from_numpy(nw))
    if need_prob:
        logits = CAP * torch.tanh(logits / CAP)
    logits = logits.numpy()
    if mask is not None:
        logits = np.where(mask[None], logits, -np.inf)
    for blocks in (1, 3):
        tok, prob = tmm.matmul_top1_emulated(
            at, wt, final_cap=CAP, blocks=blocks,
            prologue_norm=torch.from_numpy(nw),
            allowed_mask=None if mask is None else torch.from_numpy(mask),
            need_prob=need_prob)
        tok, prob = tok.numpy(), prob.numpy()
        assert tok.dtype == np.int32 and prob.dtype == np.float32
        if case == "banned":
            np.testing.assert_array_equal(tok, np.zeros(m, np.int32))
            np.testing.assert_array_equal(want[0], tok)
            np.testing.assert_allclose(prob, want[1], rtol=1e-6)
            continue
        if case == "saturated":
            np.testing.assert_array_equal(tok, np.full(m, 5, np.int32))
            np.testing.assert_array_equal(want[0], tok)
            assert (prob <= 0.25 + 1e-6).all()
        finite = logits[np.isfinite(logits)]
        top2 = np.sort(logits, axis=-1)[:, -2:]
        clear = (top2[:, 1] - top2[:, 0]) > 1e-4 * np.abs(finite).max()
        if case != "saturated":
            assert clear.sum() >= max(1, m - 1)
        np.testing.assert_array_equal(tok[clear], want[0][clear])
        if mask is not None:
            assert mask[tok].all()
        if need_prob:
            np.testing.assert_allclose(prob, want[1], rtol=1e-5)
        else:
            np.testing.assert_array_equal(prob, np.ones(m, np.float32))


# --- (d) the plan covers N once ------------------------------------------

@pytest.mark.parametrize("n,blocks", [(8, 1), (1000, 1), (1000, 3),
                                      (1000, 528), (4104, 7),
                                      (256000, 396), (256000, 528),
                                      (256128, 396)])
def test_top1_plan_covers_every_column_once(n, blocks):
    """Every vocabulary row lies in exactly one warp's groups (rows past N
    in none), and a warp's groups, so its lanes' columns, come in
    increasing order."""
    plan = tmm.top1_plan(n, blocks)
    assert len(plan) == 8 * blocks
    cols = np.concatenate([np.arange(16 * r, min(16 * r + 16, n))
                           for groups in plan for r in groups] or [[]])
    assert len(cols) == n
    np.testing.assert_array_equal(np.sort(cols), np.arange(n))
    assert all(groups == sorted(groups) for groups in plan)


# --- the wrappers and the sources ----------------------------------------

def _source(name):
    return (_cuda.CSRC / name).read_text()


def test_constants_match_the_sources():
    """The emulations' constants are the kernels': the segment of the
    prologue's sums, 8 warps a block, and K3's 16 vocabulary rows a warp."""
    common = _source("gemm_common.cuh")
    assert f"constexpr int kNormSeg = {tmm.NORM_SEG};" in common
    assert "constexpr int kDecodeThreads = 256;" in common
    head = _source("matmul.cu")
    body = head[head.index("void top1_body("):]
    assert "const int groups = (N + 15) / 16" in body
    assert "r.n0 = 16 * (gw + j / chunks * W) + g;" in body
    decode = _source("matmul_decode.cu")
    assert "blockIdx.x * gridDim.y + blockIdx.y" in decode


def test_fused_entries_take_no_scratch_pass(faked):
    """A decode K1 with the prologue and the post-norm is one entry call
    with the f32 A, the norms, the epilogue's y (out itself for f32 out),
    slots for panels x splits x M partials and the device's ticket; K2
    with the prologue gets the f32 A and its norm, and no scratch."""
    rng = np.random.default_rng(9)
    _, w = _weights(rng, "i8", n=264, k=K)
    m = 4
    x = torch.from_numpy(rng.normal(0, 3, (m, K)).astype(np.float32))
    nw = torch.from_numpy(rng.normal(0, 0.1, (K,)).astype(np.float32))
    pw = torch.from_numpy(rng.normal(0, 0.1, (264,)).astype(np.float32))
    add = torch.from_numpy(rng.normal(0, 1, (m, 264)).astype(np.float32))
    out = tmm._matmul_cuda(x, w, torch.float32, add, nw, pw, None)
    tmm._gated_cuda(x, w, w, torch.bfloat16, nw, None)
    (k1, args1), (k2, args2) = faked
    assert (k1, k2) == ("matmul_i8", "gated_i8")
    nb = len(tmm._b_args("i8"))
    kw, splits = tmm.decode_split(264, K, "i8", False)
    assert args1[0] == x.data_ptr() and args1[1] == nw.data_ptr()
    post_w, add_p, y, slots, ticket, out_p = args1[2 + nb + 2:2 + nb + 8]
    assert (post_w, add_p, y, out_p) == (pw.data_ptr(), add.data_ptr(),
                                         out.data_ptr(), out.data_ptr())
    ticket_t, slots_t = tmm._scratch[x.device]
    assert (ticket, slots) == (ticket_t.data_ptr(), slots_t.data_ptr())
    assert slots_t.numel() >= len(tmm.decode_blocks(264, kw, splits)) * m
    assert len(args2) == len(tmm.GATED["i8"].argtypes)
    assert args2[0] == x.data_ptr() and args2[1] == nw.data_ptr()


def test_top1_wrapper_passes_no_scratch(monkeypatch):
    """K3's entry gets the f32 A and the final norm itself (no bf16
    scratch, no pass), the device's ticket and the part_* capacity
    TOP1_BLOCKS."""
    calls = []

    def check(t, name, dtype, shape=None):
        assert t.dtype == dtype and t.is_contiguous(), name

    monkeypatch.setattr(_cuda, "check", check)
    monkeypatch.setattr(_cuda, "_stream", lambda: 0)
    kernel = tmm.TOP1["i8"]

    def fn(*args):
        *args, launched, _stream = args
        assert len(args) == len(kernel.argtypes)
        calls.append(args)
        launched._obj.value = 1
        return 0

    monkeypatch.setattr(kernel, "_fn", fn)
    rng = np.random.default_rng(10)
    _, w = _weights(rng, "i8", n=264, k=K)
    x = torch.from_numpy(rng.normal(0, 3, (4, K)).astype(np.float32))
    nw = torch.from_numpy(rng.normal(0, 0.1, (K,)).astype(np.float32))
    tmm._top1_cuda(x, w, CAP, nw, None, True)
    (args,) = calls
    assert args[0] == x.data_ptr() and args[1] == nw.data_ptr()
    assert args[-4:] == [4, 264, K, tmm.TOP1_BLOCKS]
    ticket = args[-7]
    assert ticket == tmm._scratch[x.device][0].data_ptr()


def test_decode_entries_launch_one_kernel():
    """matmul_decode.cu's entries put one kernel on the stream and report
    it alone: no norm pass is chained around the decode tile."""
    src = _source("matmul_decode.cu")
    for entry in ("static int matmul_entry(", "static int gated_entry("):
        body = src[src.index(entry):]
        body = body[:body.index("\n}\n")]
        assert "operand_a(" not in body and "<<<" not in body
        assert re.findall(r"\*launched = (\w+);", body) == ["0",
                                                            "kLaunchedSelf"]
