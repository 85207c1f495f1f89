"""The decode GEMMs (K1 and K2 at M <= 16 rows, plain and stacked: K12) of
gemma_tpu_torch.

On the CPU the port's `matmul` / `gated_ffn` take their plain versions;
they are held against the JAX package's `matmul` / `gated_ffn` (Pallas
kernels in interpret mode) at decode row counts for every weight kind,
plain and on a stacked layer.  The CUDA entries of matmul_decode.cu are
checked with faked kernels, as tests/test_torch_prefill_gemm.py fakes
them: M <= 16 rows reach them with the split of K that `decode_split`
chooses from the shapes alone.  `decode_split` and `split_chunks` are
checked as pure functions, and the nuq4 table planes of gemm_common.cuh
(`nuq4_planes`, `nuq4_plane_frag`) are emulated in numpy, byte permute
for byte permute, over every SFP byte and every code."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gemma_tpu.ops import matmul as jmm
from gemma_tpu_torch.ops import _cuda
from gemma_tpu_torch.ops import matmul as tmm
from tests.test_torch_prefill_gemm import KINDS, _a, _weights
from tests.test_torch_scan_decode import jax_weight, port_weight, rel_err

torch.set_num_threads(1)

ROWS = [1, 4, 13, 16]
N, K = 256, 512
L = 3  # layers of a stacked weight


# --- the port's plain versions against JAX, at decode rows -------------------

@pytest.mark.parametrize("m", ROWS)
@pytest.mark.parametrize("kind", KINDS)
def test_matmul_decode_rows_match_jax(kind, m):
    """K1 at decode row counts, bf16 A, f32 out: the same exact bf16
    products on both sides (raw codes for i8 and i4, whose group affines
    land on the output), summed in another f32 order: 1e-5 of max|out|."""
    rng = np.random.default_rng(900 + 10 * KINDS.index(kind) + m)
    jq, tq = _weights(rng, kind)
    a_j, a_t = _a(rng, m)
    want = jmm.matmul(a_j, jq, out_dtype=jnp.float32, interpret=True)
    got = tmm.matmul(a_t, tq)
    assert got.shape == (m, N) and got.dtype == torch.float32
    assert rel_err(got, np.asarray(want, np.float32)) <= 1e-5


@pytest.mark.parametrize("m", ROWS)
@pytest.mark.parametrize("kind", KINDS)
def test_gated_ffn_decode_rows_match_jax(kind, m):
    """K2 at decode row counts: bf16 gelu_tanh(A.W1^T) * (A.W2^T); one bf16
    ulp of the output (2^-8 of max|out|) on top of the reordered f32
    sums."""
    rng = np.random.default_rng(1000 + 10 * KINDS.index(kind) + m)
    j1, t1 = _weights(rng, kind)
    j2, t2 = _weights(rng, kind, scale=0.81)
    a_j, a_t = _a(rng, m)
    want = jmm.gated_ffn(a_j, j1, j2, out_dtype=jnp.bfloat16, interpret=True)
    got = tmm.gated_ffn(a_t, t1, t2)
    assert got.shape == (m, N) and got.dtype == torch.bfloat16
    assert rel_err(got.float(), np.asarray(want, np.float32)) <= 2 ** -8


def _stacked(kind, seed):
    """(JAX, port) stacks of L weights [N, K] of one kind with one tensor
    scale (bf16 / f32: a scale to fold)."""
    rng = np.random.default_rng(seed)
    scale = {"bf16": 1.25, "f32": 0.75, "sfp": 0.04, "nuq": 0.04,
             "nuq4": 0.04}.get(kind, 1.0)
    jqs = [jax_weight(rng, kind, scale, n=N, k=K) for _ in range(L)]
    return (jmm.stack_quant_tensors(jqs),
            tmm.stack_quant_tensors([port_weight(q) for q in jqs]))


@pytest.mark.parametrize("m", ROWS)
@pytest.mark.parametrize("kind", KINDS)
def test_stacked_decode_rows_match_jax(kind, m):
    """K12 at decode row counts: matmul(layer=1) on bf16 A with the
    post-norm and the residual add (1e-5 of max|out|, f32 out), and
    gated_ffn(layer=2) (2^-8, bf16 out), against JAX's layer= calls in
    interpret mode.  Both take the same bf16 A: the prologue norm's
    rounding to bf16 may differ by an ulp between the packages
    (tests/test_torch_scan_decode.py holds it)."""
    rng = np.random.default_rng(1100 + 10 * KINDS.index(kind) + m)
    js, ts = _stacked(kind, 40 + m)
    a_j, a_t = _a(rng, m)
    pw = rng.normal(0, 0.1, (N,)).astype(np.float32)
    add = rng.normal(0, 1, (m, N)).astype(np.float32)
    want = jmm.matmul(a_j, js, layer=jnp.int32(1),
                      epilogue_norm=jnp.asarray(pw), add=jnp.asarray(add),
                      interpret=True)
    got = tmm.matmul(a_t, ts, layer=1, epilogue_norm=torch.from_numpy(pw),
                     add=torch.from_numpy(add))
    assert got.shape == (m, N)
    assert rel_err(got, np.asarray(want)) <= 1e-5
    js2, ts2 = _stacked(kind, 60 + m)
    want = jmm.gated_ffn(a_j, js, js2, out_dtype=jnp.bfloat16,
                         layer=jnp.int32(2), interpret=True)
    got = tmm.gated_ffn(a_t, ts, ts2, layer=2)
    assert rel_err(got.float(), np.asarray(want, np.float32)) <= 2 ** -8


# --- the CUDA entries, faked ----------------------------------------------------

@pytest.fixture
def faked(monkeypatch):
    """Every decode K1 / K2 entry faked: each records (name, its int
    arguments after the B operands and the layer pointer, M) and reports
    its own launch.  CPU tensors pass the wrappers' checks (dtype and
    shape; the device is not checked)."""
    calls = []

    def check(t, name, dtype, shape=None):
        assert t.dtype == dtype and t.is_contiguous(), name
        assert shape is None or tuple(t.shape) == tuple(shape), name

    monkeypatch.setattr(_cuda, "check", check)
    monkeypatch.setattr(_cuda, "_stream", lambda: 0)
    for table in (tmm.MATMUL, tmm.GATED, tmm.MATMUL_STACKED,
                  tmm.GATED_STACKED, tmm.MATMUL_SM90, tmm.GATED_SM90):
        for kernel in table.values():
            def fn(*args, kernel=kernel):
                *args, launched, _stream = args
                assert len(args) == len(kernel.argtypes)
                calls.append((kernel.name, args))
                launched._obj.value = 1
                return 0

            monkeypatch.setattr(kernel, "_fn", fn)
    return calls


@pytest.mark.parametrize("m", ROWS)
@pytest.mark.parametrize("stacked", [False, True])
@pytest.mark.parametrize("kind", KINDS)
def test_decode_rows_reach_the_new_entries(faked, kind, stacked, m):
    """M <= 16 rows reach matmul_decode.cu's entries (stacked: K12's, with
    the layer pointer), every kind, K1 and K2, with the split of K that
    decode_split chooses for the weights' shape, whatever M is."""
    codec = "sfp" if kind == "nuq" else kind
    rng = np.random.default_rng(7)
    ws = [_weights(rng, kind, 16, 512)[1] for _ in range(L if stacked else 1)]
    w = tmm.stack_quant_tensors(ws) if stacked else ws[0]
    layer = 1 if stacked else None
    a = torch.zeros(m, 512, dtype=torch.bfloat16)
    tmm._matmul_cuda(a, w, torch.float32, None, None, None, layer)
    tmm._gated_cuda(a, w, w, torch.bfloat16, None, layer)
    nb = len(tmm._b_args(codec))  # the B operand's C arguments
    split = 2 + nb + (1 if stacked else 0)  # a, norm, B..., [layer]
    want_k1 = tmm.decode_split(16, 512, codec, False)
    want_k2 = tmm.decode_split(16, 512, codec, True)
    (k1, args1), (k2, args2) = faked
    assert k1 == (f"matmul_stacked_{codec}" if stacked else f"matmul_{codec}")
    assert k2 == (f"gated_stacked_{codec}" if stacked else f"gated_{codec}")
    assert tuple(args1[split:split + 2]) == want_k1
    assert tuple(args2[split + nb:split + nb + 2]) == want_k2
    if stacked:  # the layer index read from a device arange, layer 1
        ptr = args1[2 + nb]
        ids = tmm._layer_ids[(a.device, L)]
        assert ptr == ids.data_ptr() + 4 * layer
    assert args1[-4] == m and args2[-3] == m


# --- the split of K -----------------------------------------------------------

# (n, k) of Gemma2-2B, -9B and -27B's decode GEMMs (qkv, att_w, linear, the
# gated FFN's N x K), and small shapes.
SHAPES = [(4096, 2304), (2304, 2048), (2304, 9216), (9216, 2304),
          (8192, 3584), (3584, 4096), (3584, 14336), (14336, 3584),
          (8192, 4608), (4608, 4096), (4608, 36864), (36864, 4608),
          (256, 256), (16, 512)]


@pytest.mark.parametrize("gated", [False, True])
@pytest.mark.parametrize("n,k", SHAPES)
def test_decode_split(n, k, gated):
    """Warps a row group and blocks a cluster: kw in 1, 2, 4, 8 and splits
    a power of two within the cluster limit and the chunks; a block's
    slice of K within DECODE_SLICE unless the cluster limit forbids; a
    wave no larger than DECODE_WAVE unless one warp a row group already
    passes it; 8 warps a row group, or a wave that two more would pass."""
    for codec, chunk in tmm.CHUNK.items():
        if k % chunk:
            continue
        kw, splits = tmm.decode_split(n, k, codec, gated)
        chunks = k // chunk
        assert kw in (1, 2, 4, 8)
        assert splits & (splits - 1) == 0
        assert 1 <= splits <= min(tmm.DECODE_MAX_SPLITS, chunks)
        slice_k = -(-chunks // splits) * chunk
        assert slice_k <= tmm.DECODE_SLICE or splits == \
            tmm.DECODE_MAX_SPLITS or 2 * splits > chunks
        cols = tmm.DECODE_WARP_COLS[gated] * (8 // kw)
        blocks = -(-n // cols) * splits
        assert blocks <= tmm.DECODE_WAVE or kw == 1
        if kw < 8:
            wider = -(-n // (cols // 2)) * splits
            assert wider > tmm.DECODE_WAVE


@pytest.mark.parametrize("chunks", [1, 2, 9, 18, 36, 144])
def test_split_chunks_cover_every_chunk_once(chunks):
    """The blocks of a cluster take whole chunks, each exactly once, in
    order; so do the warps of a row group within a block's slice."""
    for splits in (1, 2, 4, 8):
        if splits > chunks:
            continue
        parts = tmm.split_chunks(chunks, splits)
        assert [c for lo, hi in parts for c in range(lo, hi)] == \
            list(range(chunks))
        assert all(hi > lo for lo, hi in parts)
        for lo, hi in parts:
            for kw in (1, 2, 4, 8):
                warps = [(lo + a, lo + b)
                         for a, b in tmm.split_chunks(hi - lo, kw)]
                assert [c for a, b in warps for c in range(a, b)] == \
                    list(range(lo, hi))


# --- the nuq4 table planes, emulated ----------------------------------------

def byte_perm(x, y, s):
    """__byte_perm(x, y, s) on uint32 arrays: byte i of the result is byte
    (nibble i of s) & 7 of the eight bytes y:x (x the low four)."""
    x, y, s = (np.asarray(v, np.uint64) for v in (x, y, s))
    src = x | (y << np.uint64(32))
    out = np.zeros(np.broadcast(x, y, s).shape, np.uint64)
    for i in range(4):
        sel = (s >> np.uint64(4 * i)) & np.uint64(7)
        out |= ((src >> (sel * np.uint64(8))) & np.uint64(0xff)) << \
            np.uint64(8 * i)
    return out.astype(np.uint32)


def lane_mask_bit7(x):
    """gemm_common.cuh:lane_mask_bit7, prmt.b32 x, 0, 0xaa88 in its sign
    mode: bytes 0, 1 replicate the sign of byte 0, bytes 2, 3 of byte 2."""
    x = np.asarray(x, np.uint32)
    b0 = np.where(x & np.uint32(0x80), np.uint32(0xffff), np.uint32(0))
    b2 = np.where(x & np.uint32(0x800000), np.uint32(0xffff0000),
                  np.uint32(0))
    return (b0 | b2).astype(np.uint32)


def sfp2_to_bf16x2(x):
    """gemm_common.cuh:sfp2_to_bf16x2 in uint32 arithmetic."""
    x = np.asarray(x, np.uint32)
    v = x & np.uint32(0x007f007f)
    big = lane_mask_bit7(v << np.uint32(1))
    nz = lane_mask_bit7(v + np.uint32(0x007f007f))
    lo = np.uint32(0x34003400) + (v << np.uint32(5))
    hi = np.uint32(0x38003800) + (v << np.uint32(4))
    return ((((lo & ~big) | (hi & big)) & nz)
            | ((x << np.uint32(8)) & np.uint32(0x80008000)))


def test_sfp2_to_bf16x2_every_byte_pair():
    """The SFP decoder of every GEMM tile, two bytes a word, against
    sfp_decode, over all 65536 pairs of bytes."""
    lo, hi = np.meshgrid(np.arange(256, dtype=np.uint32),
                         np.arange(256, dtype=np.uint32), indexing="ij")
    got = sfp2_to_bf16x2(lo.reshape(-1) | (hi.reshape(-1) << np.uint32(16)))
    bits = (tmm.sfp_decode(torch.arange(256).to(torch.uint8))
            .view(torch.int32).numpy().astype(np.uint32) >> 16)
    np.testing.assert_array_equal(got & np.uint32(0xffff),
                                  bits[lo.reshape(-1)])
    np.testing.assert_array_equal(got >> np.uint32(16), bits[hi.reshape(-1)])


def nuq4_planes(words):
    """gemm_common.cuh:nuq4_planes for the 4 lanes of a row: words[..., t]
    is lane t's word t of the 16 table bytes; the shuffles hand every lane
    all four.  Returns (lo, hi) planes [..., 4] (tbl.x .. tbl.w)."""
    w0 = sfp2_to_bf16x2(byte_perm(words, 0, 0x4140))
    w1 = sfp2_to_bf16x2(byte_perm(words, 0, 0x4342))
    return byte_perm(w0, w1, 0x6420), byte_perm(w0, w1, 0x7531)


def nuq4_lookup4(sel, tbl):
    """gemm_common.cuh:nuq4_lookup4, tbl [..., 4] words."""
    s7 = sel & np.uint32(0x7777)
    lo = byte_perm(tbl[..., 0], tbl[..., 1], s7)
    hi = byte_perm(tbl[..., 2], tbl[..., 3], s7)
    return byte_perm(lo, hi,
                     np.uint32(0x3210) | ((sel >> np.uint32(1))
                                          & np.uint32(0x4444)))


def nuq4_plane_frag(sel, lo, hi):
    l, h = nuq4_lookup4(sel, lo), nuq4_lookup4(sel, hi)
    return byte_perm(l, h, 0x6240), byte_perm(l, h, 0x7351)


def test_nuq4_planes_select_every_sfp_byte_and_code():
    """Every SFP byte b in every table entry c: four codes through the
    planes give the bf16 bits of sfp_decode of the entries they name, in
    the fragment order (j, j + 1 | 128 + j, 129 + j), exactly."""
    rng = np.random.default_rng(11)
    b, c = np.meshgrid(np.arange(256), np.arange(16), indexing="ij")
    b, c = b.reshape(-1), c.reshape(-1)  # 4096 (byte, code) pairs
    tables = rng.integers(0, 256, (b.size, 16)).astype(np.uint8)
    tables[np.arange(b.size), c] = b
    # Each position of the selector takes code c in turn; the others are
    # random codes.
    codes = rng.integers(0, 16, (b.size, 4)).astype(np.uint32)
    bits = (tmm.sfp_decode(torch.from_numpy(tables)).view(torch.int32)
            .numpy().astype(np.uint32) >> 16)  # bf16 bits of each entry
    words = tables.view("<u4")  # [pairs, 4]: word t of the table
    lo, hi = nuq4_planes(words)
    for pos in range(4):
        cc = codes.copy()
        cc[:, pos] = c
        # Nibbles of two packed bytes: elements j, 128 + j, j + 1, 129 + j.
        sel = cc[:, 0] | (cc[:, 1] << 4) | (cc[:, 2] << 8) | (cc[:, 3] << 12)
        f0, f1 = nuq4_plane_frag(sel, lo, hi)
        got = np.stack([f0 & 0xffff, f1 & 0xffff, f0 >> 16, f1 >> 16], -1)
        want = np.take_along_axis(bits, cc.astype(np.int64), axis=1)
        np.testing.assert_array_equal(got, want)
        # The byte b under test, at its position of the fragment.
        b_bits = tmm.sfp_decode(torch.from_numpy(b.astype(np.uint8))).view(
            torch.int32).numpy().astype(np.uint32) >> 16
        np.testing.assert_array_equal(got[:, pos], b_bits)
