"""The port's one-byte and dense weight codecs (kinds sfp, nuq, bf16, f32
in gemma_tpu_torch/ops/matmul.py, plain path on CPU) vs the JAX package's
on the same numpy-made weights: the SFP byte decoder bit for bit,
`matmul` / `gated_ffn` / `matmul_top1` against the Pallas kernels in
interpret mode, `embed_tokens`, `dequantize`, `concat_rows`, the bridge
and the synth.

Tolerances: both packages turn the B tile into the same bf16 values and
form the same exact products; f32 sums run in another order (and, under
the prologue, the bf16-rounded A may flip one ulp), so outputs agree to
1e-5 of max|out| (bf16 outputs: one bf16 ulp, 2^-8), as
tests/test_torch_matmul.py bounds the i8 kernels."""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from gemma_tpu.compression import sfp as jsfp
from gemma_tpu.models.gemma import embed_tokens as j_embed
from gemma_tpu.ops import matmul as jmm
from gemma_tpu_torch.models import bridge
from gemma_tpu_torch.models.gemma import embed_tokens as t_embed
from gemma_tpu_torch.ops import matmul as tmm
from gemma_tpu_torch.utils import synth
from tests.test_torch_matmul import flatten_qt, rel_err

torch.set_num_threads(1)

KINDS = ["sfp", "nuq", "bf16", "f32"]
M, K, N = 5, 384, 256
SCALE = 0.37  # every case runs the kernels' scale != 1 path


def weights(rng, kind, n=N, k=K, scale=SCALE, spread=None):
    """(JAX QuantTensor, port QuantTensor via the bridge) of one kind.
    SFP bytes are drawn so the values have std ~1/sqrt(k)-ish after
    `scale`; dense weights N(0, spread or 1/sqrt(k))."""
    if kind in ("sfp", "nuq"):
        arrays = {"codes": rng.integers(0, 256, (n, k), dtype=np.uint8)}
    else:
        w = rng.normal(0, spread or 1 / np.sqrt(k), (n, k)).astype(np.float32)
        if kind == "bf16":
            w = w.astype(ml_dtypes.bfloat16)
        arrays = {"w": w}
    jq = jmm.QuantTensor(kind, (n, k), scale,
                         {key: jnp.asarray(v) for key, v in arrays.items()})
    return jq, bridge.quant_tensor_from_numpy(flatten_qt(jq), "cpu")


def test_sfp_decode_all_bytes_bit_exact():
    """All 256 bytes, as bf16 bit patterns: 0x00 is +0, 0x80 is -0."""
    codes = np.arange(256, dtype=np.uint8)
    want = np.asarray(jsfp.decode_jax(jnp.asarray(codes), jnp.float32))
    got = tmm.sfp_decode(torch.from_numpy(codes))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  want.view(np.uint32))
    np.testing.assert_array_equal(
        got.numpy().view(np.uint32) >> 16,
        jsfp.decode_bits(codes).astype(np.uint32))
    assert got[0x00].item() == 0.0 and not np.signbit(got[0x00].item())
    assert got[0x80].item() == 0.0 and np.signbit(got[0x80].item())
    bf = tmm.sfp_decode(torch.from_numpy(codes), torch.bfloat16)
    np.testing.assert_array_equal(bf.float().numpy(), want)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("variant", ["plain", "prologue", "epilogue_add",
                                     "bf16_out"])
def test_matmul_codec_matches_jax(kind, variant):
    rng = np.random.default_rng(100 + KINDS.index(kind) * 10 + len(variant))
    jq, tq = weights(rng, kind)
    kw_j, kw_t = {}, {}
    if variant == "prologue":
        a = rng.normal(0, 3, (M, K)).astype(np.float32)
        nw = rng.normal(0, 0.1, (K,)).astype(np.float32)
        kw_j["prologue_norm"] = jnp.asarray(nw)
        kw_t["prologue_norm"] = torch.from_numpy(nw)
        a_j, a_t = jnp.asarray(a), torch.from_numpy(a)
    else:
        a_j = jnp.asarray(rng.normal(0, 1, (M, K)).astype(np.float32)).astype(
            jnp.bfloat16)
        a_t = torch.from_numpy(np.asarray(a_j, np.float32)).to(torch.bfloat16)
    if variant == "epilogue_add":
        pw = rng.normal(0, 0.1, (N,)).astype(np.float32)
        add = rng.normal(0, 1, (M, N)).astype(np.float32)
        kw_j.update(epilogue_norm=jnp.asarray(pw), add=jnp.asarray(add))
        kw_t.update(epilogue_norm=torch.from_numpy(pw),
                    add=torch.from_numpy(add))
    out_j = jnp.bfloat16 if variant == "bf16_out" else jnp.float32
    out_t = torch.bfloat16 if variant == "bf16_out" else torch.float32
    want = jmm.matmul(a_j, jq, out_dtype=out_j, interpret=True, **kw_j)
    got = tmm.matmul(a_t, tq, out_dtype=out_t, **kw_t)
    tol = 2 ** -8 if variant == "bf16_out" else 1e-5
    assert rel_err(got.float(), np.asarray(want, np.float32)) <= tol


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("prologue", [False, True])
def test_gated_ffn_codec_matches_jax(kind, prologue):
    rng = np.random.default_rng(200 + KINDS.index(kind) * 2 + prologue)
    j1, t1 = weights(rng, kind)
    j2, t2 = weights(rng, kind, scale=0.81)
    if prologue:
        x = rng.normal(0, 3, (M, K)).astype(np.float32)
        nw = rng.normal(0, 0.1, (K,)).astype(np.float32)
        want = jmm.gated_ffn(jnp.asarray(x), j1, j2, out_dtype=jnp.bfloat16,
                             prologue_norm=jnp.asarray(nw), interpret=True)
        got = tmm.gated_ffn(torch.from_numpy(x), t1, t2,
                            prologue_norm=torch.from_numpy(nw))
    else:
        x = jnp.asarray(rng.normal(0, 1, (M, K)).astype(np.float32)).astype(
            jnp.bfloat16)
        want = jmm.gated_ffn(x, j1, j2, out_dtype=jnp.bfloat16,
                             interpret=True)
        got = tmm.gated_ffn(
            torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16),
            t1, t2)
    assert got.dtype == torch.bfloat16
    assert rel_err(got.float(), np.asarray(want, np.float32)) <= 2 ** -8


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("need_prob", [True, False])
def test_matmul_top1_codec_matches_jax(kind, need_prob):
    """K3's function per kind, with the final-norm prologue and a mask:
    tokens equal where the capped top1-top2 margin exceeds 1e-4 of
    max|logit|, probs to rtol 1e-5 (tests/test_torch_top1.py's bounds)."""
    rng = np.random.default_rng(300 + KINDS.index(kind) * 2 + need_prob)
    n = 1000  # pads to 1024 in JAX's 256-column blocks
    # Logits of std ~4: below the cap's saturation, above ties.
    jq, tq = weights(rng, kind, n=n, scale=4.0 * (
        1 / (np.sqrt(K) * synth.sfp_rms()) if kind in ("sfp", "nuq")
        else 1.0))
    a = rng.normal(0, 3, (M, K)).astype(np.float32)
    nw = rng.normal(0, 0.1, (K,)).astype(np.float32)
    mask = np.ones(n, bool)
    mask[::3] = False
    wt, wp = jmm.matmul_top1(
        jnp.asarray(a), jq, final_cap=30.0, prologue_norm=jnp.asarray(nw),
        allowed_mask=jnp.asarray(mask), blocks=(8, 256, K), interpret=True,
        need_prob=need_prob)
    gt, gp = tmm.matmul_top1(
        torch.from_numpy(a), tq, final_cap=30.0,
        prologue_norm=torch.from_numpy(nw),
        allowed_mask=torch.from_numpy(mask), need_prob=need_prob)
    logits = tmm.matmul_plain(torch.from_numpy(a), tq,
                              prologue_norm=torch.from_numpy(nw))
    if need_prob:
        logits = 30.0 * torch.tanh(logits / 30.0)
    logits = np.where(mask[None], logits.numpy(), -np.inf)
    top2 = np.sort(logits, axis=-1)[:, -2:]
    scale = np.abs(logits[np.isfinite(logits)]).max()
    clear = (top2[:, 1] - top2[:, 0]) > 1e-4 * scale
    assert clear.sum() >= M - 1 and 2.0 < scale < 29.0
    np.testing.assert_array_equal(gt.numpy()[clear], np.asarray(wt)[clear])
    assert mask[gt.numpy()].all()
    if need_prob:
        np.testing.assert_allclose(gp.numpy(), np.asarray(wp), rtol=1e-5)
    else:
        np.testing.assert_array_equal(gp.numpy(), np.ones(M, np.float32))


@pytest.mark.parametrize("kind", KINDS)
def test_embed_tokens_codec_matches_jax(kind):
    """Rows * bf16(sqrt(dim)) * scale: the same f32 arithmetic, exact."""
    rng = np.random.default_rng(400 + KINDS.index(kind))
    jq, tq = weights(rng, kind, n=64, k=K)
    tokens = rng.integers(0, 64, (3, 7)).astype(np.int32)
    want = np.asarray(j_embed(jq, jnp.asarray(tokens), K))
    got = t_embed(tq, torch.from_numpy(tokens), K)
    assert got.dtype == torch.float32 and got.shape == (3, 7, K)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("kind", KINDS)
def test_dequantize_and_bridge_round_trip(kind):
    """The bridge carries codes / dense weights and the scale across bit
    for bit; dequantize equals JAX's exactly."""
    rng = np.random.default_rng(500 + KINDS.index(kind))
    jq, tq = weights(rng, kind)
    assert tq.kind == kind and tq.shape == (N, K) and tq.scale == SCALE
    for key, arr in jq.arrays.items():
        mine = tq.arrays[key]
        assert mine.dtype == {"uint8": torch.uint8, "bfloat16": torch.bfloat16,
                              "float32": torch.float32}[str(arr.dtype)]
        np.testing.assert_array_equal(mine.float().numpy(),
                                      np.asarray(arr, np.float32))
    np.testing.assert_array_equal(tq.dequantize().numpy(),
                                  np.asarray(jq.dequantize()))
    assert tq.nbytes() == jq.nbytes()


@pytest.mark.parametrize("kind", KINDS)
def test_concat_rows_codec(kind):
    rng = np.random.default_rng(600 + KINDS.index(kind))
    _, t1 = weights(rng, kind, n=128)
    _, t2 = weights(rng, kind, n=64)
    a = torch.randn(M, K, generator=torch.Generator().manual_seed(0)).to(
        torch.bfloat16)
    cat = tmm.concat_rows(t1, t2)
    assert cat.kind == kind and cat.shape == (192, K) and cat.scale == SCALE
    want = torch.cat([tmm.matmul(a, t1), tmm.matmul(a, t2)], dim=1)
    torch.testing.assert_close(tmm.matmul(a, cat), want, rtol=0, atol=0)
    _, other = weights(rng, kind, n=64, scale=0.5)
    assert tmm.concat_rows(t1, other) is None  # scales differ


@pytest.mark.parametrize("kind", ["i8"] + KINDS)
def test_synth_quant_layout_and_rms(kind):
    """The synth's arrays have the JAX synth's names, shapes and dtypes,
    and the weights' rms is 1/sqrt(K) (within sampling noise)."""
    from gemma_tpu.utils.synth import synth_quant as j_synth

    n, k = 64, 512
    mine = synth.synth_quant(torch.Generator().manual_seed(1), n, k, "cpu",
                             kind)
    ref = j_synth(np.random.default_rng(1), n, k, kind)
    assert set(mine.arrays) == set(ref.arrays)
    for key, arr in ref.arrays.items():
        assert tuple(mine.arrays[key].shape) == arr.shape
        assert str(mine.arrays[key].dtype).split(".")[1] == str(arr.dtype)
    rms = float(mine.dequantize().square().mean().sqrt())
    assert abs(rms * np.sqrt(k) - 1.0) < 0.1
    if kind in ("sfp", "nuq"):
        assert mine.scale != 1.0  # the scale carries the size


@pytest.mark.parametrize("kind", ["i4", "nuq4"])
def test_later_kinds_raise(kind):
    """The 4.5-bit codecs are ported (tests/test_torch_codecs4.py): no
    entry raises for them any more; a kind nobody knows still does, as a
    ValueError that lists the kinds."""
    from gemma_tpu.utils.synth import synth_quant as j_synth

    jq = j_synth(np.random.default_rng(0), 16, 256, kind)
    tq = bridge.quant_tensor_from_numpy(flatten_qt(jq), "cpu")
    assert tq.kind == kind and kind in tmm.KINDS
    synth.synth_quant(torch.Generator(), 16, 256, "cpu", kind)
    a = torch.zeros(2, 256, dtype=torch.bfloat16)
    for call in (lambda: tmm.matmul(a, tq), lambda: tq.dequantize(),
                 lambda: tmm.matmul_topk(a, tq, 4),
                 lambda: tmm.matmul_top1(a, tq, final_cap=0.0),
                 lambda: tmm.gated_ffn(a, tq, tq),
                 lambda: t_embed(tq, torch.zeros(1, 1, dtype=torch.long),
                                 256)):
        call()
    unknown = tmm.QuantTensor(kind + "x", (16, 256), 1.0, {})
    for call in (lambda: tmm.matmul(a, unknown), lambda: unknown.dequantize(),
                 lambda: synth.synth_quant(torch.Generator(), 16, 256, "cpu",
                                           kind + "x")):
        with pytest.raises(ValueError, match="one of"):
            call()
    with pytest.raises(ValueError, match="one of"):
        bridge.quant_tensor_from_numpy(
            dict(flatten_qt(jq), kind=kind + "x"), "cpu")
