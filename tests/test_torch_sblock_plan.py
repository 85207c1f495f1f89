"""The S-blocked decode attention (K11) of gemma_tpu_torch: its split of the
live positions over blocks and its per-run partials and merge, checked
without a card.

A CUDA kernel cannot run here, so ops/decode_attention.py carries a Python
mirror of the kernel's split (`sblock_split`, `sblock_row_split`) and a
plain-PyTorch emulation of its partials and merge
(`decode_attention_write_sblocked_emulated`).  These tests hold:
  - the mirror's constants against csrc/decode_attention.cu;
  - the runs against the decode mask: every live position exactly once,
    contiguous, in order, over random positions, rings, windows and
    wrapping ranges at Gemma2-2B's, -9B's and -27B's KV head counts;
  - the split and the partials' buffer per slot the same at batch 1 and 4;
  - the emulation against the JAX package's `_decode_fused_sblocked_kernel`
    (interpret mode, under GEMMA_SBLOCK_DECODE=1) and against the port's
    plain version, on the reduced shapes of
    tests/test_torch_split_decode.py with a ring of 255 (runs of 128: one
    or two runs a slot), windowed and wrapping ranges, RoPE and the QK
    norms in the kernel, and an invalid slot.

Tolerances: the emulation rounds its exp weights against each run's max,
the JAX kernel and the plain version against a running max over S blocks:
K11's bound in chip_smoke.py and the S-blocked test of
tests/test_torch_split_decode.py, 1e-2 of max|out| for bf16 and i8 pools;
f32 pools round nothing: 1e-4 of max|out|.  Written pools as that file's
K8 / K11 tests hold them."""

import re

import numpy as np
import pytest
import torch

from gemma_tpu_torch.ops import _cuda
from gemma_tpu_torch.ops import decode_attention as tda
from gemma_tpu_torch.ops.attention import attention_mask
from tests.test_torch_split_decode import (_assert_pools, _j_write_attend,
                                           _prefilled, _step_inputs)

torch.set_num_threads(1)


def _source():
    return (_cuda.CSRC / "decode_attention.cu").read_text()


def test_constants_match_the_source():
    """The mirror's constants are the kernel's, and the entry takes the
    split from the ring, the window and the head count alone."""
    src = _source()
    for name, value in (("SB_TARGET", tda.SBLOCK_TARGET),
                        ("SB_MIN_RUN", tda.SBLOCK_MIN_RUN),
                        ("SB_MAXR", tda.SBLOCK_MAX_RUN),
                        ("SB_MAX_RUNS", tda.SBLOCK_MAX_RUNS),
                        ("DC", tda.DECODE_CHUNK)):
        assert re.search(rf"constexpr int {name} = {value};", src), name
    assert "sb_split(ring, window, kvh, &a.nj, &a.run);" in src
    body = src[src.index("void decode_attention_body("):]
    assert "first = p_lo + rank * sa->run;" in body
    assert "nr = min(sa->run, n - rank * sa->run);" in body


@pytest.mark.parametrize("kv_heads,ring,window,want", [
    (4, 8192, 8192, (64, 128)),    # Gemma2-2B's global pool
    (4, 4608, 4096, (32, 128)),    # and its local one
    (8, 8192, 8192, (32, 256)),    # Gemma2-9B
    (8, 4608, 4096, (32, 128)),
    (16, 8192, 8192, (16, 512)),   # Gemma2-27B
    (16, 4608, 4096, (16, 256)),
    (4, 255, 255, (2, 128)),       # the tests' ring
    (4, 32, 16, (1, 128)),
])
def test_split_of_the_serving_pools(kv_heads, ring, window, want):
    """At batch 1 a full global ring of Gemma2-2B fills 256 blocks (two an
    SM on 132 SMs); runs are multiples of 32 rows, at least 128."""
    runs, run = tda.sblock_split(ring, window, kv_heads)
    assert (runs, run) == want
    assert run % tda.DECODE_CHUNK == 0 and run >= tda.SBLOCK_MIN_RUN
    assert runs * run >= min(ring, window) > (runs - 1) * run
    assert run <= tda.SBLOCK_MAX_RUN and runs <= tda.SBLOCK_MAX_RUNS


def _check_runs(pos, ring, window, kv_heads):
    runs = tda.sblock_row_split(pos, ring, window, kv_heads)
    n_runs, run = tda.sblock_split(ring, window, kv_heads)
    assert len(runs) == n_runs
    mask = attention_mask(torch.tensor([[pos]]), ring, window)[0, 0]
    want = sorted(int(s) for s in mask.nonzero()[:, 0])
    got = [p for r in runs for p in r]
    assert got == sorted(got) and len(got) == len(set(got))
    assert sorted(p % ring for p in got) == want
    for a, b in zip(runs, runs[1:]):
        assert a.stop == b.start
    assert all(len(r) <= run for r in runs)
    live = [r for r in runs if len(r)]
    assert live[-1][-1] == pos
    # Every run before the last live one is full; runs past it are empty.
    assert all(len(r) == run for r in live[:-1])
    assert all(not len(r) for r in runs[len(live):])
    return runs


@pytest.mark.parametrize("kv_heads", [4, 8, 16])
@pytest.mark.parametrize("pos,ring,window", [
    (300, 8192, 8192), (700, 4608, 4096), (0, 8192, 8192), (8000, 8192, 8192),
    (4700, 4608, 4096), (9000, 8192, 8192), (8191, 8192, 8192),
    (100, 32, 32), (40, 32, 16), (33, 40, 64), (300, 255, 255),
])
def test_runs_match_the_mask(pos, ring, window, kv_heads):
    """The runs cover exactly the positions whose ring rows the decode mask
    admits, each once, contiguous and in order, the newest position last;
    live runs but the last are full, runs past the frontier empty."""
    _check_runs(pos, ring, window, kv_heads)


@pytest.mark.parametrize("seed", range(30))
def test_runs_match_the_mask_random(seed):
    """Random positions (before and past a wrap), rings and windows."""
    rng = np.random.default_rng(seed)
    ring = int(rng.choice([32, 40, 64, 100, 255, 257, 1000, 4608, 8192]))
    window = int(rng.choice([1, 5, ring // 2 + 1, ring, 2 * ring]))
    pos = int(rng.integers(0, 3 * ring))
    _check_runs(pos, ring, window, int(rng.choice([4, 8, 16])))


@pytest.mark.parametrize("kv_heads,heads,d", [(4, 8, 256), (8, 16, 256),
                                              (16, 32, 128)])
def test_split_is_the_same_at_every_batch(kv_heads, heads, d):
    """The partials' buffer holds the same runs per slot at batch 1 and
    batch 4 (the split takes no batch): the kernel reads a slot's partials
    at the same offsets within its (slot, KV head) whatever the batch."""
    one, t1 = tda._sblocked_scratch(1, kv_heads, heads, d, 8192, 8192, "cpu")
    four, t4 = tda._sblocked_scratch(4, kv_heads, heads, d, 8192, 8192,
                                     "cpu")
    runs, _ = tda.sblock_split(8192, 8192, kv_heads)
    assert one.numel() * 4 == four.numel() == \
        4 * kv_heads * runs * (heads // kv_heads) * (d + 4)
    assert t4.numel() >= 4 * kv_heads and not bool(t4.any())


# --- the emulation against the JAX kernel and the plain version ------------

SEQ = 255


def _assert_close(got, want, kind, rows):
    got = np.asarray(got, np.float32)[rows]
    want = np.asarray(want, np.float32)[rows]
    rel = 1e-4 if kind == "f32" else 1e-2
    assert np.abs(got - want).max() <= rel * np.abs(want).max()


@pytest.mark.parametrize("kind", ["bf16", "i8", "f32"])
@pytest.mark.parametrize("n_pos,window,rope_mode,with_valid", [
    (200, SEQ, None, False),        # two runs, the last ragged
    (300, SEQ, "rope", True),       # past the wrap, RoPE, a masked slot
    (300, 128, "half_norms", False),  # windowed: one run, QK norms
    (40, SEQ, None, False),         # one run, ragged
])
def test_emulation_matches_jax_and_plain(kind, n_pos, window, rope_mode,
                                         with_valid, monkeypatch):
    """The emulated K11 against JAX's S-blocked kernel in interpret mode and
    against the port's plain version (the TPU's S blocks and running max),
    on the same cache, step and switch; both write the same pools."""
    rng = np.random.default_rng(7 * n_pos + window)
    jcache, tcache = _prefilled(rng, kind, n_pos, seq=SEQ)
    pcache = tcache.copy()
    q, k, v, positions, valid, (jspec, tspec) = _step_inputs(
        rng, n_pos, rope_mode, with_valid)
    monkeypatch.setenv("GEMMA_SBLOCK_DECODE", "1")
    want, jcache = _j_write_attend(jcache, q, positions, k, v, window, valid,
                                   jspec)
    args = (torch.from_numpy(q), torch.from_numpy(positions),
            torch.from_numpy(k), torch.from_numpy(v), window)
    tvalid = None if valid is None else torch.from_numpy(valid)
    got = tda.decode_attention_write_sblocked_emulated(
        tcache, 0, *args, att_cap=50.0, valid=tvalid, rope=tspec)
    plain = tda.decode_attention_write_sblocked_plain(
        pcache, 0, *args, tda._s_block(pcache, 0), att_cap=50.0,
        valid=tvalid, rope=tspec)
    assert got.shape == plain.shape == tuple(want.shape) == (2, 1, 8, 256)
    rows = [0] if with_valid else [0, 1]
    _assert_close(got, want, kind, rows)
    _assert_close(got, plain, kind, rows)
    _assert_pools(tcache, jcache, kind, exact=rope_mode is None)
    for a, w in ((tcache.kv, pcache.kv), (tcache.kv_scale, pcache.kv_scale)):
        if a is not None:
            assert torch.equal(a, w)
