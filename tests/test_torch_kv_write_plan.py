"""K9, the ring-row write from the raw rows, checked without a card.

  - The i8 encode that K9 runs one warp a row and K4 / K8 run one block a
    row (csrc/decode_attention.cu: I8Row), emulated in numpy as K9's warp
    computes it: lane l's 8-element units l and l + 32, its own max, the
    shuffle tree's max (xor 16, 8, 4, 2, 1), scale = amax / 127, inv =
    1 / scale (0 for a zero row), codes rint(x * inv).  It must equal the
    port's and the JAX package's `quantize_rows` bit for bit: a max is
    exact in any order, and the rest is the same f32 operations.  Rows:
    all zero, values at .5 after scaling, subnormal entries and a
    subnormal scale (XLA's CPU backend flushes that one to zero, so JAX
    is not held to it), the max in the last lane, ties of the max, f32
    and bf16 inputs.
  - The wrapper on its CUDA branch, with the C entry faked: it hands K9 the
    raw k / v pointers with their own strides (views into one interleaved
    kv row too), f32 or bf16, and never calls `quantize_rows`,
    `torch.stack` or `_pool_rows`.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gemma_tpu.ops.kv_quant import quantize_rows as j_quantize_rows
from gemma_tpu_torch.models.configs import config_gemma2_2b
from gemma_tpu_torch.models.kv_cache import KVCache
from gemma_tpu_torch.ops import _cuda
from gemma_tpu_torch.ops import decode_attention as tda
from gemma_tpu_torch.ops.kv_quant import quantize_rows

torch.set_num_threads(1)


def warp_encode(rows: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """rows f32 [R, D] -> (codes i8 [R, D], scales f32 [R]) as K9's warp
    makes them."""
    r, d = rows.shape
    codes = np.zeros((r, d), np.int8)
    scales = np.zeros(r, np.float32)
    for i, x in enumerate(rows.astype(np.float32)):
        lanes = np.zeros(32, np.float32)
        for lane in range(32):
            for u in (lane, lane + 32):
                if u < d // 8:
                    lanes[lane] = np.max(np.concatenate(
                        [[lanes[lane]], np.abs(x[8 * u:8 * u + 8])]))
        for off in (16, 8, 4, 2, 1):
            lanes = np.maximum(lanes, lanes[np.arange(32) ^ off])
        amax = lanes[0]
        assert np.all(lanes == amax)  # every lane holds the row's max
        scale = np.float32(amax / np.float32(127.0))
        inv = np.float32(np.float32(1.0) / scale) if scale > 0 \
            else np.float32(0.0)
        codes[i] = np.rint(x * inv).astype(np.int8)
        scales[i] = scale
    return codes, scales


def _rows(d: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    rows = rng.normal(0, 2, (8, d)).astype(np.float32)
    rows[0] = 0.0                                   # all zero: scale 0
    rows[1] = (np.arange(d) % 9 - 4) + 0.5          # .5 after scaling:
    rows[1, 5] = 127.0                              # scale 1, inv 1
    rows[2, ::7] = 1e-40                            # subnormal entries
    rows[6] = rng.normal(0, 1e-37, d)               # a subnormal scale:
    rows[6, 3] = 1e-36                              # inv still finite
    rows[3, -1] = 1e3                               # max in the last lane
    rows[4] = -rows[4]
    rows[4, d // 2] = -77.0
    rows[5, :] = 3.0                                # ties of the max
    return rows


@pytest.mark.parametrize("d", [128, 256, 512, 64])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_warp_encode_matches_quantize_rows(d, dtype):
    rows = _rows(d, d)
    t = torch.from_numpy(rows)
    if dtype == "bf16":
        t = t.to(torch.bfloat16)
        rows = t.float().numpy()
    codes, scales = warp_encode(rows)
    t_codes, t_scale = quantize_rows(t)
    np.testing.assert_array_equal(codes, t_codes.numpy())
    np.testing.assert_array_equal(scales, t_scale.numpy())
    jx = jnp.asarray(rows)
    if dtype == "bf16":
        jx = jx.astype(jnp.bfloat16)
    j_codes, j_scale = j_quantize_rows(jx)
    # XLA's CPU backend flushes subnormal results to zero (row 6's scale);
    # torch and the CUDA sources (no fast-math, so no flush) keep them.
    normal = np.arange(len(rows)) != 6
    assert scales[6] < np.finfo(np.float32).tiny
    np.testing.assert_array_equal(codes[normal], np.asarray(j_codes)[normal])
    np.testing.assert_array_equal(scales[normal],
                                  np.asarray(j_scale)[normal])
    assert scales[0] == 0 and not codes[0].any()
    # round half to even at the .5 values of row 1 (scale exactly 1)
    assert scales[1] == 1.0
    np.testing.assert_array_equal(codes[1], np.rint(rows[1]).astype(np.int8))


def test_row_limit_matches_the_source():
    """K9 reads a row in 8-element units, KVW_MAXU a lane: the wrapper's
    KV_WRITE_MAX_D is the entry's limit."""
    import re

    src = (_cuda.CSRC / "decode_attention.cu").read_text()
    maxu = int(re.search(r"constexpr int KVW_MAXU = (\d+);", src).group(1))
    assert 8 * 32 * maxu == tda.KV_WRITE_MAX_D
    assert "d > 8 * 32 * KVW_MAXU" in src


def test_kernel_encode_is_shared():
    """K4's, K8's and K9's i8 encode is one device function."""
    src = (_cuda.CSRC / "decode_attention.cu").read_text()
    assert src.count("struct I8Row") == 1
    assert src.count("/ 127.0f") == 1
    assert src.count("I8Row e") >= 4 and "const I8Row enc(warp_max(amax))" \
        in src


# --- the wrapper's CUDA branch, the C entry faked -----------------------------


class _OnCard(torch.Tensor):
    """A CPU tensor that reports itself on the card, so the wrapper takes
    its CUDA branch; the faked entry reads nothing through the pointers."""

    @property
    def is_cuda(self):
        return True


def _on_card(t):
    return t.as_subclass(_OnCard)


@pytest.fixture
def faked(monkeypatch):
    """K9's entries faked: each records its arguments by name and reports
    one launch.  CPU tensors pass the wrappers' checks (dtype and shape)."""
    calls = []
    names = ["k", "v", "k_bs", "k_hs", "v_bs", "v_hs", "in_bf16", "pool",
             "scales", "pos", "valid", "batch", "n_layers", "layer", "kvh",
             "s_alloc", "d", "ring"]

    def check(t, name, dtype, shape=None):
        assert t.dtype == dtype and t.is_contiguous(), name
        assert shape is None or tuple(t.shape) == tuple(shape), name

    monkeypatch.setattr(_cuda, "check", check)
    monkeypatch.setattr(_cuda, "_stream", lambda: 0)
    for kernel in tda.KV_WRITE.values():
        def fn(*args, kernel=kernel):
            *args, launched, _stream = args
            assert len(args) == len(kernel.argtypes) == len(names)
            calls.append((kernel.name, dict(zip(names, args))))
            launched._obj.value = 1
            return 0

        monkeypatch.setattr(kernel, "_fn", fn)
    return calls


def _forbid_torch_encode(monkeypatch):
    """quantize_rows, _pool_rows and torch.stack raise from here on."""
    def forbidden(*a, **k):
        raise AssertionError("the CUDA branch encoded the rows in torch ops")

    monkeypatch.setattr(tda, "quantize_rows", forbidden)
    monkeypatch.setattr(tda, "_pool_rows", forbidden)
    monkeypatch.setattr(torch, "stack", forbidden)


def _cache(kind):
    cfg = config_gemma2_2b()
    return cfg, KVCache.create(cfg, 4, 64, kind=kind, device="cpu")


@pytest.mark.parametrize("kind", ["i8", "bf16", "f32"])
@pytest.mark.parametrize("rows", ["strided f32", "contiguous f32",
                                  "contiguous bf16", "strided bf16"])
def test_cuda_branch_passes_raw_rows(faked, monkeypatch, kind, rows):
    cfg, cache = _cache(kind)
    lc = cfg.layer_configs[0]
    kvh, d = lc.kv_heads, lc.qkv_dim
    dt = torch.bfloat16 if "bf16" in rows else torch.float32
    # k, v as the composed path has them: RoPE's output and a view into
    # the fused qkv row (heads first, then K, V interleaved per KV head).
    qkv = torch.randn(4, (lc.heads + 2 * kvh) * d).to(dt)
    kvp = qkv[:, lc.heads * d:].reshape(4, 1, kvh, 2, d)
    k, v = kvp[..., 0, :], kvp[..., 1, :]
    if "contiguous" in rows:
        k, v = k.contiguous(), v.contiguous()
    positions = _on_card(torch.tensor([[3], [9], [17], [40]], dtype=torch.int32))
    valid = _on_card(torch.tensor([[True], [False], [True], [True]]))
    _forbid_torch_encode(monkeypatch)
    tda.kv_write_decode(cache, 1, positions, _on_card(k), _on_card(v), valid)
    assert len(faked) == 1
    name, a = faked[0]
    assert name == f"kv_write_{kind}"
    assert a["k"] == k.data_ptr() and a["v"] == v.data_ptr()
    assert (a["k_bs"], a["k_hs"]) == (k.stride(0), k.stride(2))
    assert (a["v_bs"], a["v_hs"]) == (v.stride(0), v.stride(2))
    if "strided" in rows:
        assert a["v_hs"] == 2 * d and a["v_bs"] == (lc.heads + 2 * kvh) * d
    assert a["in_bf16"] == int(dt == torch.bfloat16)
    pool, idx, ring = cache.pool(1)
    assert a["pool"] == pool.data_ptr()
    assert (a["scales"] is None) == (kind != "i8")
    assert a["pos"] == positions.data_ptr()
    assert (a["batch"], a["layer"], a["kvh"], a["d"], a["ring"]) == (
        4, idx, kvh, d, ring)
    assert a["s_alloc"] == pool.shape[4] and a["n_layers"] == pool.shape[1]


def test_cuda_branch_copies_only_misaligned_rows(faked):
    """A row whose 8-element units are not 16-byte aligned is copied
    contiguous (f32 at an odd head stride); mixed types go to f32; rows of
    another shape raise."""
    cfg, cache = _cache("i8")
    lc = cfg.layer_configs[0]
    kvh, d = lc.kv_heads, lc.qkv_dim
    pos = _on_card(torch.tensor([[3], [9], [17], [40]], dtype=torch.int32))
    wide = torch.randn(4, 1, kvh, d + 2)
    k = wide[..., :d]  # head stride d + 2: 8-byte steps
    v = torch.randn(4, 1, kvh, d)
    tda.kv_write_decode(cache, 0, pos, _on_card(k), _on_card(v))
    a = faked[-1][1]
    assert a["k"] != k.data_ptr() and (a["k_bs"], a["k_hs"]) == (kvh * d, d)
    assert a["v"] == v.data_ptr() and a["in_bf16"] == 0
    tda.kv_write_decode(cache, 0, pos, _on_card(v.to(torch.bfloat16)),
                        _on_card(v))
    assert faked[-1][1]["in_bf16"] == 0
    with pytest.raises(ValueError, match="must be a CUDA"):
        tda.kv_write_decode(cache, 0, pos, _on_card(v[:2]), _on_card(v[:2]))
    assert len(faked) == 2


def test_cpu_rows_take_the_plain_version(monkeypatch):
    called = []
    monkeypatch.setattr(tda, "kv_write_decode_plain",
                        lambda *a, **k: called.append(a))
    _, cache = _cache("bf16")
    k = torch.zeros(4, 1, 4, 256)
    tda.kv_write_decode(cache, 0, torch.zeros(4, 1, dtype=torch.int32), k, k)
    assert len(called) == 1
