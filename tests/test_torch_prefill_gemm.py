"""The prefill GEMMs (K1 and K2 at M > 16 rows) of gemma_tpu_torch.

On the CPU the port's `matmul` / `gated_ffn` take their plain versions;
they are held against the JAX package's `matmul` / `gated_ffn` (Pallas
kernels in interpret mode) at prefill row counts for every weight kind,
which pins the i8 and i4 group affines on the f32 output at M > 16.  The
routing to the CUDA entries is checked with faked kernels, as
tests/test_torch_kernels.py fakes them: M <= 16 rows reach
matmul_decode.cu's decode entries, more rows matmul_sm90.cu's prefill entries, plain or
stacked, and an M > 16 call that reached a decode entry would raise."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gemma_tpu.ops import matmul as jmm
from gemma_tpu_torch.models import bridge
from gemma_tpu_torch.ops import _cuda
from gemma_tpu_torch.ops import matmul as tmm
from tests.test_torch_codecs4 import packed_arrays
from tests.test_torch_matmul import (flatten_qt, i8_arrays, jax_kind_qt,
                                     rel_err)

torch.set_num_threads(1)

KINDS = ["i8", "sfp", "nuq", "bf16", "f32", "i4", "nuq4"]
N, K = 256, 512
SCALE = 0.37  # the packed kinds' tensor scale (the others carry their own)


def _weights(rng, kind, n=N, k=K, scale=SCALE):
    """(JAX QuantTensor, the port's via the bridge) of one kind."""
    if kind == "i8":
        arrays = i8_arrays(rng, n, k)
        jq = jmm.QuantTensor("i8", (n, k), 1.0,
                             {key: jnp.asarray(v) for key, v in arrays.items()})
    elif kind in ("i4", "nuq4"):
        arrays, _ = packed_arrays(rng, kind, n, k)
        jq = jmm.QuantTensor(kind, (n, k), scale,
                             {key: jnp.asarray(v) for key, v in arrays.items()})
    else:
        jq = jax_kind_qt(rng, n, k, kind)
    return jq, bridge.quant_tensor_from_numpy(flatten_qt(jq), "cpu")


def _a(rng, m, k=K):
    a_j = jnp.asarray(rng.normal(0, 1, (m, k)).astype(np.float32)).astype(
        jnp.bfloat16)
    return a_j, torch.from_numpy(np.asarray(a_j, np.float32)).to(
        torch.bfloat16)


@pytest.mark.parametrize("m", [17, 130])
@pytest.mark.parametrize("kind", KINDS)
def test_matmul_prefill_rows_match_jax(kind, m):
    """K1 at prefill row counts: bf16 A against each kind's weights, f32
    out.  Both sides form the same exact bf16 products (raw codes for i8
    and i4, whose group affines land on the output); only the f32
    summation order differs: 1e-5 of max|out|."""
    rng = np.random.default_rng(700 + 10 * KINDS.index(kind) + m)
    jq, tq = _weights(rng, kind)
    a_j, a_t = _a(rng, m)
    want = jmm.matmul(a_j, jq, out_dtype=jnp.float32, interpret=True)
    got = tmm.matmul(a_t, tq)
    assert got.shape == (m, N) and got.dtype == torch.float32
    assert rel_err(got, np.asarray(want, np.float32)) <= 1e-5


@pytest.mark.parametrize("m", [17, 130])
@pytest.mark.parametrize("kind", KINDS)
def test_gated_ffn_prefill_rows_match_jax(kind, m):
    """K2 at prefill row counts: bf16 gelu_tanh(A.W1^T) * (A.W2^T); one
    bf16 ulp of the output (2^-8 of max|out|) on top of the reordered f32
    sums."""
    rng = np.random.default_rng(800 + 10 * KINDS.index(kind) + m)
    j1, t1 = _weights(rng, kind)
    j2, t2 = _weights(rng, kind, scale=0.81)
    a_j, a_t = _a(rng, m)
    want = jmm.gated_ffn(a_j, j1, j2, out_dtype=jnp.bfloat16, interpret=True)
    got = tmm.gated_ffn(a_t, t1, t2)
    assert got.shape == (m, N) and got.dtype == torch.bfloat16
    assert rel_err(got.float(), np.asarray(want, np.float32)) <= 2 ** -8


# --- routing, with faked kernels ---------------------------------------------

_ROUTED = {"matmul": (tmm.MATMUL, tmm.MATMUL_STACKED, tmm.MATMUL_SM90),
           "gated": (tmm.GATED, tmm.GATED_STACKED, tmm.GATED_SM90)}
# The C entries' trailing ints: M, N, K (and out_bf16 for K1).
_INTS_AFTER_M = {"matmul": 4, "gated": 3}


@pytest.fixture
def faked(monkeypatch):
    """Every K1 / K2 entry faked: each records (name, M) and reports its
    own launch; the decode entries refuse M > 16 as the C source does
    (cudaErrorInvalidValue), so Kernel.launch raises.  CPU tensors pass
    the wrappers' checks (dtype and shape; the device is not checked)."""
    calls = []

    def check(t, name, dtype, shape=None):
        assert t.dtype == dtype and t.is_contiguous(), name
        assert shape is None or tuple(t.shape) == tuple(shape), name

    monkeypatch.setattr(_cuda, "check", check)
    monkeypatch.setattr(_cuda, "_stream", lambda: 0)
    for op, tables in _ROUTED.items():
        for table in tables:
            for kernel in table.values():
                def fn(*args, kernel=kernel, op=op):
                    *args, launched, _stream = args
                    assert len(args) == len(kernel.argtypes)
                    m = args[len(args) - _INTS_AFTER_M[op]]
                    calls.append((kernel.name, m))
                    if "sm90" not in kernel.name and m > 16:
                        return 1  # cudaErrorInvalidValue
                    launched._obj.value = 1
                    return 0

                monkeypatch.setattr(kernel, "_fn", fn)
    return calls


def _operands(kind, stacked, m):
    rng = np.random.default_rng(3)
    n, k = 16, 256
    ws = [_weights(rng, kind, n, k)[1] for _ in range(3 if stacked else 1)]
    w = tmm.stack_quant_tensors(ws) if stacked else ws[0]
    a = torch.zeros(m, k, dtype=torch.bfloat16)
    return a, w, 1 if stacked else None


@pytest.mark.parametrize("m", [4, 16, 17, 2048])
@pytest.mark.parametrize("stacked", [False, True])
@pytest.mark.parametrize("kind", KINDS)
def test_gemm_rows_pick_the_tile(faked, kind, stacked, m):
    """M <= 16 reaches the decode entries (stacked: K12's), M > 16 the
    prefill entries, for K1 and K2, every kind, plain or stacked."""
    codec = "sfp" if kind == "nuq" else kind
    a, w, layer = _operands(kind, stacked, m)
    out = tmm._matmul_cuda(a, w, torch.float32, None, None, None, layer)
    assert out.shape == (m, w.n)
    out = tmm._gated_cuda(a, w, w, torch.bfloat16, None, layer)
    assert out.shape == (m, w.n)
    if m > tmm.DECODE_ROWS:
        want = [(f"matmul_sm90_{codec}", m), (f"gated_sm90_{codec}", m)]
    elif stacked:
        want = [(f"matmul_stacked_{codec}", m), (f"gated_stacked_{codec}", m)]
    else:
        want = [(f"matmul_{codec}", m), (f"gated_{codec}", m)]
    assert faked == want


@pytest.mark.parametrize("stacked", [False, True])
@pytest.mark.parametrize("op", ["matmul", "gated"])
def test_prefill_rows_on_a_decode_entry_raise(faked, monkeypatch, op,
                                              stacked):
    """Were 2048 rows routed to the decode tile, its entry's refusal
    would raise: no quiet fallback."""
    monkeypatch.setattr(tmm, "DECODE_ROWS", 4096)
    a, w, layer = _operands("i8", stacked, 2048)
    with pytest.raises(RuntimeError, match="cudaError 1"):
        if op == "matmul":
            tmm._matmul_cuda(a, w, torch.float32, None, None, None, layer)
        else:
            tmm._gated_cuda(a, w, w, torch.bfloat16, None, layer)


def test_decode_entries_refuse_prefill_rows():
    """matmul_decode.cu's K1 / K2 entries refuse M > 16 (the rows the
    wrapper sends to matmul_sm90.cu) before they launch anything, and both
    sides name the same bound."""
    src = (_cuda.CSRC / "matmul_decode.cu").read_text()
    assert f"constexpr int kDecodeRows = {tmm.DECODE_ROWS};" in src
    check = src[src.index("static int decode_check("):]
    assert "p.M > kDecodeRows" in check[:check.index("\n}\n")]
    for entry in ("static int matmul_entry(", "static int gated_entry("):
        body = src[src.index(entry):]
        body = body[:body.index("\n}\n")]
        assert body.index("decode_check<CODEC, ") < body.index(
            "launch_decode<CODEC, ")
        assert "if (smem < 0) return (int)cudaErrorInvalidValue;" in body
