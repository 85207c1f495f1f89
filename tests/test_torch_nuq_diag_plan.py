"""K13, the nuq4 gather diagnostic on the decode tile, checked without a
card.

  - The Python mirrors of csrc/nuq_diag.cu (its constants, `diag_split`'s
    warps a row group and cluster splits, `diag_smem`'s shared-memory
    plan) against the source, and the plan's properties at the script's
    shapes and others: the split from the shapes alone, every block within
    its shared memory, each block's K slice and D3 table slices inside
    what the entry checks.
  - D3's tables staged as bf16 and gathered equal the f32 entries
    gathered and then rounded, bit for bit, over random tables (ties of
    the bf16 rounding included) and codes (all 256 byte values: the
    kernel reads code & 127).
  - `run` on its CUDA branch with the entries faked: one launch per 16
    rows of A, the split of `diag_split`, the row offsets of A and out.
"""

import re

import numpy as np
import pytest
import torch

from gemma_tpu_torch.ops import _cuda
from gemma_tpu_torch.ops import matmul as tmm
from gemma_tpu_torch.ops import nuq_diag as diag

torch.set_num_threads(1)

_SRC = (_cuda.CSRC / "nuq_diag.cu").read_text()


def _const(name: str) -> int:
    m = re.search(rf"constexpr int {name} = ([0-9* ]+);", _SRC)
    assert m, name
    return eval(m.group(1))  # noqa: S307 (a product of integer literals)


def test_constants_match_the_source():
    assert _const("kDiagRows") == diag.DIAG_ROWS
    assert _const("kDiagChunk") == diag.DIAG_CHUNK
    assert _const("kDiagPad") == diag.DIAG_PAD
    assert _const("kDiagSmemMax") == diag.DIAG_SMEM_MAX
    assert _const("kDiagMaxSplits") == diag.DIAG_MAX_SPLITS
    assert _const("kDiagTPad") == diag.DIAG_TPAD
    # The chunk is the decode tile's for one-byte weights.
    assert tmm.CHUNK["i8"] == diag.DIAG_CHUNK
    # Each line of diag_smem's arithmetic appears in the source as the
    # mirror computes it.
    for line in ("L.red = (M * (cmax * kDiagChunk + kDiagPad) * 2 + 15) / 16 * 16;",
                 "L.wred = L.red + (splits > 1 ? M * pc * 4 : 0);",
                 "L.tbl = L.wred + (kw > 1 ? 8 * (M > 8 ? 2 : 1) * 4 * 32 * 4 : 0);",
                 "const int slices = splits == 1 ? (chunks - 1) / 16 + 1 : (cmax - 1) / 16 + 2;",
                 "L.tbl_ld = V == 3 ? slices * 128 + kDiagTPad : 0;",
                 "L.bytes = L.tbl + pc * L.tbl_ld * 2;"):
        assert line in _SRC, line


def test_smem_plan_at_the_script_shape():
    """M = 16, K = 2304, N = 9216: one warp a row group, 72 panels of 128
    columns, K split over clusters of 3 (216 blocks, the card holds 264
    at two an SM); A's 16 padded rows of 6 chunks, the block's partial
    products [16, 128], and (D3) 128 table rows of two 128-entry slices
    in bf16, each padded by 16 entries: two blocks an SM."""
    assert diag.diag_split(9216, 2304, "D1") == (1, 3)
    assert diag.diag_split(9216, 2304, "D3") == (1, 3)
    p1 = diag.diag_smem("D1", 16, 2304, 3, 1)
    p3 = diag.diag_smem("D3", 16, 2304, 3, 1)
    assert p1["red"] == 16 * 772 * 2
    assert p1["bytes"] == 16 * 772 * 2 + 16 * 128 * 4
    assert p3["tbl_ld"] == 272 and p3["bytes"] == p1["bytes"] + 128 * 272 * 2
    assert 2 * p3["bytes"] <= 227 * 1024
    assert diag.diag_smem("D1", 4, 2304, 3, 1)["bytes"] == \
        4 * 772 * 2 + 4 * 128 * 4


SHAPES = [(9216, 2304), (2304, 9216), (512, 2304), (256000, 2304),
          (4096, 24576), (8, 128), (2048, 3584), (14336, 3584),
          (3584, 14336), (36864, 4608), (4608, 36864)]


@pytest.mark.parametrize("variant", diag.VARIANTS)
@pytest.mark.parametrize("n,k", SHAPES)
def test_split_plan_fits_and_covers(variant, n, k):
    kw, splits = diag.diag_split(n, k, variant)
    chunks = k // diag.DIAG_CHUNK
    assert kw in (1, 2, 4, 8)
    assert 1 <= splits <= min(chunks, diag.DIAG_MAX_SPLITS)
    # One warp a row group but where a block would not fit; the split
    # fills the card's resident blocks, at least decode_split's.
    panels = -(-n // 128)
    want = max(tmm.decode_split(n, k, "i8", False)[1],
               min(diag.DIAG_MAX_SPLITS, chunks, diag.DIAG_RESIDENT // panels))
    assert splits == want
    assert kw == 1 or diag.diag_smem(variant, diag.DIAG_ROWS, k, splits,
                                     kw // 2)["bytes"] > diag.DIAG_SMEM_MAX
    for m in range(1, diag.DIAG_ROWS + 1):
        plan = diag.diag_smem(variant, m, k, splits, kw)
        assert plan["bytes"] <= diag.DIAG_SMEM_MAX
        assert plan["red"] % 16 == 0 and plan["tbl"] % 16 == 0
    # The blocks' K slices (split_chunks, as the kernel cuts them) cover
    # K once; each block's table slices lie inside its tbl_ld and inside
    # the tables the entry asks for.
    parts = tmm.split_chunks(chunks, splits)
    assert parts[0][0] == 0 and parts[-1][1] == chunks
    assert all(a[1] == b[0] for a, b in zip(parts, parts[1:]))
    plan = diag.diag_smem(variant, diag.DIAG_ROWS, k, splits, kw)
    need = ((chunks - 1) // 16 + 1) * 128
    for c0, c1 in parts:
        assert c1 - c0 <= -(-chunks // splits)
        s0, s1 = c0 // 16, (c1 - 1) // 16
        if variant == "D3":
            assert (s1 - s0 + 1) * 128 + diag.DIAG_TPAD <= plan["tbl_ld"]
            # consecutive rows start 8 banks (32 bytes) apart
            assert plan["tbl_ld"] * 2 % 128 == 32
        assert (s1 + 1) * 128 <= need
    # The wrapper's table check asks for the same width.
    assert need == -(-k // 2048) * 128


def test_split_does_not_depend_on_rows():
    """diag_split takes no M: a row's sums run in one order at every M."""
    import inspect

    assert list(inspect.signature(diag.diag_split).parameters) == [
        "n", "k", "variant"]


def d3_staged_b(codes: torch.Tensor, tables: torch.Tensor) -> torch.Tensor:
    """D3's B as the kernel forms it: the tables rounded to bf16 first (its
    staging), then gathered."""
    k = codes.shape[1]
    sub = torch.arange(k) // 128 // 16
    idx = sub * 128 + (codes.long() & 127)
    return torch.gather(tables.to(torch.bfloat16), 1, idx)


@pytest.mark.parametrize("seed", range(4))
def test_bf16_staged_tables_gather_exactly(seed):
    rng = np.random.default_rng(seed)
    n, k = 64, 4608
    tl = -(-k // 2048) * 128
    tables = rng.normal(0, 3, (n, tl)).astype(np.float32)
    # Entries exactly halfway between two bf16 values, and near it.
    bits = tables.view(np.uint32)
    bits[:, ::5] = (bits[:, ::5] & 0xffff0000) | 0x8000
    bits[:, 1::5] = (bits[:, 1::5] & 0xffff0000) | 0x7fff
    codes = torch.from_numpy(rng.integers(0, 256, (n, k)).astype(np.uint8))
    t = torch.from_numpy(tables)
    staged = d3_staged_b(codes, t)
    want = diag.b_operand(codes, t, "D3")
    assert staged.dtype == want.dtype == torch.bfloat16
    assert torch.equal(staged.view(torch.int16), want.view(torch.int16))
    # ...and both are the f32 entries gathered, then rounded.
    sub = torch.arange(k) // 128 // 16
    f32 = torch.gather(t, 1, sub * 128 + (codes.long() & 127))
    assert torch.equal(want, f32.to(torch.bfloat16))


# --- run's CUDA branch, the entries faked ------------------------------------


class _OnCard(torch.Tensor):
    @property
    def is_cuda(self):
        return True


@pytest.fixture
def faked(monkeypatch):
    calls = []

    def check(t, name, dtype, shape=None):
        assert t.dtype == dtype and t.is_contiguous(), name
        assert shape is None or tuple(t.shape) == tuple(shape), name

    monkeypatch.setattr(_cuda, "check", check)
    monkeypatch.setattr(_cuda, "_stream", lambda: 0)
    for kernel in diag.KERNELS.values():
        def fn(*args, kernel=kernel):
            *args, launched, _stream = args
            assert len(args) == len(kernel.argtypes)
            calls.append((kernel.name, args))
            launched._obj.value = 1
            return 0

        monkeypatch.setattr(kernel, "_fn", fn)
    return calls


@pytest.mark.parametrize("variant", diag.VARIANTS)
@pytest.mark.parametrize("m", [1, 4, 16, 17, 40])
def test_run_launches_per_16_rows(faked, variant, m):
    n, k = 512, 2304
    a = torch.zeros(m, k, dtype=torch.bfloat16).as_subclass(_OnCard)
    codes = torch.zeros(n, k, dtype=torch.uint8)
    tables = torch.zeros(n, 256)
    out = diag.run(a, codes, tables, variant)
    assert out.shape == (m, n)
    kw, splits = diag.diag_split(n, k, variant)
    assert len(faked) == -(-m // diag.DIAG_ROWS)
    for i, (name, args) in enumerate(faked):
        assert name == f"nuq_diag_{variant.lower()}"
        m0 = i * diag.DIAG_ROWS
        assert args[0] == a.data_ptr() + 2 * m0 * k
        assert args[3] == out.data_ptr() + 4 * m0 * n
        assert args[4:] == [min(diag.DIAG_ROWS, m - m0), n, k,
                            256 if variant == "D3" else 0, kw, splits]
        assert (args[2] is None) == (variant != "D3")
