"""The nuq4 gather diagnostic's GEMM (K13; counterpart of
scripts/proto_nuq_diag.py's Pallas kernel `kern`, ported to
csrc/nuq_diag.cu).

Three GEMMs out[M, N] f32 = A[M, K] bf16 . B[N, K]^T over u8 codes
[N, K], each with full-K tiles, that differ only in how B is made:
  D1  bf16(int8(code))                the cast (codes read as int8);
  D2  bf16(int32(code))               the same through i32 (0..255);
  D3  bf16(table[n, sub*128 + code])  the gather: per 128-chunk of K,
      sub = chunk // 16, from f32 tables [N, tl]; codes below 128.
D1 and D2 differ for codes of 128 and above.  `run` launches the kernel
for CUDA tensors and takes `run_plain` for CPU tensors;
`gemma_tpu_torch.scripts.proto_nuq_diag` times the three on the card.

The kernel is the decode tile of K1 over one-byte codes (csrc/
nuq_diag.cu): `diag_split` chooses its warps per row group and cluster
splits from the shapes alone, `diag_smem` is its shared-memory plan.
"""

from __future__ import annotations

import torch

from gemma_tpu_torch.ops import _cuda
from gemma_tpu_torch.ops.matmul import DECODE_WARP_COLS, decode_split

VARIANTS = ("D1", "D2", "D3")
# a, codes, tables, out; M, N, K, tl, kw, splits.
KERNELS = {v: _cuda.Kernel(
    f"nuq_diag_{v.lower()}", "nuq_diag.cu", f"gemma_nuq_diag_{v.lower()}",
    [_cuda.P] * 4 + [_cuda.I] * 6) for v in VARIANTS}

# csrc/nuq_diag.cu's constants: the most rows of A, K's chunk (128 one-
# byte codes a weight row), A's row padding, the shared memory a block
# may take, the most blocks of a cluster.
DIAG_ROWS = 16
DIAG_CHUNK = 128
DIAG_PAD = 4
DIAG_SMEM_MAX = 200 * 1024
DIAG_MAX_SPLITS = 8
DIAG_TPAD = 16  # D3 table rows' padding (entries)
# Blocks an H100 holds at once at two an SM (132 SMs): the kernels' launch
# bound at M > 8, and what a 128-row panel's D3 tables leave room for.
DIAG_RESIDENT = 2 * 132


def diag_split(n: int, k: int, variant: str) -> tuple[int, int]:
    """(kw, splits) of the diagnostic's tile, from the shapes alone, never
    from M: one warp a row group (128-column panels, so a block stages A
    for the most weight rows), the K of a panel split over a cluster
    until the card holds about every block at once (DIAG_RESIDENT), and
    at least as far as the decode tile's rule splits it (ops/matmul.py:
    decode_split, whose chunk for one-byte weights is the diagnostic's);
    more warps a row group (a narrower panel, fewer D3 table rows) while
    a block of DIAG_ROWS rows would pass DIAG_SMEM_MAX.  At N = 9216, K =
    2304 (the script's shape) this is (1, 3), which measured faster at M
    = 16 than decode_split's (4, 1) for all three variants on an H100,
    and slower at M = 4."""
    chunks = k // DIAG_CHUNK
    panels = -(-n // (DECODE_WARP_COLS[False] * 8))
    splits = max(decode_split(n, k, "i8", False)[1],
                 min(DIAG_MAX_SPLITS, chunks, DIAG_RESIDENT // panels))
    kw = 1
    while kw < 8 and diag_smem(variant, DIAG_ROWS, k, splits,
                               kw)["bytes"] > DIAG_SMEM_MAX:
        kw *= 2
    return kw, splits


def diag_smem(variant: str, m: int, k: int, splits: int,
              kw: int) -> dict[str, int]:
    """Byte offsets of a block's dynamic shared memory (csrc/nuq_diag.cu:
    diag_smem): A's slice of the longest split (rows padded by DIAG_PAD),
    the partial products of a split K, the warps' partial sums, and for
    D3 the panel's table rows as bf16, `tbl_ld` entries a row: the
    128-entry slices its chunks read (chunk c reads slice c // 16)."""
    chunks = k // DIAG_CHUNK
    cmax = -(-chunks // splits)
    pc = DECODE_WARP_COLS[False] * (8 // kw)
    red = -(-m * (cmax * DIAG_CHUNK + DIAG_PAD) * 2 // 16) * 16
    wred = red + (m * pc * 4 if splits > 1 else 0)
    tbl = wred + (8 * (2 if m > 8 else 1) * 4 * 32 * 4 if kw > 1 else 0)
    slices = (chunks - 1) // 16 + 1 if splits == 1 else (cmax - 1) // 16 + 2
    tbl_ld = slices * 128 + DIAG_TPAD if variant == "D3" else 0
    return {"red": red, "wred": wred, "tbl": tbl, "tbl_ld": tbl_ld,
            "bytes": tbl + pc * tbl_ld * 2}


def b_operand(codes: torch.Tensor, tables: torch.Tensor | None,
              variant: str) -> torch.Tensor:
    """The variant's B [N, K] as bf16 (plain PyTorch)."""
    if variant == "D1":
        return codes.view(torch.int8).to(torch.bfloat16)
    if variant == "D2":
        return codes.to(torch.int32).to(torch.bfloat16)
    if variant != "D3":
        raise ValueError(f"variant {variant!r}: one of {VARIANTS}")
    k = codes.shape[1]
    sub = torch.arange(k, device=codes.device) // 128 // 16
    # The 128-wide slices take codes below 128 (the kernel reads code & 127).
    idx = sub * 128 + (codes.long() & 127)
    return torch.gather(tables, 1, idx).to(torch.bfloat16)


def run_plain(a: torch.Tensor, codes: torch.Tensor, tables, variant: str):
    """The diagnostic GEMM in plain PyTorch: f32 [M, N]."""
    return a.float() @ b_operand(codes, tables, variant).float().T


def run(a: torch.Tensor, codes: torch.Tensor, tables, variant: str):
    """a bf16 [M, K], codes u8 [N, K], tables f32 [N, tl] (D3; else may be
    None) -> f32 [M, N]: K13's kernel on CUDA, run_plain on the CPU."""
    if not a.is_cuda:
        return run_plain(a, codes, tables, variant)
    if variant not in VARIANTS:
        raise ValueError(f"variant {variant!r}: one of {VARIANTS}")
    m, k = a.shape
    n = codes.shape[0]
    _cuda.check(a, "a", torch.bfloat16)
    _cuda.check(codes, "codes", torch.uint8, (n, k))
    if k % 128 or n % 8:
        raise ValueError(f"K must be a multiple of 128 and N of 8, got "
                         f"K={k}, N={n}")
    tl = 0
    if variant == "D3":
        _cuda.check(tables, "tables", torch.float32)
        tl, need = tables.shape[1], -(-k // 2048) * 128
        if tables.shape[0] != n or tl < need:
            raise ValueError(f"tables must be [{n}, >= {need}], got "
                             f"{tuple(tables.shape)}")
    kw, splits = diag_split(n, k, variant)
    out = torch.empty(m, n, dtype=torch.float32, device=a.device)
    # The tile takes up to DIAG_ROWS rows of A: one launch per such block.
    for m0 in range(0, m, DIAG_ROWS):
        KERNELS[variant].launch(
            a.data_ptr() + 2 * m0 * k, codes.data_ptr(),
            _cuda.ptr(tables if variant == "D3" else None),
            out.data_ptr() + 4 * m0 * n, min(DIAG_ROWS, m - m0), n, k, tl,
            kw, splits)
    return out
