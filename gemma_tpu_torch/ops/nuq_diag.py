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
"""

from __future__ import annotations

import torch

from gemma_tpu_torch.ops import _cuda

VARIANTS = ("D1", "D2", "D3")
KERNELS = {v: _cuda.Kernel(
    f"nuq_diag_{v.lower()}", "nuq_diag.cu", f"gemma_nuq_diag_{v.lower()}",
    [_cuda.P] * 4 + [_cuda.I] * 4) for v in VARIANTS}


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
    out = torch.empty(m, n, dtype=torch.float32, device=a.device)
    KERNELS[variant].launch(a.data_ptr(), codes.data_ptr(),
                            _cuda.ptr(tables if variant == "D3" else None),
                            out.data_ptr(), m, n, k, tl)
    return out
