"""Diagnostic: the cost of the nuq4 gather GEMM's parts on the card (K13;
counterpart of scripts/proto_nuq_diag.py).  Times the three variants of
`gemma_tpu_torch.ops.nuq_diag` (D1 the int8 cast, D2 the cast through
i32, D3 the table gather) at M=16, K=2304, N=9216, with codes pre-offset
as the JAX script makes them, beside the nuq4 K1 GEMM (K7b) at the same
shape:

    python3 -m gemma_tpu_torch.scripts.proto_nuq_diag
"""

from __future__ import annotations

import subprocess

import torch

from gemma_tpu_torch.ops import _cuda
from gemma_tpu_torch.ops.nuq_diag import VARIANTS, run, run_plain
from gemma_tpu_torch.utils.basics import round_up


def make_inputs(m: int, k: int, n: int, device, seed: int = 0):
    """(a, codes, tables) as the JAX script makes them: a N(0, 1) in bf16;
    4-bit codes pre-offset by 16 * (256-block % 8), so each is below 128;
    tables U[0, 1) f32 [N, round_up(K/256 * 16, 128)]."""
    gen = torch.Generator(device=device).manual_seed(seed)
    a = torch.randn(m, k, generator=gen, device=device).to(torch.bfloat16)
    codes4 = torch.randint(0, 16, (n, k), generator=gen, device=device,
                           dtype=torch.uint8)
    offs = (16 * ((torch.arange(k, device=device) // 256) % 8)).to(
        torch.uint8)
    tables = torch.rand(n, round_up(k // 256 * 16, 128), generator=gen,
                        device=device)
    return a, codes4 + offs[None, :], tables


def main() -> int:
    from gemma_tpu_torch.ops import matmul as mm
    from gemma_tpu_torch.utils.synth import synth_quant

    if not torch.cuda.is_available():
        raise SystemExit("proto_nuq_diag times the kernels on a CUDA card")
    m, k, n = 16, 2304, 9216
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}; M={m} K={k} N={n}", flush=True)
    a, codes, tables = make_inputs(m, k, n, dev)
    for variant in VARIANTS:
        got = run(a, codes, tables, variant)
        want = run_plain(a, codes, tables, variant)
        err = float((got - want).abs().max())
        t = _cuda.time_ms(lambda: run(a, codes, tables, variant), 50)
        print(f"{variant}: {t * 1e3:8.2f} us ({0.5625 * k * n / t / 1e6:7.1f} "
              f"GB/s-eff-if-nuq4), max |kernel - plain| {err:.3g}",
              flush=True)
    w = synth_quant(torch.Generator(device=dev).manual_seed(1), n, k, dev,
                    "nuq4")
    t = _cuda.time_ms(lambda: mm.matmul(a, w), 50)
    print(f"nuq4 K1 (K7b): {t * 1e3:8.2f} us "
          f"({0.5625 * k * n / t / 1e6:7.1f} GB/s-eff)", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
