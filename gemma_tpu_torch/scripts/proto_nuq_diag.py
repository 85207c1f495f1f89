"""Diagnostic: the cost of the nuq4 gather GEMM's parts on the card (K13;
counterpart of scripts/proto_nuq_diag.py).  Times the three variants of
`gemma_tpu_torch.ops.nuq_diag` (D1 the int8 cast, D2 the cast through
i32, D3 the table gather) at K=2304, N=9216 and M=16 (the JAX script's
shape) and M=4 (the decode batch), with codes pre-offset as the JAX
script makes them, each beside torch.nn.functional.linear on A and the
variant's B made beforehand as bf16, and the nuq4 K1 GEMM (K7b) at the
same shape, for a checkout of the port, so that two checkouts can be
compared in one run:

    python3 gemma_tpu_torch/scripts/proto_nuq_diag.py [--root DIR]

--root: the checkout whose `gemma_tpu_torch` is imported (default: the one
this file is in); its kernels build under DIR/build/.  Each time is this
file's `ops/_cuda.time_ms` (CUDA-graph replays between CUDA events).
Prints a line per case and one JSON line with the card's name and power
limit.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import torch


def make_inputs(m: int, k: int, n: int, device, seed: int = 0):
    """(a, codes, tables) as the JAX script makes them: a N(0, 1) in bf16;
    4-bit codes pre-offset by 16 * (256-block % 8), so each is below 128;
    tables U[0, 1) f32 [N, K/256 * 16 rounded up to a multiple of 128]."""
    gen = torch.Generator(device=device).manual_seed(seed)
    a = torch.randn(m, k, generator=gen, device=device).to(torch.bfloat16)
    codes4 = torch.randint(0, 16, (n, k), generator=gen, device=device,
                           dtype=torch.uint8)
    offs = (16 * ((torch.arange(k, device=device) // 256) % 8)).to(
        torch.uint8)
    tables = torch.rand(n, -(-(k // 256 * 16) // 128) * 128, generator=gen,
                        device=device)
    return a, codes4 + offs[None, :], tables


def own_timer():
    """`ops/_cuda.time_ms` of the checkout this file is in, loaded by path,
    so that both checkouts are timed by the same code."""
    path = Path(__file__).resolve().parents[1] / "ops" / "_cuda.py"
    spec = importlib.util.spec_from_file_location("_proto_nuq_diag_timer",
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.time_ms


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch.nn.functional as F

    from gemma_tpu_torch.ops import matmul as mm
    from gemma_tpu_torch.ops.nuq_diag import (VARIANTS, b_operand, run,
                                              run_plain)
    from gemma_tpu_torch.utils.synth import synth_quant

    if not torch.cuda.is_available():
        raise SystemExit("proto_nuq_diag times the kernels on a CUDA card")
    time_ms = own_timer()
    k, n = 2304, 9216
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}; K={k} N={n}; {root}", flush=True)
    a16, codes, tables = make_inputs(16, k, n, dev)
    w = synth_quant(torch.Generator(device=dev).manual_seed(1), n, k, dev,
                    "nuq4")
    ms: dict = {}
    for m in (16, 4):
        a = a16[:m].contiguous()
        for variant in VARIANTS:
            got = run(a, codes, tables, variant)
            want = run_plain(a, codes, tables, variant)
            err = float((got - want).abs().max())
            t = time_ms(lambda: run(a, codes, tables, variant), 50)
            b = b_operand(codes, tables, variant)
            lib = time_ms(lambda: F.linear(a, b), 50)
            ms[f"{variant} M={m}"] = t
            ms[f"F.linear {variant} M={m}"] = lib
            print(f"{variant} M={m}: {t * 1e3:8.2f} us "
                  f"({0.5625 * k * n / t / 1e6:7.1f} GB/s-eff-if-nuq4), "
                  f"F.linear on its bf16 B {lib * 1e3:8.2f} us, "
                  f"max |kernel - plain| {err:.3g}", flush=True)
        t = time_ms(lambda: mm.matmul(a, w), 50)
        ms[f"nuq4 K1 M={m}"] = t
        print(f"nuq4 K1 (K7b) M={m}: {t * 1e3:8.2f} us "
              f"({0.5625 * k * n / t / 1e6:7.1f} GB/s-eff)", flush=True)
    print(json.dumps({"root": root, "card": card, "ms": ms}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
