"""Time the unstacked GEMM kernels (K1, K2, K3, K6) of a checkout of the
port on the card, so that two checkouts can be compared in one run:

    python3 gemma_tpu_torch/scripts/time_gemms.py [--root DIR]

--root: the checkout whose `gemma_tpu_torch` is imported (default: the one
this file is in); its kernels build under DIR/build/.  Cases: Gemma2-2B
widths at batch 4 for i8 and i4 weights (K1 qkv with its prologue, att_w
and linear with the post-norm + residual pass, K2 with its prologue, K3
and K6 with k_top 64 over the 256000-row head), and at the 2048 rows of a
prefill round (4 x 512) for i8, bf16 and i4 weights (K1 qkv, att_w and
linear, K2; bf16 A, no passes, as the prefill branch calls them).  Each
is timed as
chip_smoke.py times kernels (`ops/_cuda.time_ms`: CUDA-graph replays
between CUDA events).  Prints one JSON line.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path


def own_timer():
    """`ops/_cuda.time_ms` of the checkout this file is in, loaded by path:
    the checkout under test (--root) may not have it, and both are timed
    by the same code."""
    path = Path(__file__).resolve().parents[1] / "ops" / "_cuda.py"
    spec = importlib.util.spec_from_file_location("_time_gemms_timer", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.time_ms


def kernel_cases(torch, mm, synth_quant):
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(77)
    b, d, ff, n_qkv, vocab = 4, 2304, 9216, 4096, 256000

    def randn(*shape, s=1.0):
        return torch.randn(*shape, generator=gen, device=dev).mul_(s)

    x, norm = randn(b, d, s=30.0), randn(d, s=0.05)
    post, add = randn(d, s=0.05), randn(b, d, s=10.0)
    a_att = randn(b, 2048, s=3.0).to(torch.bfloat16)
    a_lin = randn(b, ff, s=3.0).to(torch.bfloat16)
    out = {}
    for kind in ("i8", "i4"):
        w = synth_quant(gen, n_qkv, d, dev, kind)
        out[f"K1 {kind} qkv+pre"] = lambda w=w: mm.matmul(
            x, w, prologue_norm=norm)
        w = synth_quant(gen, d, 2048, dev, kind)
        out[f"K1 {kind} att_w+post"] = lambda w=w: mm.matmul(
            a_att, w, epilogue_norm=post, add=add)
        w = synth_quant(gen, d, ff, dev, kind)
        out[f"K1 {kind} linear+post"] = lambda w=w: mm.matmul(
            a_lin, w, epilogue_norm=post, add=add)
        g1 = synth_quant(gen, ff, d, dev, kind)
        g2 = synth_quant(gen, ff, d, dev, kind)
        out[f"K2 {kind} +pre"] = lambda g1=g1, g2=g2: mm.gated_ffn(
            x, g1, g2, prologue_norm=norm)
        head = synth_quant(gen, vocab, d, dev, kind, rms=0.05)
        out[f"K3 {kind}"] = lambda h=head: mm.matmul_top1(
            x, h, final_cap=30.0, prologue_norm=norm)
        out[f"K6 {kind} k64"] = lambda h=head: mm.matmul_topk(
            x, h, 64, final_cap=30.0, prologue_norm=norm)
    m = 4 * 512
    for kind in ("i8", "bf16", "i4"):
        for name, n, k in (("qkv", n_qkv, d), ("att_w", d, 2048),
                           ("linear", d, ff)):
            w = synth_quant(gen, n, k, dev, kind)
            a = randn(m, k).to(torch.bfloat16)
            out[f"K1 {kind} prefill {name}"] = lambda a=a, w=w: mm.matmul(
                a, w)
        g1 = synth_quant(gen, ff, d, dev, kind)
        g2 = synth_quant(gen, ff, d, dev, kind)
        a = randn(m, d).to(torch.bfloat16)
        out[f"K2 {kind} prefill"] = lambda a=a, g1=g1, g2=g2: mm.gated_ffn(
            a, g1, g2)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    from gemma_tpu_torch.ops import matmul as mm
    from gemma_tpu_torch.utils.synth import synth_quant

    if not torch.cuda.is_available():
        raise SystemExit("time_gemms times the kernels on a CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    time_ms = own_timer()
    res = {"root": root, "card": card, "ms": {
        name: time_ms(fn)
        for name, fn in kernel_cases(torch, mm, synth_quant).items()}}
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
