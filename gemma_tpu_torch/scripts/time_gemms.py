"""Time the GEMM kernels (K1, K2, K3, K6 and the stacked K12) of a
checkout of the port on the card, so that two checkouts can be compared in
one run:

    python3 gemma_tpu_torch/scripts/time_gemms.py [--root DIR]

--root: the checkout whose `gemma_tpu_torch` is imported (default: the one
this file is in); its kernels build under DIR/build/.  Cases, each at
batch 4 (M = 4) unless named prefill:
  - the decode GEMMs with their norms: K1 qkv with its prologue norm, att_w
    and linear with the post-norm + residual add, linear with the add
    alone, K2 with its prologue; at Gemma2-2B widths for every weight
    codec (i8, sfp, bf16, f32, i4, nuq4), at Gemma2-9B and Gemma2-27B
    widths for i4 and nuq4; a checkout whose decode entries chain norm
    passes around the GEMM is timed for GEMM and passes together, as its
    callers pay for them;
  - K12, the same with-norm GEMMs on layer 1 of 2 stacked layers, i8 at
    Gemma2-2B widths and i4 at Gemma2-27B's;
  - each of those GEMMs alone (bf16 A, no norm, no add), beside one
    PyTorch call of the same function where there is one ("lib":
    torch._weight_int4pack_mm on the i4 codes repacked, F.linear for bf16
    and f32; K2 as gelu(y1) * y2 over two such calls; unstacked only),
    which does not depend on --root;
  - K3 over the 256000-row embedding with the final norm and the cap,
    with prob, for every codec at Gemma2-2B's K 2304 (i8 also without
    prob), i4 at Gemma2-27B's K 4608 and nuq4 at Gemma2-9B's K 3584; K6
    (k_top 64, the final norm and the cap) beside each on the same
    inputs (a checkout whose K6 chains a prologue pass is timed with it);
  - the 2048 rows of a prefill round (4 x 512) for i8, bf16 and i4
    weights (K1 qkv, att_w and linear, K2; bf16 A, no passes, as the
    prefill branch calls them).
Each is timed as chip_smoke.py times kernels (`ops/_cuda.time_ms` of the
checkout this file is in: CUDA-graph replays between CUDA events; the
heads over 5 replays, the rest over 20).  Prints one JSON line.
"""

from __future__ import annotations

import argparse
import dataclasses
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


# (model, d, ff, qkv rows, att_w K) of the widths timed at decode.
WIDTHS = {"2B": (2304, 9216, 4096, 2048), "9B": (3584, 14336, 8192, 4096),
          "27B": (4608, 36864, 8192, 4096)}


def int4pack_call(torch, a, w, w2=None):
    """torch._weight_int4pack_mm on A and w's i4 codes repacked (its int4
    dequantizes (q - 8) * scale + zero: zero = min + 8 * scale); with w2,
    gelu(A.W^T) * (A.W2^T) in three calls.  No tensor scale."""
    import torch.nn.functional as F

    def repack(w):
        n, half = w.arrays["codes"].shape
        p = w.arrays["codes"].to(torch.int32).reshape(n, half // 128, 128)
        codes = torch.stack([p & 15, p >> 4], dim=-2).reshape(n, 2 * half)
        packed = ((codes[:, ::2] << 4) | codes[:, 1::2]).to(torch.uint8)
        sc, mn = w.arrays["scales"], w.arrays["mins"]
        sz = torch.stack([sc.T, (mn + 8 * sc).T], dim=-1).to(
            torch.bfloat16).contiguous()
        return torch._convert_weight_to_int4pack(packed, 8), sz

    wp, sz = repack(w)
    if w2 is None:
        return lambda: torch._weight_int4pack_mm(a, wp, 128, sz)
    wp2, sz2 = repack(w2)
    return lambda: F.gelu(torch._weight_int4pack_mm(a, wp, 128, sz),
                          approximate="tanh") * torch._weight_int4pack_mm(
                              a, wp2, 128, sz2)


def dense_call(torch, a, w, w2=None):
    """F.linear on A and the dense weights (K2: gelu(y1) * y2)."""
    import torch.nn.functional as F

    a = a.to(w.arrays["w"].dtype)
    if w2 is None:
        return lambda: F.linear(a, w.arrays["w"])
    return lambda: F.gelu(F.linear(a, w.arrays["w"]), approximate="tanh") \
        * F.linear(a, w2.arrays["w"])


CODECS = ("i8", "sfp", "bf16", "f32", "i4", "nuq4")
VOCAB = 256000


def decode_cases(torch, mm, synth_quant, gen, dev, out, model, kind,
                 stacked=False):
    """The decode GEMMs of one model's widths and one kind (stacked: on
    layer 1 of 2 stacked layers): with their norms, alone, and beside the
    library call where there is one."""
    d, ff, n_qkv, k_att = WIDTHS[model]
    b = 4

    def randn(*shape, s=1.0):
        return torch.randn(*shape, generator=gen, device=dev).mul_(s)

    def weight(n, k):
        w = synth_quant(gen, n, k, dev, kind)
        if not stacked:
            return w
        w2 = synth_quant(gen, n, k, dev, kind)
        return mm.stack_quant_tensors(
            [w, dataclasses.replace(w2, scale=w.scale)])

    x, norm = randn(b, d, s=30.0), randn(d, s=0.05)
    post, add = randn(d, s=0.05), randn(b, d, s=10.0)
    a_att = randn(b, k_att, s=3.0).to(torch.bfloat16)
    a_lin = randn(b, ff, s=3.0).to(torch.bfloat16)
    x_bf = mm.prenorm_plain(x, norm)
    lay = {"layer": 1} if stacked else {}
    lib = None if stacked else {"i4": int4pack_call, "bf16": dense_call,
                                "f32": dense_call}.get(kind)
    tag = f"{kind} {model}" if model != "2B" else kind
    k1, k2 = ("K12", "K12 gated") if stacked else ("K1", "K2")
    for name, n, k, a_alone, norms in (
            ("qkv", n_qkv, d, x_bf, dict(a=x, prologue_norm=norm)),
            ("att_w", d, k_att, a_att,
             dict(a=a_att, epilogue_norm=post, add=add)),
            ("linear", d, ff, a_lin,
             dict(a=a_lin, epilogue_norm=post, add=add))):
        w = weight(n, k)
        sfx = "+pre" if name == "qkv" else "+post"
        out[f"{k1} {tag} {name}{sfx}"] = lambda w=w, kw=norms: mm.matmul(
            kw["a"], w, **{key: v for key, v in kw.items() if key != "a"},
            **lay)
        out[f"{k1} {tag} {name} alone"] = lambda a=a_alone, w=w: mm.matmul(
            a, w, **lay)
        if name == "linear" and not stacked:
            out[f"{k1} {tag} linear+add"] = lambda w=w: mm.matmul(
                a_lin, w, add=add)
        if lib is not None:
            out[f"{k1} {tag} {name} lib"] = lib(torch, a_alone, w)
    g1, g2 = weight(ff, d), weight(ff, d)
    out[f"{k2} {tag} +pre"] = lambda: mm.gated_ffn(
        x, g1, g2, prologue_norm=norm, **lay)
    out[f"{k2} {tag} alone"] = lambda: mm.gated_ffn(x_bf, g1, g2, **lay)
    if lib is not None:
        out[f"{k2} {tag} lib"] = lib(torch, x_bf, g1, g2)


def head_cases(torch, mm, synth_quant, gen, dev, out):
    """K3 for every codec at Gemma2-2B's K (i8 also without prob), i4 at
    Gemma2-27B's and nuq4 at Gemma2-9B's; K6 (k_top 64) beside each on the
    same inputs."""
    b = 4
    for model, kind, probs in (
            *(("2B", k, (True, False) if k == "i8" else (True,))
              for k in CODECS), ("27B", "i4", (True,)),
            ("9B", "nuq4", (True,))):
        d = WIDTHS[model][0]
        x = torch.randn(b, d, generator=gen, device=dev) * 30
        norm = torch.randn(d, generator=gen, device=dev) * 0.05
        head = synth_quant(gen, VOCAB, d, dev, kind, rms=0.05)
        for prob in probs:
            tag = f"K3 {kind} {model}" + ("" if prob else " no prob")
            out[tag] = lambda x=x, h=head, n=norm, p=prob: mm.matmul_top1(
                x, h, final_cap=30.0, prologue_norm=n, need_prob=p)
        out[f"K6 {kind} {model} k64"] = lambda x=x, h=head, n=norm: \
            mm.matmul_topk(x, h, 64, final_cap=30.0, prologue_norm=n)


def prefill_cases(torch, mm, synth_quant, gen, dev, out):
    d, ff, n_qkv = 2304, 9216, 4096
    m = 4 * 512

    def randn(*shape, s=1.0):
        return torch.randn(*shape, generator=gen, device=dev).mul_(s)

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
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(77)
    common = (torch, mm, synth_quant, gen, dev)
    decode = [("2B", k, False) for k in CODECS] + [
        (m, k, False) for m in ("9B", "27B") for k in ("i4", "nuq4")] + [
        ("2B", "i8", True), ("27B", "i4", True)]
    # (replays timed, the cases of one group of weights)
    groups = [(20, lambda out, m=m, k=k, st=st: decode_cases(
        *common, out, m, k, st)) for m, k, st in decode]
    groups += [(5, lambda out: head_cases(*common, out)),
               (20, lambda out: prefill_cases(*common, out))]
    ms = {}
    for iters, fill in groups:  # one group's weights on the card at a time
        cases: dict = {}
        fill(cases)
        for name, fn in cases.items():
            ms[name] = time_ms(fn, iters)
        del cases
        torch.cuda.empty_cache()
    res = {"root": root, "card": card, "ms": ms}
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
