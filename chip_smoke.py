#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`gemma_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py            # every phase, one card

Phases (any failure exits non-zero before the result line):
  1. device: nvidia-smi name and power limit, torch/CUDA versions, and the
     build of every kernel in gemma_tpu_torch/csrc (parallel nvcc), timed;
  2. kernels vs their plain PyTorch versions on the card, at the shapes of
     the serving paths (Gemma2-2B, batch 4), each error printed beside its
     tolerance, each timed with CUDA events over a CUDA graph beside its
     plain version and its bound (bytes over 3.35 TB/s or operations over
     989 TFLOP/s bf16, the H100 SXM data-sheet peaks): the i8 GEMMs and
     their norm passes, the gated GEMM, the fused greedy head (with and
     without its prob and an allowed mask, and a mask that bans every
     column), decode attention and prefill attention over i8, bf16 and f32
     KV pools;
  3. a 2-layer model at Gemma2-2B width (synthetic i8 weights): prefill +
     one decode step over an i8 cache, last logits on the card vs the
     plain path on the CPU; then `generate_batch` with a bf16 cache and
     decode_chunk=4 on both, tokens and probs compared;
  4. the serving paths at full depth (Gemma2-2B, 26 layers, synthetic i8
     weights made on the card), 4 ragged requests (17, 130, 300, 700
     prompt tokens).  For each path every kernel launch count is zeroed
     before the counted run and read after, checked against the path's
     per-layer schedule, and every plain version is made to raise:
       A. `GemmaEngine.generate_batch` with the default RuntimeConfig (bf16
          KV, decode_chunk=4, stream_probs): 32 new tokens, 3 runs
          (medians reported); two chunks under torch.profiler must show
          the launches the counters show, and one chunk runs with
          CUDA's sync debug mode set to error (no host sync inside a
          chunk); each first token is checked against a prefill-only
          forward;
       B. `generate_fast` with an i8 KV cache, 32 steps, whose tokens must
          equal generate_batch's with kv_kind="i8", decode_chunk=4;
       C. slice 1's path: kv_kind="i8", decode_chunk=1 (the head as the
          i8 GEMM, picked on the host), decode logits checked against a
          prefill-only forward;
       D. kv_kind="f32", decode_chunk=4, 8 new tokens;
  5. one `kernels` JSON line (launches summed over the counted runs of
     4A-D), then nvidia-smi's line, then the result line.

It needs the repository around it (the package and its csrc/) and a card:
without either it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
BF16_OPS_PER_S = 989e12     # dense bf16 tensor-core peak, same source


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def main() -> int:
    argparse.ArgumentParser(description=__doc__.split("\n\n")[0]).parse_args()

    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a GPU")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        import gemma_tpu_torch  # noqa: F401
    except ImportError as e:
        fail(f"the gemma_tpu_torch package is not beside this script ({e})")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]

    from gemma_tpu_torch.ops import _cuda

    print(f"[1] card: {smi}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}",
          flush=True)
    t0 = time.monotonic()
    _cuda.build_all(verbose=True)
    print(f"[1] built {len(list(_cuda.CSRC.glob('*.cu')))} sources in "
          f"{time.monotonic() - t0:.1f} s", flush=True)

    results = phase_kernels(torch)
    phase_two_layers(torch)
    counts = phase_main_path(torch)

    line = []
    for k in _cuda.all_kernels():
        r = results[k.name]
        line.append({
            "name": k.name, "route": "cuda",
            "source": f"gemma_tpu_torch/csrc/{k.source}",
            "replaces": REPLACES[k.name],
            "launches": counts[k.name],
            "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": None, "library_note": LIBRARY_NOTE[k.name],
            "case": r["case"], "cases": r["cases"],
        })
    print(json.dumps({"kernels": line}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


REPLACES = {
    "matmul_i8": "gemma_tpu/ops/matmul.py:577 (_mm_kernel)",
    "matmul_i8_prenorm":
        "gemma_tpu/ops/matmul.py:563 (_norm_a, the _mm_kernel/_gated_kernel "
        "prologue)",
    "matmul_i8_postnorm_add":
        "gemma_tpu/ops/matmul.py:612-626 (_mm_kernel post-norm + add epilogue)",
    "gated_i8": "gemma_tpu/ops/matmul.py:629 (_gated_kernel)",
    "top1_i8": "gemma_tpu/ops/matmul.py:1228 (_top1_kernel)",
    "decode_attention_i8":
        "gemma_tpu/ops/decode_attention.py:545 (_decode_fused_packed_kernel)",
    "decode_attention_bf16":
        "gemma_tpu/ops/decode_attention.py:545 (_decode_fused_packed_kernel, "
        "bf16 pool)",
    "decode_attention_f32":
        "gemma_tpu/ops/decode_attention.py:545 (_decode_fused_packed_kernel, "
        "f32 pool)",
    "flash_attention_i8": "gemma_tpu/ops/flash_attention.py:39 (_flash_kernel)",
    "flash_attention_bf16":
        "gemma_tpu/ops/flash_attention.py:39 (_flash_kernel, bf16 pool)",
    "flash_attention_f32":
        "gemma_tpu/ops/flash_attention.py:39 (_flash_kernel, f32 pool)",
}
LIBRARY_NOTE = {
    "matmul_i8": "no single PyTorch call applies the per-128-group i8 affine "
                 "(and the norm prologue) of this GEMM",
    "matmul_i8_prenorm": "torch.nn.functional.rms_norm has no (1 + w) form "
                         "and no bf16 rounding of its f32 result in one call",
    "matmul_i8_postnorm_add": "torch.nn.functional.rms_norm has no (1 + w) "
                              "form and no residual add in one call",
    "gated_i8": "no single PyTorch call computes gelu(A.W1^T)*(A.W2^T) over "
                "i8 group-quantized weights",
    "top1_i8": "no single PyTorch call computes the argmax and softmax prob "
               "of soft-capped logits of i8 group-quantized weights without "
               "the logits",
    "decode_attention_i8": "scaled_dot_product_attention has no i8 per-row "
                           "scales, ring mask, soft cap or in-place row write",
    "decode_attention_bf16": "scaled_dot_product_attention has no ring mask, "
                             "soft cap, RoPE or in-place row write",
    "decode_attention_f32": "scaled_dot_product_attention has no ring mask, "
                            "soft cap, RoPE or in-place row write",
    "flash_attention_i8": "scaled_dot_product_attention has no i8 per-row "
                          "scales or soft cap",
    "flash_attention_bf16": "scaled_dot_product_attention has no soft cap "
                            "(and no ring-window mask short of a dense one)",
    "flash_attention_f32": "scaled_dot_product_attention has no soft cap "
                           "(and no ring-window mask short of a dense one)",
}


def time_ms(torch, fn, iters: int = 20, warmup: int = 2) -> float:
    """Device time of one call of `fn`: `iters` calls captured in a CUDA
    graph, replayed and timed with CUDA events, so host-side Python between
    launches is not counted.  A call that cannot be captured fails the run."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start.record()
    for _ in range(3):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (3 * iters)


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    tb, to = nbytes / HBM_BYTES_PER_S * 1e3, ops / BF16_OPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def record(results, torch, name, case, got, want, tol, kern, plain, nbytes,
           ops, iters=20, primary=False):
    got = got.float()
    want = want.float()
    if not torch.isfinite(got).all():
        fail(f"{name} [{case}]: non-finite output")
    err = float((got - want).abs().max())
    ok = err <= tol
    b_ms, b_by = bound(nbytes, ops)
    k_ms = time_ms(torch, kern, iters)
    p_ms = time_ms(torch, plain, max(3, iters // 4), warmup=1)
    print(f"[2] {name:24s} {case:44s} max_abs_err {err:.4g} (tol {tol:.4g}) "
          f"kernel {k_ms:.4f} ms plain {p_ms:.4f} ms "
          f"bound {b_ms:.4f} ms ({b_by}) {'ok' if ok else 'FAIL'}",
          flush=True)
    if not ok:
        fail(f"{name} [{case}] disagrees with its plain version: {err} > {tol}")
    entry = results.setdefault(name, {"cases": []})
    c = {"case": case, "max_abs_err": err, "tol": tol, "ms": k_ms,
         "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by}
    entry["cases"].append(c)
    if primary:
        entry.update({k: v for k, v in c.items() if k != "tol"})


def phase_kernels(torch):
    """Each kernel vs its plain version at the serving path's shapes."""
    from gemma_tpu_torch.models.configs import config_gemma2_2b
    from gemma_tpu_torch.models.kv_cache import KVCache
    from gemma_tpu_torch.ops import decode_attention as da
    from gemma_tpu_torch.ops import flash_attention as fa
    from gemma_tpu_torch.ops import matmul as mm
    from gemma_tpu_torch.ops.attention import attention_mask
    from gemma_tpu_torch.ops.ops import create_inv_timescale
    from gemma_tpu_torch.utils.synth import synth_quant

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(1234)
    cfg = config_gemma2_2b()
    d, ff, b = cfg.model_dim, 9216, 4
    res: dict = {}

    def randn(*shape, s=1.0):
        return torch.randn(*shape, generator=gen, device=dev).mul_(s)

    def rel_tol(want, rel):
        return rel * float(want.float().abs().max())

    # --- K1 and its prologue and epilogue passes ---
    # Tolerance: kernel and plain form the same exact bf16 x i8 products;
    # f32 sums in another order and rare one-ulp flips of the bf16-rounded
    # prologue A give ~1e-5 relative; 1e-3 of max|out| bounds it.
    norm = randn(d, s=0.05)
    w_qkv = synth_quant(gen, 4096, d, dev)
    x = randn(b, d, s=30.0)
    f = lambda: mm.prenorm(x, norm)  # noqa: E731
    p = lambda: mm.prenorm_plain(x, norm)  # noqa: E731
    want = p()
    # bf16 output: a one-ulp flip (2^-8) where the f32 sums reorder.
    record(res, torch, "matmul_i8_prenorm", "decode M=4 K=2304", f(), want,
           rel_tol(want, 2 ** -8), f, p, b * d * 4 + d * 4 + b * d * 2, 0,
           primary=True)
    f = lambda: mm.matmul(x, w_qkv, prologue_norm=norm)  # noqa: E731
    p = lambda: mm.matmul_plain(x, w_qkv, prologue_norm=norm)  # noqa: E731
    want = p()
    record(res, torch, "matmul_i8",
           "decode qkv M=4 K=2304 N=4096 (+prenorm pass)",
           f(), want, rel_tol(want, 1e-3), f, p,
           b * d * 4 + d * 4 + w_qkv.nbytes() + b * 4096 * 4,
           2 * b * 4096 * d, primary=True)
    for name, k_in in (("att_w", 2048), ("linear", ff)):
        w = synth_quant(gen, d, k_in, dev)
        a = randn(b, k_in, s=3.0).to(torch.bfloat16)
        post = randn(d, s=0.05)
        add = randn(b, d, s=10.0)
        f = lambda: mm.matmul(a, w, epilogue_norm=post, add=add)  # noqa: E731
        p = lambda: mm.matmul_plain(a, w, epilogue_norm=post, add=add)  # noqa
        want = p()
        record(res, torch, "matmul_i8",
               f"decode {name} M=4 K={k_in} N={d} (+postnorm pass)", f(),
               want, rel_tol(want, 1e-3), f, p,
               b * k_in * 2 + w.nbytes() + b * d * 4, 2 * b * d * k_in)
        y = mm.matmul(a, w)
        f = lambda: mm.postnorm_add(y.clone(), post, add)  # noqa: E731
        p = lambda: mm.postnorm_add_plain(y, post, add)  # noqa: E731
        want = p()
        record(res, torch, "matmul_i8_postnorm_add",
               f"decode {name} M=4 N={d}", f(), want, rel_tol(want, 1e-5),
               f, p, 3 * b * d * 4 + d * 4, 0, primary=name == "att_w")
    w_head = synth_quant(gen, cfg.vocab_size, d, dev)
    fnorm = randn(d, s=0.05)
    f = lambda: mm.matmul(x, w_head, prologue_norm=fnorm)  # noqa: E731
    p = lambda: mm.matmul_plain(x, w_head, prologue_norm=fnorm)  # noqa: E731
    want = p()
    record(res, torch, "matmul_i8",
           "decode head M=4 K=2304 N=256000 (+prenorm pass)",
           f(), want, rel_tol(want, 1e-3), f, p,
           b * d * 4 + w_head.nbytes() + b * cfg.vocab_size * 4,
           2 * b * cfg.vocab_size * d, iters=5)
    m_pre = 4 * 512
    a_pre = randn(m_pre, d, s=1.0).to(torch.bfloat16)
    f = lambda: mm.matmul(a_pre, w_qkv)  # noqa: E731
    p = lambda: mm.matmul_plain(a_pre, w_qkv)  # noqa: E731
    want = p()
    record(res, torch, "matmul_i8", "prefill qkv M=2048 K=2304 N=4096", f(),
           want, rel_tol(want, 1e-3), f, p,
           m_pre * d * 2 + w_qkv.nbytes() + m_pre * 4096 * 4,
           2 * m_pre * 4096 * d, iters=5)
    # Prefill att_w and linear: plain bf16 A, f32 out, no epilogue (the
    # prefill branch norms and adds in plain torch).
    for name, k_in in (("att_w", 2048), ("linear", ff)):
        w = synth_quant(gen, d, k_in, dev)
        a = randn(m_pre, k_in, s=1.0).to(torch.bfloat16)
        f = lambda: mm.matmul(a, w)  # noqa: E731
        p = lambda: mm.matmul_plain(a, w)  # noqa: E731
        want = p()
        record(res, torch, "matmul_i8",
               f"prefill {name} M=2048 K={k_in} N={d}", f(), want,
               rel_tol(want, 1e-3), f, p,
               m_pre * k_in * 2 + w.nbytes() + m_pre * d * 4,
               2 * m_pre * d * k_in, iters=5)

    # --- K2 ---  (bf16 output: one bf16 ulp, 2^-8 relative, plus the
    # GEMM's f32 reorder; 1e-2 of max|out| bounds it)
    g1 = synth_quant(gen, ff, d, dev)
    g2 = synth_quant(gen, ff, d, dev)
    fn2 = randn(d, s=0.05)
    xs = randn(b, d, s=30.0)
    f = lambda: mm.gated_ffn(xs, g1, g2, prologue_norm=fn2)  # noqa: E731
    p = lambda: mm.gated_ffn_plain(xs, g1, g2, prologue_norm=fn2)  # noqa: E731
    want = p()
    record(res, torch, "gated_i8", "decode M=4 K=2304 N=9216 (+prenorm pass)",
           f(),
           want, rel_tol(want, 1e-2), f, p,
           b * d * 4 + 2 * g1.nbytes() + b * ff * 2, 4 * b * ff * d,
           primary=True)
    f = lambda: mm.gated_ffn(a_pre, g1, g2)  # noqa: E731
    p = lambda: mm.gated_ffn_plain(a_pre, g1, g2)  # noqa: E731
    want = p()
    record(res, torch, "gated_i8", "prefill M=2048 K=2304 N=9216", f(), want,
           rel_tol(want, 1e-2), f, p,
           m_pre * d * 2 + 2 * g1.nbytes() + m_pre * ff * 2,
           4 * m_pre * ff * d, iters=5)

    phase_top1(torch, res, x, w_head, fnorm, cfg)

    # --- K4: B=4 over both pools of a seq_len=8192 cache of each kind ---
    heads, kvh, hd = 8, 4, 256
    its = torch.from_numpy(create_inv_timescale(hd)).to(dev)
    rope = da.RopeSpec(its, 0, cfg.query_scale_value())
    pos = torch.tensor([[300], [450], [600], [700]], device=dev)
    valid = torch.tensor([[True], [True], [False], [True]], device=dev)
    qkv = randn(b, (heads + 2 * kvh) * hd, s=2.0)
    caches = {}
    for kind in ("i8", "bf16", "f32"):
        cache = KVCache.create(cfg, b, 8192, kind=kind, local_slack=512,
                               device=dev)
        for pool, sc in ((cache.kv, cache.kv_scale),
                         (cache.kv_local, cache.kv_local_scale)):
            if kind == "i8":
                pool.copy_(torch.randint(-127, 128, pool.shape,
                                         generator=gen, device=dev,
                                         dtype=torch.int8))
                sc.copy_(randn(*sc.shape, s=0.02).abs_())
            else:
                pool.copy_(randn(*pool.shape, s=0.5))
        caches[kind] = cache
    # Tolerance: both compute an exact softmax; exp/sum rounding in another
    # order can move a bf16-rounded probability by one ulp (2^-8), and the
    # output is bf16: 1e-2 of max|out|.  Written rows: the kernel and the
    # plain version round RoPE alike (-fmad=false); i8 codes may move by
    # one, bf16 rows by one bf16 ulp (2^-7 relative), f32 rows by 1e-5.
    for kind, cache in caches.items():
        name = f"decode_attention_{kind}"
        item = cache.kv.element_size()
        for layer, pool_name in ((1, "global ring 8192"),
                                 (0, "local ring 4608")):
            window = cfg.attention_window_sizes[layer]
            ck, cp = cache.copy(), cache.copy()
            f = lambda: da.decode_attention_write_packed(  # noqa: E731
                ck, layer, qkv, pos, window, heads, cfg.att_cap, valid, rope)
            p = lambda: da.decode_attention_write_packed_plain(  # noqa: E731
                cp, layer, qkv, pos, window, heads, cfg.att_cap, valid, rope)
            got, want = f(), p()
            pk, idx, ring = ck.pool(layer)
            pp = cp.pool(layer)[0]
            if kind == "i8":
                code_diff = (pk[:, idx].int() - pp[:, idx].int()).abs()
                row_err = float(code_diff.max())
                row_tol = 1.0
                sc_err = float((ck.pool_scale(layer)
                                - cp.pool_scale(layer)).abs().max())
                print(f"[2] {name} {pool_name}: "
                      f"{int((code_diff > 0).sum())} pool codes one off, "
                      f"scale max err {sc_err:.3g}", flush=True)
            else:
                a, w = pk[:, idx].float(), pp[:, idx].float()
                rel = 2 ** -7 if kind == "bf16" else 1e-5
                row_err = float(((a - w).abs() - rel * w.abs()).max())
                row_tol = 1e-6
                print(f"[2] {name} {pool_name}: written rows max excess "
                      f"over {rel:.3g} relative {row_err:.3g}", flush=True)
            if row_err > row_tol:
                fail(f"{name} [{pool_name}]: written rows differ from the "
                     f"plain version's ({row_err} > {row_tol})")
            live = sum(min(int(q) + 1, window, ring) for q in pos[:, 0])
            row_bytes = 2 * hd * item + (8 if kind == "i8" else 0)
            nbytes = (live * kvh * row_bytes + qkv.numel() * 4
                      + b * heads * hd * 2 + b * kvh * row_bytes)
            record(res, torch, name,
                   f"B=4 {pool_name} live {live} rows (1 invalid slot)", got,
                   want, rel_tol(want, 1e-2), f, p, nbytes,
                   4 * live * (heads // kvh) * kvh * hd, primary=layer == 1)

    # --- K5: the two 512-token prefill rounds (positions 0..511, then
    # 512..1023) on both pools of each kind.  Tolerance: the exact softmax
    # of both, probabilities rounded to bf16 alike (i8, bf16 pools: 1e-2 of
    # max|out| covers a flipped bf16 probability) or not at all (f32:
    # summation order only, 1e-4). ---
    t = 512
    q = randn(b, t, heads, hd, s=0.1)
    for kind, cache in caches.items():
        name = f"flash_attention_{kind}"
        item = cache.kv.element_size()
        for start in (0, 512):
            positions = (torch.arange(t, device=dev) + start)[None].repeat(b, 1)
            for layer, pool_name in ((1, "global"), (0, "local")):
                window = cfg.attention_window_sizes[layer]
                f = lambda: fa.flash_prefill_attention(  # noqa: E731
                    cache, layer, q, positions, window, cfg.att_cap)
                p = lambda: fa.flash_prefill_attention_plain(  # noqa: E731
                    cache, layer, q, positions, window, cfg.att_cap)
                want = p()
                ring = cache.pool(layer)[2]
                pairs = int(attention_mask(positions, ring, window).sum()) \
                    * heads
                row_bytes = 2 * hd * item + (8 if kind == "i8" else 0)
                nbytes = (2 * q.numel() * 4
                          + b * kvh * min(start + t, ring) * row_bytes)
                record(res, torch, name,
                       f"B=4 T=512 at pos {start} {pool_name} pool", f(),
                       want, rel_tol(want, 1e-4 if kind == "f32" else 1e-2),
                       f, p, nbytes, 4 * pairs * hd, iters=5,
                       primary=(start, layer) == (512, 1))
    return res


def phase_top1(torch, res, x, w_head, fnorm, cfg):
    """K3 at the decode head's shape: M=4, N=256000, K=2304, i8, with the
    final-norm prologue; need_prob on and off, an allowed mask of about
    1/8 of the vocab, and a mask that bans every column.

    Tolerance: tokens equal wherever the plain version's top1-top2 margin
    exceeds 1e-4 of max|logit| (the kernel's logits move by ~1e-6 of it,
    as K1's do; closer pairs are capped ties, which either may break);
    probs within 1e-4 relative (the same exp sum in another order)."""
    from gemma_tpu_torch.ops import matmul as mm

    n = cfg.vocab_size
    gen = torch.Generator(device="cuda").manual_seed(99)
    mask = torch.rand(n, generator=gen, device="cuda") < 0.125
    banned = torch.zeros(n, dtype=torch.bool, device="cuda")
    cases = [("prob", True, None), ("no prob", False, None),
             ("prob, mask 1/8", True, mask),
             ("no prob, mask 1/8", False, mask),
             ("prob, all banned", True, banned)]
    for label, need_prob, allowed in cases:
        kw = dict(final_cap=cfg.final_cap, prologue_norm=fnorm,
                  allowed_mask=allowed, need_prob=need_prob)
        f = lambda: mm.matmul_top1(x, w_head, **kw)  # noqa: E731
        p = lambda: mm.matmul_top1_plain(x, w_head, **kw)  # noqa: E731
        (tok, prob), (want_tok, want_prob) = f(), p()
        logits = mm.matmul_plain(x, w_head, prologue_norm=fnorm)
        if need_prob:
            logits = cfg.final_cap * torch.tanh(logits / cfg.final_cap)
        if allowed is not None:
            logits = logits.masked_fill(~allowed, float("-inf"))
        top2 = logits.topk(2, dim=-1).values
        scale = float(logits[torch.isfinite(logits)].abs().max()) \
            if bool(torch.isfinite(logits).any()) else 1.0
        clear = (top2[:, 0] - top2[:, 1]) > 1e-4 * scale
        if allowed is banned:
            clear = torch.ones_like(clear)
            if not (bool((tok == 0).all()) and bool((want_tok == 0).all())):
                fail(f"top1_i8 [{label}]: a row with no allowed column "
                     f"gave tokens {tok.tolist()} / {want_tok.tolist()}")
        bad = int(((tok != want_tok) & clear).sum())
        print(f"[2] top1_i8 {label}: tokens {tok.tolist()} (plain "
              f"{want_tok.tolist()}), {int(clear.sum())} rows with a clear "
              f"margin, {bad} differ", flush=True)
        if bad or not bool(clear.any()):
            fail(f"top1_i8 [{label}]: tokens differ from the plain version")
        nbytes = (x.numel() * 4 + fnorm.numel() * 4 + w_head.nbytes()
                  + (n if allowed is not None else 0) + 2 * x.shape[0] * 4)
        record(res, torch, "top1_i8",
               f"M=4 K=2304 N=256000 (+prenorm pass), {label}", prob,
               want_prob, 1e-4 * float(want_prob.abs().max()), f, p, nbytes,
               2 * x.shape[0] * n * x.shape[1], iters=5,
               primary=label == "prob")
    # The block count is a tuning constant: more blocks lengthen the last
    # block's serial merge of their states, fewer leave SMs idle.
    # A batch above 16 rows takes a second row of blocks (grid.y = 2).
    x20 = torch.randn(20, x.shape[1], generator=gen, device="cuda") * 30
    tok, prob = mm.matmul_top1(x20, w_head, final_cap=cfg.final_cap,
                               prologue_norm=fnorm)
    want_tok, want_prob = mm.matmul_top1_plain(
        x20, w_head, final_cap=cfg.final_cap, prologue_norm=fnorm)
    logits = mm.matmul_plain(x20, w_head, prologue_norm=fnorm)
    top2 = (cfg.final_cap * torch.tanh(logits / cfg.final_cap)).topk(2).values
    clear = (top2[:, 0] - top2[:, 1]) > 1e-4 * float(top2.abs().max())
    bad = int(((tok != want_tok) & clear).sum())
    err = float(((prob - want_prob).abs() / want_prob).max())
    print(f"[2] top1_i8 M=20: {bad} of {int(clear.sum())} tokens with a "
          f"clear margin differ, prob max relative err {err:.3g} (tol 1e-4)",
          flush=True)
    if bad or not bool(clear.any()) or err > 1e-4:
        fail("top1_i8 [M=20] disagrees with its plain version")

    def head():
        return mm.matmul_top1(x, w_head, final_cap=cfg.final_cap,
                              prologue_norm=fnorm)

    chosen = mm.TOP1_BLOCKS
    sweep = []
    for blocks in (264, 528, 1056, 2112, 4224):
        mm.TOP1_BLOCKS = blocks
        sweep.append(f"{blocks}: {time_ms(torch, head, 5):.4f}")
    mm.TOP1_BLOCKS = chosen
    print(f"[2] top1_i8 prob, ms by TOP1_BLOCKS (the port uses {chosen}): "
          f"{', '.join(sweep)}", flush=True)


def phase_two_layers(torch):
    """2 layers at Gemma2-2B width: kernels on the card vs plain on the CPU."""
    import dataclasses

    from gemma_tpu_torch.models.configs import config_gemma2_2b
    from gemma_tpu_torch.models.gemma import forward
    from gemma_tpu_torch.models.kv_cache import KVCache
    from gemma_tpu_torch.utils.synth import synth_params

    cfg = config_gemma2_2b()
    cfg = dataclasses.replace(cfg, num_layers=2,
                              layer_configs=cfg.layer_configs[:2],
                              attention_window_sizes=[64, 8192])
    params = synth_params(cfg, seed=7, device="cuda")
    params_cpu = _to_device(params, "cpu")
    gen = torch.Generator().manual_seed(7)
    t = 96
    tokens = torch.randint(2, cfg.vocab_size, (1, t), generator=gen)
    logits = {}
    for dev, prm in (("cuda", params), ("cpu", params_cpu)):
        cache = KVCache.create(cfg, 1, 8192, kind="i8", local_slack=256,
                               device=dev)
        pos = torch.arange(t - 1)[None]
        forward(prm, tokens[:, :-1].to(dev), pos.to(dev), cache, cfg,
                return_logits="none")
        out, _ = forward(prm, tokens[:, -1:].to(dev),
                         torch.tensor([[t - 1]], device=dev), cache, cfg,
                         return_logits="last")
        logits[dev] = out.float().cpu()
    if not torch.isfinite(logits["cuda"]).all():
        fail("2-layer model: non-finite logits on the card")
    err = float((logits["cuda"] - logits["cpu"]).abs().max())
    scale = float(logits["cpu"].abs().max())
    # i8-KV full-forward tolerance of the JAX suite (test_parity_full.py).
    tol = 2e-2 * scale
    print(f"[3] 2-layer full-width prefill {t - 1} + decode 1: card vs CPU "
          f"plain last-logit max_abs_err {err:.4g} (tol {tol:.4g}, "
          f"max|logit| {scale:.4g})", flush=True)
    if err > tol:
        fail("2-layer model disagrees between the card and the CPU")
    two_layer_chunks(torch, cfg, params, params_cpu, tokens[0].tolist())


def two_layer_chunks(torch, cfg, params, params_cpu, prompt,
                     new_tokens: int = 8):
    """generate_batch with the default RuntimeConfig (bf16 KV,
    decode_chunk=4) on the card and on the CPU.  Logit tolerance: 5e-3 of
    max|logit|, the CPU suite's bound between the port's paths (the i8
    check above measures the card-vs-CPU gap).  Tokens must agree up to
    the first step whose CPU teacher-forced top1-top2 margin is within
    twice it; probs within twice it in log space (log p = -log sum
    exp(x - max) moves by at most twice the logit error)."""
    import math

    from gemma_tpu_torch.engine import GemmaEngine, RuntimeConfig
    from gemma_tpu_torch.models.gemma import forward

    out = {}
    for dev, prm in (("cuda", params), ("cpu", params_cpu)):
        engine = GemmaEngine(prm, cfg, RuntimeConfig(seq_len=8192),
                             device=dev)
        probs = []
        toks = engine.generate_batch(
            [prompt], max_generated_tokens=new_tokens,
            stream_token=lambda q, p, t, pr: probs.append(pr) or True)[0]
        out[dev] = (toks, probs[len(prompt):])
    (tc, pc), (tk, pk) = out["cpu"], out["cuda"]
    seq = prompt + tc
    engine = GemmaEngine(params_cpu, cfg, RuntimeConfig(seq_len=8192),
                         device="cpu")
    logits, _ = forward(params_cpu, torch.tensor([seq]),
                        torch.arange(len(seq))[None], engine.new_cache(1),
                        cfg, return_logits="all")
    logit_tol = 5e-3 * float(logits.abs().max())
    top2 = logits[0, len(prompt) - 1:-1].topk(2, dim=-1).values
    clear = int(((top2[:, 0] - top2[:, 1]) > 2 * logit_tol).long().cumprod(0)
                .sum())
    err = max(abs(math.log(a) - math.log(b)) for a, b in
              zip(pk[:clear], pc[:clear])) if clear else 0.0
    print(f"[3] 2-layer generate_batch, bf16 KV, decode_chunk=4: card "
          f"{tk}, CPU {tc}; {clear} steps with a clear margin, log-prob "
          f"max err {err:.4g} (tol {2 * logit_tol:.4g})", flush=True)
    if tk[:clear] != tc[:clear] or err > 2 * logit_tol or not clear:
        fail("2-layer decode chunks disagree between the card and the CPU")


# The device functions of each counted kernel, as the profiler names them
# (mm_i8_kernel's last template argument is GATED; the attention kernels
# carry their pool type in their names).
def _port_kernel(device_name: str) -> str | None:
    if device_name.startswith("void mm_i8_kernel<"):
        return "gated_i8" if "true>" in device_name else "matmul_i8"
    for fn, name in (("prenorm_kernel(", "matmul_i8_prenorm"),
                     ("postnorm_add_kernel(", "matmul_i8_postnorm_add"),
                     ("top1_i8_kernel(", "top1_i8")):
        if fn in device_name:
            return name
    for kind in ("i8", "bf16", "f32"):
        for op in ("decode_attention", "flash_attention"):
            if f"{op}_{kind}_kernel<" in device_name:
                return f"{op}_{kind}"
    return None


def profile_chunks(torch, engine, prompts, chunks: int = 2, k: int = 4):
    """Device time by kernel over `chunks` decode chunks of k steps
    (torch.profiler), beside the host wall time of the same chunks: the
    device's idle share.  The profiler's own count of each kernel's
    device launches must equal what the launch counters gained over the
    same chunks.  One more chunk then runs with CUDA's sync debug mode
    set to error: a host sync inside a chunk fails the run."""
    from torch.profiler import ProfilerActivity, profile

    from gemma_tpu_torch.ops import _cuda

    cache = engine.new_cache(len(prompts))
    cache, last = engine.prefill(prompts, cache)
    prev = torch.tensor(last, dtype=torch.int32, device="cuda")
    pos = torch.tensor([len(p) - 1 for p in prompts], dtype=torch.int32,
                       device="cuda")
    torch.cuda.synchronize()
    before = {kn.name: kn.launches for kn in _cuda.all_kernels()}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        for _ in range(chunks):
            toks, _ = engine._decode_steps(prev, pos, cache, k)
            prev, pos = toks[:, -1].contiguous(), pos + k
        torch.cuda.synchronize()
        wall = (time.monotonic() - t0) * 1e3
    counted = {kn.name: kn.launches - before[kn.name]
               for kn in _cuda.all_kernels()}
    kern = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    seen = {name: 0 for name in counted}
    for e in kern:
        name = _port_kernel(e.key)
        if name is not None:
            seen[name] += e.count
    steps = chunks * k
    print(f"[4A] {chunks} chunks of {k}: launches by counter "
          f"{json.dumps(counted)}, by profiler {json.dumps(seen)}",
          flush=True)
    if seen != counted:
        fail("the launch counters disagree with the profiler's device trace")
    busy = sum(e.self_device_time_total for e in kern) / 1e3
    print(f"[4A] decode profile, {steps} steps in chunks of {k}: host wall "
          f"{wall / steps:.3f} ms/step, device busy {busy / steps:.3f} "
          f"ms/step, idle share {1 - busy / wall:.3f}", flush=True)
    for e in sorted(kern, key=lambda e: -e.self_device_time_total)[:10]:
        print(f"[4A]   {e.self_device_time_total / 1e3 / steps:9.4f} ms/step "
              f"{e.count / steps:6.2f}/step  {e.key[:90]}", flush=True)
    torch.cuda.set_sync_debug_mode("error")
    try:
        engine._decode_steps(prev, pos, cache, k)
    except RuntimeError as e:
        fail(f"a decode chunk synchronized with the host: {e}")
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    print(f"[4A] one chunk of {k} under sync debug mode 'error': no host "
          "sync", flush=True)


def _to_device(params, dev):
    import dataclasses

    from gemma_tpu_torch.ops.matmul import QuantTensor

    def mv(x):
        if x is None:
            return None
        if isinstance(x, QuantTensor):
            return dataclasses.replace(
                x, arrays={k: v.to(dev) for k, v in x.arrays.items()})
        return x.to(dev)

    layers = [type(lp)(**{f.name: mv(getattr(lp, f.name))
                          for f in dataclasses.fields(lp)})
              for lp in params.layers]
    return type(params)(embedding=mv(params.embedding),
                        final_norm=mv(params.final_norm), layers=layers)


def counted_run(torch, fn):
    """fn() with every launch count zeroed just before and read just after,
    and every plain version made to raise meanwhile: (fn(), counts)."""
    from gemma_tpu_torch.ops import _cuda
    from gemma_tpu_torch.ops import decode_attention as da
    from gemma_tpu_torch.ops import flash_attention as fa
    from gemma_tpu_torch.ops import matmul as mm

    plain = {(mm, "matmul_plain"), (mm, "gated_ffn_plain"),
             (mm, "postnorm_add_plain"), (mm, "prenorm_plain"),
             (mm, "matmul_top1_plain"),
             (da, "decode_attention_write_packed_plain"),
             (fa, "flash_prefill_attention_plain")}
    saved = {(mod, n): getattr(mod, n) for mod, n in plain}

    def forbidden(*a, **k):
        raise AssertionError("the main path reached a plain version")

    kernels = _cuda.all_kernels()
    for mod, n in plain:
        setattr(mod, n, forbidden)
    try:
        for kn in kernels:
            kn.launches = 0
        out = fn()
        torch.cuda.synchronize()
        counts = {kn.name: kn.launches for kn in kernels}
    finally:
        for (mod, n), f in saved.items():
            setattr(mod, n, f)
    return out, counts


def check_counts(label, counts, want):
    want = {name: want.get(name, 0) for name in counts}
    print(f"[{label}] launches {json.dumps(counts)}", flush=True)
    if counts != want:
        fail(f"path {label}: launch counts {counts} != schedule {want}")


def timed_runs(torch, engine, prompts, new_tokens, label, first):
    """Two more runs of the same requests; medians over the three."""
    from gemma_tpu_torch.engine import TimingInfo

    timings = [first]
    for _ in range(2):
        timings.append(TimingInfo())
        engine.generate_batch(prompts, max_generated_tokens=new_tokens,
                              timing_info=timings[-1])
    for i, tm in enumerate(timings):
        print(f"[{label}] run {i}: prefill {tm.prefill_tokens} tokens in "
              f"{tm.prefill_duration:.4f} s = "
              f"{tm.prefill_tokens_per_second:.1f} tok/s; decode "
              f"{tm.generated_tokens} tokens in {tm.generate_duration:.4f} s "
              f"= {tm.generate_tokens_per_second:.1f} tok/s", flush=True)
    step_ms = sorted(x * 1e3 for tm in timings for x in tm.decode_step_seconds)
    print(f"[{label}] median of 3 runs (batch {len(prompts)}): prefill "
          f"{_med([t.prefill_tokens_per_second for t in timings]):.1f} tok/s, "
          f"decode {_med([t.generate_tokens_per_second for t in timings]):.1f}"
          f" tok/s; decode step wall median {_med(step_ms):.3f} ms, p90 "
          f"{step_ms[int(0.9 * len(step_ms))]:.3f} ms over {len(step_ms)} "
          "chunk entries", flush=True)


def _med(v):
    return sorted(v)[len(v) // 2]


def check_first_tokens(torch, engine, prompts, outs, cfg, label):
    """Each request's first decoded token equals the argmax of a
    prefill-only forward's last logits wherever their top1-top2 margin
    exceeds the i8-KV logit tolerance of test_parity_full.py (2e-2 of
    max|logit|); the decode step's own logits differ from those by the
    path's rounding, not by more."""
    from gemma_tpu_torch.models.gemma import forward

    checked = 0
    for qi, p in enumerate(prompts):
        ref, _ = forward(engine.params, torch.tensor([p], device="cuda"),
                         torch.arange(len(p), device="cuda")[None],
                         engine.new_cache(1), cfg, return_logits="last")
        top2 = ref[0].topk(2)
        margin = float(top2.values[0] - top2.values[1])
        tol = 2e-2 * float(ref.abs().max())
        print(f"[{label}] request {qi} ({len(p)} tokens): first token "
              f"{outs[qi][0]}, prefill argmax {int(top2.indices[0])}, "
              f"margin {margin:.4g} (tol {tol:.4g})", flush=True)
        if margin > tol:
            checked += 1
            if outs[qi][0] != int(top2.indices[0]):
                fail(f"path {label}: request {qi}'s first token disagrees "
                     "with a prefill-only forward")
    if not checked:
        fail(f"path {label}: no request had a clear first-step margin")


def phase_main_path(torch, new_tokens: int = 32) -> dict:
    from gemma_tpu_torch.engine import GemmaEngine, RuntimeConfig, TimingInfo
    from gemma_tpu_torch.models.configs import config_gemma2_2b
    from gemma_tpu_torch.models.gemma import forward
    from gemma_tpu_torch.utils.synth import synth_params

    cfg = config_gemma2_2b()
    L = cfg.num_layers
    t0 = time.monotonic()
    params = synth_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    print(f"[4] Gemma2-2B {L} layers, synthetic i8 weights on the card "
          f"({sum(lp.qkv_cat.nbytes() + lp.att_w.nbytes() + lp.gating1.nbytes() * 2 + lp.linear.nbytes() for lp in params.layers) / 1e9 + params.embedding.nbytes() / 1e9:.2f} GB) "
          f"in {time.monotonic() - t0:.2f} s", flush=True)
    gen = torch.Generator().manual_seed(3)
    lens = (17, 130, 300, 700)
    prompts = [torch.randint(2, cfg.vocab_size, (n,), generator=gen).tolist()
               for n in lens]
    totals: dict = {}

    def add(counts):
        for name, c in counts.items():
            totals[name] = totals.get(name, 0) + c

    def schedule(engine, steps, kind, head_k3, kv="bf16"):
        """Launches per path: prefill rounds run 3 GEMMs, the gated GEMM
        and prefill attention per layer; a decode step 3 GEMMs (+ the i8
        GEMM head on one-step chunks), the gated GEMM, 2 prologue and 2
        epilogue passes per layer (+ the head's prologue), decode
        attention per layer, and the fused head on multi-step chunks."""
        chunk = engine.prefill_chunk(len(prompts), max(lens))
        rounds = -(-(max(lens) - 1) // chunk)
        return {"matmul_i8": rounds * 3 * L + steps * 3 * L
                + (0 if head_k3 else steps),
                "matmul_i8_prenorm": steps * (2 * L + 1),
                "matmul_i8_postnorm_add": steps * 2 * L,
                "gated_i8": (rounds + steps) * L,
                "top1_i8": steps if head_k3 else 0,
                f"decode_attention_{kv}": steps * L,
                f"flash_attention_{kv}": rounds * L}, rounds, chunk

    # --- A: the default RuntimeConfig ---
    engine = GemmaEngine(params, cfg, RuntimeConfig(seq_len=8192))
    rt = engine.runtime
    print(f"[4A] RuntimeConfig: kv_kind {rt.kv_kind}, decode_chunk "
          f"{rt.decode_chunk}, stream_probs {rt.stream_probs}", flush=True)
    engine.generate_batch([p[:40] for p in prompts], max_generated_tokens=6)
    timing = TimingInfo()
    outs, counts = counted_run(torch, lambda: engine.generate_batch(
        prompts, max_generated_tokens=new_tokens, timing_info=timing))
    want, rounds, chunk = schedule(engine, timing.decode_steps, "A", True)
    print(f"[4A] prefill chunk {chunk} x {rounds} rounds, "
          f"{timing.decode_steps} decode steps", flush=True)
    check_counts("4A", counts, want)
    add(counts)
    for qi, o in enumerate(outs):
        if not o or any(not (0 <= tok < cfg.vocab_size) for tok in o):
            fail(f"path A, request {qi}: bad tokens {o}")
    print(f"[4A] first tokens: {[o[:8] for o in outs]}", flush=True)
    timed_runs(torch, engine, prompts, new_tokens, "4A", timing)
    profile_chunks(torch, engine, prompts)
    check_first_tokens(torch, engine, prompts, outs, cfg, "4A")

    # --- B: generate_fast over an i8 KV cache, against generate_batch ---
    engine = GemmaEngine(params, cfg, RuntimeConfig(seq_len=8192,
                                                    kv_kind="i8"))
    engine.generate_fast([p[:40] for p in prompts], 4)
    fast, counts = counted_run(
        torch, lambda: engine.generate_fast(prompts, new_tokens))
    want, _, _ = schedule(engine, new_tokens, "B", True, kv="i8")
    check_counts("4B", counts, want)
    add(counts)
    ref = engine.generate_batch(prompts, max_generated_tokens=new_tokens)
    for qi, o in enumerate(ref):
        if fast[qi, :len(o)].tolist() != o:
            fail(f"path B: generate_fast request {qi} {fast[qi].tolist()} "
                 f"!= generate_batch {o}")
    walls, pre = [], []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.monotonic()
        engine.prefill(prompts, engine.new_cache(len(prompts)))
        torch.cuda.synchronize()
        t1 = time.monotonic()
        engine.generate_fast(prompts, new_tokens)
        torch.cuda.synchronize()
        pre.append(t1 - t0)
        walls.append(time.monotonic() - t1)
    dec = [w - p for w, p in zip(walls, pre)]
    print(f"[4B] generate_fast batch {len(prompts)} x {new_tokens} steps "
          f"(i8 KV): tokens equal generate_batch's; wall median "
          f"{_med(walls):.4f} s, of which prefill {_med(pre):.4f} s; decode "
          f"{len(prompts) * new_tokens / _med(dec):.1f} tok/s "
          f"({_med(dec) / new_tokens * 1e3:.3f} ms/step), medians of 3",
          flush=True)

    # --- C: slice 1's path, i8 KV and one step per dispatch ---
    engine = GemmaEngine(params, cfg, RuntimeConfig(
        seq_len=8192, kv_kind="i8", decode_chunk=1))
    timing = TimingInfo()
    outs, counts = counted_run(torch, lambda: engine.generate_batch(
        prompts, max_generated_tokens=new_tokens, timing_info=timing))
    want, _, _ = schedule(engine, timing.decode_steps, "C", False, kv="i8")
    check_counts("4C", counts, want)
    add(counts)
    timed_runs(torch, engine, prompts, new_tokens, "4C", timing)
    # Decode's first-step logits vs a prefill-only forward over the same
    # tokens (i8-KV tolerance of test_parity_full.py: 2e-2 of max|logit|).
    for qi in (0, 2):
        p = prompts[qi]
        cache = engine.new_cache(1)
        engine.prefill([p], cache)
        dec, _ = forward(params, torch.tensor([[p[-1]]], device="cuda"),
                         torch.tensor([[len(p) - 1]], device="cuda"), cache,
                         cfg, return_logits="last")
        ref, _ = forward(params, torch.tensor([p], device="cuda"),
                         torch.arange(len(p), device="cuda")[None],
                         engine.new_cache(1), cfg, return_logits="last")
        err = float((dec - ref).abs().max())
        tol = 2e-2 * float(ref.abs().max())
        print(f"[4C] request {qi} ({len(p)} tokens): decode-step vs prefill "
              f"last logits max_abs_err {err:.4g} (tol {tol:.4g})",
              flush=True)
        if not torch.isfinite(dec).all() or err > tol:
            fail(f"request {qi}: decode logits disagree with prefill")

    # --- D: an f32 KV cache ---
    engine = GemmaEngine(params, cfg, RuntimeConfig(seq_len=8192,
                                                    kv_kind="f32"))
    timing = TimingInfo()
    outs, counts = counted_run(torch, lambda: engine.generate_batch(
        prompts, max_generated_tokens=8, timing_info=timing))
    want, _, _ = schedule(engine, timing.decode_steps, "D", True, kv="f32")
    check_counts("4D", counts, want)
    add(counts)
    check_first_tokens(torch, engine, prompts, outs, cfg, "4D")
    missing = [name for name, c in totals.items() if c == 0]
    if missing:
        fail(f"kernels no counted path launched: {missing}")
    return totals


if __name__ == "__main__":
    sys.exit(main())
