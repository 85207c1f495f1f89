#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`gemma_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py            # every phase, one card

Phases (any failure exits non-zero before the result line):
  1. device: nvidia-smi name and power limit, torch/CUDA versions, and the
     build of every kernel in gemma_tpu_torch/csrc (parallel nvcc), timed;
  2. kernels vs their plain PyTorch versions on the card, at the shapes of
     the serving path (Gemma2-2B, batch 4), each error printed beside its
     tolerance, each timed with CUDA events over a CUDA graph beside its
     plain version and its bound (bytes over 3.35 TB/s or operations over
     989 TFLOP/s bf16, the H100 SXM data-sheet peaks);
  3. a 2-layer model at Gemma2-2B width (synthetic i8 weights, i8 KV):
     prefill + one decode step on the card through the kernels vs the
     plain path on the CPU, last logits within the stated tolerance;
  4. the main path: Gemma2-2B at full depth, synthetic i8 weights made on
     the card, RuntimeConfig(seq_len=8192, kv_kind="i8", decode_chunk=1,
     top_k=1); `GemmaEngine.generate_batch` answers 4 ragged requests
     (17, 130, 300, 700 prompt tokens, 32 new tokens each).  Every kernel
     launch count is zeroed before and read after, checked against the
     per-layer schedule, and the plain versions are made to raise during
     the run; a few decode steps under torch.profiler must show the same
     launches per kernel as the counts; decode's first-step logits are
     checked against a prefill-only forward;
  5. one `kernels` JSON line, then nvidia-smi's line, then the result line.

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
    "decode_attention_i8":
        "gemma_tpu/ops/decode_attention.py:545 (_decode_fused_packed_kernel)",
    "flash_attention_i8": "gemma_tpu/ops/flash_attention.py:39 (_flash_kernel)",
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
    "decode_attention_i8": "scaled_dot_product_attention has no i8 per-row "
                           "scales, ring mask, soft cap or in-place row write",
    "flash_attention_i8": "scaled_dot_product_attention has no i8 per-row "
                          "scales or soft cap",
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

    # --- K4: B=4 over both pools of a seq_len=8192 i8 cache ---
    heads, kvh, hd = 8, 4, 256
    cache = KVCache.create(cfg, b, 8192, kind="i8", local_slack=512,
                           device=dev)
    for pool, sc in ((cache.kv, cache.kv_scale),
                     (cache.kv_local, cache.kv_local_scale)):
        pool.copy_(torch.randint(-127, 128, pool.shape, generator=gen,
                                 device=dev, dtype=torch.int8))
        sc.copy_(randn(*sc.shape, s=0.02).abs_())
    its = torch.from_numpy(create_inv_timescale(hd)).to(dev)
    rope = da.RopeSpec(its, 0, cfg.query_scale_value())
    pos = torch.tensor([[300], [450], [600], [700]], device=dev)
    valid = torch.tensor([[True], [True], [False], [True]], device=dev)
    qkv = randn(b, (heads + 2 * kvh) * hd, s=2.0)
    # Tolerance: both compute an exact softmax; exp/sum rounding in another
    # order can move a bf16-rounded probability by one ulp (2^-8), and the
    # output is bf16: 1e-2 of max|out|.
    for layer, pool_name in ((1, "global ring 8192"), (0, "local ring 4608")):
        window = cfg.attention_window_sizes[layer]
        ck, cp = cache.copy(), cache.copy()
        f = lambda: da.decode_attention_write_packed(  # noqa: E731
            ck, layer, qkv, pos, window, heads, cfg.att_cap, valid, rope)
        p = lambda: da.decode_attention_write_packed_plain(  # noqa: E731
            cp, layer, qkv, pos, window, heads, cfg.att_cap, valid, rope)
        got, want = f(), p()
        pk, _, ring = ck.pool(layer)
        pp = cp.pool(layer)[0]
        code_diff = (pk.int() - pp.int()).abs()
        n_off = int((code_diff > 0).sum())
        if int(code_diff.max()) > 1:
            fail(f"decode_attention_i8 [{pool_name}]: pool codes differ by "
                 f"{int(code_diff.max())}")
        sc_err = float((ck.pool_scale(layer) - cp.pool_scale(layer)).abs().max())
        print(f"[2] decode_attention_i8 {pool_name}: {n_off} pool codes one "
              f"off, scale max err {sc_err:.3g}", flush=True)
        live = sum(min(int(q) + 1, window, ring) for q in pos[:, 0])
        nbytes = (live * kvh * (2 * hd + 8) + qkv.numel() * 4
                  + b * heads * hd * 2 + b * kvh * 2 * (hd + 4))
        record(res, torch, "decode_attention_i8",
               f"B=4 {pool_name} live {live} rows (1 invalid slot)", got,
               want, rel_tol(want, 1e-2), f, p, nbytes,
               4 * live * (heads // kvh) * kvh * hd, primary=layer == 1)

    # --- K5: the two 512-token prefill rounds (positions 0..511, then
    # 512..1023) on both pools ---
    t = 512
    q = randn(b, t, heads, hd, s=0.1)
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
            pairs = int(attention_mask(positions, ring, window).sum()) * heads
            nbytes = (2 * q.numel() * 4
                      + b * kvh * min(start + t, ring) * (2 * hd + 8))
            record(res, torch, "flash_attention_i8",
                   f"B=4 T=512 at pos {start} {pool_name} pool", f(), want,
                   rel_tol(want, 1e-2), f, p, nbytes, 4 * pairs * hd,
                   iters=5, primary=(start, layer) == (512, 1))
    return res


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


# The device functions of each counted kernel, as the profiler names them
# (mm_i8_kernel's last template argument is GATED).
def _port_kernel(device_name: str) -> str | None:
    if device_name.startswith("void mm_i8_kernel<"):
        return "gated_i8" if "true>" in device_name else "matmul_i8"
    for fn, name in (("prenorm_kernel(", "matmul_i8_prenorm"),
                     ("postnorm_add_kernel(", "matmul_i8_postnorm_add"),
                     ("decode_attention_i8_kernel<", "decode_attention_i8"),
                     ("flash_attention_i8_kernel<", "flash_attention_i8")):
        if fn in device_name:
            return name
    return None


def profile_decode(torch, engine, prompts, cfg, steps: int = 4):
    """Device time by kernel over a few decode steps (torch.profiler), beside
    the host wall time of the same steps: the device's idle share.  The
    profiler's own count of each kernel's device launches must equal what
    the launch counters gained over the same steps."""
    from torch.profiler import ProfilerActivity, profile

    from gemma_tpu_torch.models.gemma import forward
    from gemma_tpu_torch.ops import _cuda
    from gemma_tpu_torch.ops.sampling import top1

    cache = engine.new_cache(len(prompts))
    cache, last = engine.prefill(prompts, cache)
    prev = torch.tensor(last, device="cuda")[:, None]
    pos = torch.tensor([len(p) - 1 for p in prompts], device="cuda")[:, None]
    torch.cuda.synchronize()
    before = {k.name: k.launches for k in _cuda.all_kernels()}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        for _ in range(steps):
            logits, cache = forward(engine.params, prev, pos, cache, cfg,
                                    return_logits="last")
            prev = top1(logits)[0][:, None]
            pos = pos + 1
        torch.cuda.synchronize()
        wall = (time.monotonic() - t0) * 1e3
    counted = {k.name: k.launches - before[k.name] for k in _cuda.all_kernels()}
    kern = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    seen = {name: 0 for name in counted}
    for e in kern:
        name = _port_kernel(e.key)
        if name is not None:
            seen[name] += e.count
    print(f"[4] {steps} decode steps: launches by counter {json.dumps(counted)}"
          f", by profiler {json.dumps(seen)}", flush=True)
    if seen != counted:
        fail("the launch counters disagree with the profiler's device trace")
    busy = sum(e.self_device_time_total for e in kern) / 1e3
    print(f"[4] decode profile, {steps} steps: host wall {wall / steps:.3f} "
          f"ms/step, device busy {busy / steps:.3f} ms/step, idle share "
          f"{1 - busy / wall:.3f}", flush=True)
    for e in sorted(kern, key=lambda e: -e.self_device_time_total)[:10]:
        print(f"[4]   {e.self_device_time_total / 1e3 / steps:9.4f} ms/step "
              f"{e.count // steps:4d}/step  {e.key[:90]}", flush=True)


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


def phase_main_path(torch, new_tokens: int = 32) -> dict:
    from gemma_tpu_torch.engine import GemmaEngine, RuntimeConfig, TimingInfo
    from gemma_tpu_torch.models.configs import config_gemma2_2b
    from gemma_tpu_torch.models.gemma import forward
    from gemma_tpu_torch.ops import _cuda
    from gemma_tpu_torch.ops import decode_attention as da
    from gemma_tpu_torch.ops import flash_attention as fa
    from gemma_tpu_torch.ops import matmul as mm
    from gemma_tpu_torch.utils.synth import synth_params

    cfg = config_gemma2_2b()
    n_layers = cfg.num_layers
    t0 = time.monotonic()
    params = synth_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    print(f"[4] Gemma2-2B {n_layers} layers, synthetic i8 weights on the card "
          f"({sum(lp.qkv_cat.nbytes() + lp.att_w.nbytes() + lp.gating1.nbytes() * 2 + lp.linear.nbytes() for lp in params.layers) / 1e9 + params.embedding.nbytes() / 1e9:.2f} GB) "
          f"in {time.monotonic() - t0:.2f} s", flush=True)
    rt = RuntimeConfig(seq_len=8192, kv_kind="i8", decode_chunk=1, top_k=1)
    engine = GemmaEngine(params, cfg, rt)
    gen = torch.Generator().manual_seed(3)
    lens = (17, 130, 300, 700)
    prompts = [torch.randint(2, cfg.vocab_size, (n,), generator=gen).tolist()
               for n in lens]
    # Warm-up request (first launches, allocator), then the counted run.
    engine.generate_batch([p[:40] for p in prompts], max_generated_tokens=2)

    plain = {(mm, "matmul_plain"), (mm, "gated_ffn_plain"),
             (mm, "postnorm_add_plain"),
             (da, "decode_attention_write_packed_plain"),
             (fa, "flash_prefill_attention_plain")}
    saved = {(mod, n): getattr(mod, n) for mod, n in plain}

    def forbidden(*a, **k):
        raise AssertionError("the main path reached a plain version")

    kernels = _cuda.all_kernels()
    for mod, n in plain:
        setattr(mod, n, forbidden)
    try:
        for k in kernels:
            k.launches = 0
        timing = TimingInfo()
        outs = engine.generate_batch(prompts, max_generated_tokens=new_tokens,
                                     timing_info=timing)
        torch.cuda.synchronize()
        counts = {k.name: k.launches for k in kernels}
    finally:
        for (mod, n), fn in saved.items():
            setattr(mod, n, fn)

    chunk = engine.prefill_chunk(len(prompts), max(lens))
    rounds = -(-(max(lens) - 1) // chunk)
    steps = timing.decode_steps
    L = n_layers
    want = {"matmul_i8": rounds * 3 * L + steps * (3 * L + 1),
            "matmul_i8_prenorm": steps * (2 * L + 1),
            "matmul_i8_postnorm_add": steps * 2 * L,
            "gated_i8": (rounds + steps) * L,
            "decode_attention_i8": steps * L,
            "flash_attention_i8": rounds * L}
    print(f"[4] prefill chunk {chunk} x {rounds} rounds, {steps} decode "
          f"steps; launches {json.dumps(counts)}", flush=True)
    if counts != want:
        fail(f"launch counts {counts} != schedule {want}")
    for qi, o in enumerate(outs):
        if not o or any(not (0 <= tok < cfg.vocab_size) for tok in o):
            fail(f"request {qi}: bad tokens {o}")
    # The same request twice more: host-clock times vary from run to run
    # on a shared host, so report medians over the three runs.
    timings = [timing]
    for _ in range(2):
        timings.append(TimingInfo())
        engine.generate_batch(prompts, max_generated_tokens=new_tokens,
                              timing_info=timings[-1])
    for i, tm in enumerate(timings):
        print(f"[4] run {i}: prefill {tm.prefill_tokens} tokens in "
              f"{tm.prefill_duration:.4f} s = "
              f"{tm.prefill_tokens_per_second:.1f} tok/s; decode "
              f"{tm.generated_tokens} tokens in {tm.generate_duration:.4f} s "
              f"= {tm.generate_tokens_per_second:.1f} tok/s", flush=True)
    step_ms = sorted(x * 1e3 for tm in timings for x in tm.decode_step_seconds)
    med = lambda v: sorted(v)[len(v) // 2]  # noqa: E731
    print(f"[4] median of 3 runs (batch 4): prefill "
          f"{med([t.prefill_tokens_per_second for t in timings]):.1f} tok/s, "
          f"decode {med([t.generate_tokens_per_second for t in timings]):.1f}"
          f" tok/s; decode step wall median {med(step_ms):.3f} ms, p90 "
          f"{step_ms[int(0.9 * len(step_ms))]:.3f} ms over {len(step_ms)} "
          "steps", flush=True)
    print(f"[4] first tokens: {[o[:8] for o in outs]}", flush=True)

    profile_decode(torch, engine, prompts, cfg)

    # Decode's first-step logits vs a prefill-only forward over the same
    # tokens (i8-KV tolerance of test_parity_full.py: 2e-2 of max|logit|).
    for qi in (0, 2):
        p = prompts[qi]
        cache = engine.new_cache(1)
        engine.prefill([p], cache)
        dec, _ = forward(params, torch.tensor([[p[-1]]], device="cuda"),
                         torch.tensor([[len(p) - 1]], device="cuda"), cache,
                         cfg, return_logits="last")
        cache = engine.new_cache(1)
        ref, _ = forward(params, torch.tensor([p], device="cuda"),
                         torch.arange(len(p), device="cuda")[None], cache,
                         cfg, return_logits="last")
        err = float((dec - ref).abs().max())
        tol = 2e-2 * float(ref.abs().max())
        print(f"[4] request {qi} ({len(p)} tokens): decode-step vs prefill "
              f"last logits max_abs_err {err:.4g} (tol {tol:.4g})", flush=True)
        if not torch.isfinite(dec).all() or err > tol:
            fail(f"request {qi}: decode logits disagree with prefill")
    return counts


if __name__ == "__main__":
    sys.exit(main())
