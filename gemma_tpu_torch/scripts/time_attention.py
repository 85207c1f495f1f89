"""Time the attention kernels (K4, K5, K8, K9, K10, K11) of a checkout of
the port on the card, so that two checkouts can be compared in one run:

    python3 gemma_tpu_torch/scripts/time_attention.py [--root DIR]

--root: the checkout whose `gemma_tpu_torch` is imported (default: the one
this file is in); its kernels build under DIR/build/.  The shapes are
chip_smoke.py's, on 2-layer cuts (layer 0 local, layer 1 global) of
Gemma2-2B (8 query heads over 4 KV heads of 256), Gemma2-9B (16 over 8 of
256; path J's) and Gemma2-27B (32 over 16 of 128) with seq_len 8192
caches of random rows, batch 4:
  - K4 (decode_attention_write_packed) and K8 (decode_attention_write, RoPE
    in the kernel) at positions 300, 450, 600, 700 with slot 2 invalid,
    and K10 (decode_attention) at the same positions, on the global pool:
    i8, bf16 and f32 pools at 2B, bf16 at 9B and 27B;
  - K11 (decode_attention_write under GEMMA_SBLOCK_DECODE=1) beside K8 on
    the same inputs, at those positions on both pools (where
    `pick_s_block` takes K11 for the pool: i8 on a seq_len 8191 cache,
    whose global pool has 128-row blocks and whose local one none), and at
    batch 1, position 8000 (8001 live rows) on the global pool;
  - K9 through its wrapper `kv_write_decode` (whatever the checkout runs
    around the kernel: the parent of the raw-row K9 stacked and encoded
    the rows in torch ops first) on the global pool at those positions
    with slot 2 invalid, for i8, bf16 and f32 pools at 2B's and 27B's
    heads: f32 rows as path M has them (k contiguous, RoPE's output; v a
    view into the fused qkv row) and bf16 rows, and the device activities
    (kernels, copies, sets) of one call, by torch.profiler;
  - K5 (flash_prefill_attention) on a 512-token chunk: at positions 0 and
    512 on the global pool, 3584 on the global pool and 4352 on the local
    one (its live range wraps the 4608-row ring), for i8, bf16 and f32
    pools at 2B; at 512 for bf16 at 9B and 27B.
Each is timed as chip_smoke.py times kernels (this file's
`ops/_cuda.time_ms`: CUDA-graph replays between CUDA events).  Prints one
JSON line with the card's name and power limit.
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
    """`ops/_cuda.time_ms` of the checkout this file is in, loaded by path,
    so that both checkouts are timed by the same code."""
    path = Path(__file__).resolve().parents[1] / "ops" / "_cuda.py"
    spec = importlib.util.spec_from_file_location("_time_attention_timer",
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.time_ms


def random_cache(torch, cfg, kind, gen, b=4, seq_len=8192):
    """A cache of `kind` filled with random rows (i8 codes under scales
    |N(0, 0.02)|, else N(0, 0.5)), as chip_smoke.py's."""
    from gemma_tpu_torch.models.kv_cache import KVCache

    cache = KVCache.create(cfg, b, seq_len, kind=kind, local_slack=512,
                           device="cuda")
    for pool, sc in ((cache.kv, cache.kv_scale),
                     (cache.kv_local, cache.kv_local_scale)):
        if kind == "i8":
            pool.copy_(torch.randint(-127, 128, pool.shape, generator=gen,
                                     device="cuda", dtype=torch.int8))
            sc.copy_(torch.randn(*sc.shape, generator=gen,
                                 device="cuda").mul_(0.02).abs_())
        else:
            pool.copy_(torch.randn(*pool.shape, generator=gen,
                                   device="cuda").mul_(0.5))
    return cache


def cut(cfg):
    return dataclasses.replace(
        cfg, num_layers=2, layer_configs=cfg.layer_configs[:2],
        attention_window_sizes=cfg.attention_window_sizes[:2])


def cases(torch, model, cfg, kinds, time_ms, out):
    from gemma_tpu_torch.ops import decode_attention as da
    from gemma_tpu_torch.ops import flash_attention as fa
    from gemma_tpu_torch.ops.ops import create_inv_timescale

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(4242)
    lc = cfg.layer_configs[0]
    heads, kvh, hd, b = lc.heads, lc.kv_heads, lc.qkv_dim, 4
    rope = da.RopeSpec(torch.from_numpy(create_inv_timescale(hd)).to(dev), 0,
                       cfg.query_scale_value())
    pos = torch.tensor([[300], [450], [600], [700]], device=dev)
    valid = torch.tensor([[True], [True], [False], [True]], device=dev)
    qkv = torch.randn(b, (heads + 2 * kvh) * hd, generator=gen,
                      device=dev) * 2
    q_raw = qkv[:, :heads * hd].reshape(b, 1, heads, hd)
    kv_raw = qkv[:, heads * hd:].reshape(b, 1, kvh, 2, hd)
    q_enc = torch.randn(b, 1, heads, hd, generator=gen, device=dev) * 0.1
    q = torch.randn(b, 512, heads, hd, generator=gen, device=dev) * 0.1
    w_glob, w_loc = cfg.attention_window_sizes[1], \
        cfg.attention_window_sizes[0]
    for kind in kinds:
        cache = random_cache(torch, cfg, kind, gen)
        out[f"K4 {kind} {model}"] = time_ms(
            lambda: da.decode_attention_write_packed(
                cache, 1, qkv, pos, w_glob, heads, cfg.att_cap, valid, rope))
        out[f"K8 {kind} {model}"] = time_ms(
            lambda: da.decode_attention_write(
                cache, 1, q_raw, pos, kv_raw[..., 0, :], kv_raw[..., 1, :],
                w_glob, cfg.att_cap, valid, rope))
        out[f"K10 {kind} {model}"] = time_ms(
            lambda: da.decode_attention(cache, 1, q_enc, pos, w_glob,
                                        cfg.att_cap))
        sblocked(torch, da, cfg, kind, model, cache, gen, time_ms, out, rope,
                 q_raw, kv_raw, pos, valid)
        starts = ((0, 1, w_glob), (512, 1, w_glob), (3584, 1, w_glob),
                  (4352, 0, w_loc)) if model == "2B" else ((512, 1, w_glob),)
        for start, layer, window in starts:
            positions = (torch.arange(512, device=dev) + start)[None].repeat(
                b, 1)
            out[f"K5 {kind} {model} pos {start} "
                f"{'global' if layer else 'local'}"] = time_ms(
                lambda: fa.flash_prefill_attention(
                    cache, layer, q, positions, window, cfg.att_cap), 5)
        del cache
        torch.cuda.empty_cache()


def kv_writes(torch, model, cfg, time_ms, out):
    """The K9 wrapper per pool kind (see the module's note), and the
    device activities of one call."""
    from torch.profiler import ProfilerActivity, profile

    from gemma_tpu_torch.ops import decode_attention as da

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(4343)
    lc = cfg.layer_configs[0]
    heads, kvh, hd, b = lc.heads, lc.kv_heads, lc.qkv_dim, 4
    pos = torch.tensor([[300], [450], [600], [700]], device=dev)
    valid = torch.tensor([[True], [True], [False], [True]], device=dev)
    qkv = torch.randn(b, (heads + 2 * kvh) * hd, generator=gen,
                      device=dev) * 2
    kvp = qkv[:, heads * hd:].reshape(b, 1, kvh, 2, hd)
    rows = {"f32": (kvp[..., 0, :].contiguous(), kvp[..., 1, :]),
            "bf16 rows": (kvp[..., 0, :].to(torch.bfloat16),
                          kvp[..., 1, :].to(torch.bfloat16))}
    for kind in ("i8", "bf16", "f32"):
        cache = random_cache(torch, cfg, kind, gen)
        for what, (k, v) in rows.items():
            out[f"K9 {kind} {model} {what}"] = time_ms(
                lambda: da.kv_write_decode(cache, 1, pos, k, v, valid))
            # The device activities (kernels, copies, sets) of one call.
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                da.kv_write_decode(cache, 1, pos, k, v, valid)
                torch.cuda.synchronize()
            out[f"K9 activities {kind} {model} {what}"] = sum(
                e.count for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA)
        del cache
        torch.cuda.empty_cache()


def sblocked(torch, da, cfg, kind, model, cache, gen, time_ms, out, rope,
             q_raw, kv_raw, pos, valid):
    """K11 beside K8 on the same inputs: batch 4 on both pools (i8 on a
    seq_len 8191 cache), batch 1 at position 8000 on the global pool."""
    dev = torch.device("cuda")
    lc = cfg.layer_configs[0]
    if kind == "i8":
        cache = random_cache(torch, cfg, kind, gen, seq_len=8191)
    one = random_cache(torch, cfg, kind, gen, b=1,
                       seq_len=8191 if kind == "i8" else 8192)
    q1 = torch.randn(1, 1, lc.heads, lc.qkv_dim, generator=gen, device=dev)
    kv1 = torch.randn(1, 1, lc.kv_heads, 2, lc.qkv_dim, generator=gen,
                      device=dev)
    cases = [("B4", cache, layer, q_raw, kv_raw, pos, valid)
             for layer in (1, 0)]
    cases.append(("B1 pos 8000", one, 1, q1, kv1,
                  torch.tensor([[8000]], device=dev), None))
    old = os.environ.get("GEMMA_SBLOCK_DECODE")
    try:
        for label, c, layer, q, kv, p, v in cases:
            if da._s_block(c, layer) is None:
                continue
            window = cfg.attention_window_sizes[layer]
            pool = "global" if layer else "local"
            for switch, name in (("1", "K11"), ("0", "K8")):
                os.environ["GEMMA_SBLOCK_DECODE"] = switch
                out[f"{name} {kind} {model} {label} {pool}"] = time_ms(
                    lambda: da.decode_attention_write(
                        c, layer, q, p, kv[..., 0, :], kv[..., 1, :], window,
                        cfg.att_cap, v, rope))
    finally:
        if old is None:
            os.environ.pop("GEMMA_SBLOCK_DECODE", None)
        else:
            os.environ["GEMMA_SBLOCK_DECODE"] = old
    del one


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    from gemma_tpu_torch.models.configs import (config_gemma2_2b,
                                                config_gemma2_9b,
                                                config_gemma2_27b)

    if not torch.cuda.is_available():
        raise SystemExit("time_attention times the kernels on a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    time_ms = own_timer()
    ms: dict = {}
    cases(torch, "2B", cut(config_gemma2_2b()), ("i8", "bf16", "f32"),
          time_ms, ms)
    cases(torch, "9B", cut(config_gemma2_9b()), ("bf16",), time_ms, ms)
    cases(torch, "27B", cut(config_gemma2_27b()), ("bf16",), time_ms, ms)
    kv_writes(torch, "2B", cut(config_gemma2_2b()), time_ms, ms)
    kv_writes(torch, "27B", cut(config_gemma2_27b()), time_ms, ms)
    print(json.dumps({"root": root, "card": card, "ms": ms}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
