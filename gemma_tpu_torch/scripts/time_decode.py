"""Decode speed of six serving paths of chip_smoke.py (A: Gemma2-2B with
i8 weights, 26 layers; E: A sampled, top_k 64, temperature 0.8, seed 1;
N: A under GEMMA_SBLOCK_DECODE=1; M: A with an i8 KV cache under
GEMMA_FUSED_DECODE=0, RoPE in torch ops, then K9 and K10; I: Gemma2-27B
with i4 weights, 46 layers; J: Gemma2-9B with nuq4 weights, 42 layers)
for a checkout of the port on the card, so that two checkouts can be
compared in one run:

    python3 gemma_tpu_torch/scripts/time_decode.py [--root DIR] [--runs N]

--root: the checkout whose `gemma_tpu_torch` is imported (default: the one
this file is in); its kernels build under DIR/build/.  Each path is
chip_smoke.py's: synthetic weights made on the card from seed 0, the
default RuntimeConfig (bf16 KV but on M, chunks of 4 decode steps), batch 4 with
prompts of 17, 130, 300 and 700 tokens.  Per path: `--runs` calls of
generate_batch with 16 new tokens after a warm-up, each one's decode
tok/s (TimingInfo); then two chunks of 4 decode steps under
torch.profiler: the host wall per step, and per step the device time and
the number of device activities (kernels, copies, sets) by kernel: the
decode GEMMs (K1, K2: any kernel of the decode tile), the heads (K3; K6
with its selection), decode attention (K4, K8, K11; on M the row write K9
and the attention K10), the prologue pass and the rest (the draw, the
torch ops).  Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time


CLASSES = (("top1_", "K3"), ("topk_", "K6"), ("decode_sblocked_", "K11"),
           ("decode_attention_", "K4"), ("decode_write_attend_", "K8"),
           ("kv_write_", "K9"), ("decode_attend_", "K10"),
           ("prenorm_kernel", "prenorm"))


SWITCHES = ("GEMMA_SBLOCK_DECODE", "GEMMA_FUSED_DECODE")


def kernel_class(name: str) -> str:
    if name.startswith("void mm_") and "_kernel<" in name:
        return "K2" if "true>" in name else "K1"
    for key, cls in CLASSES:
        if key in name:
            return cls
    return "other"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))
    ap.add_argument("--runs", type=int, default=5)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch
    from torch.profiler import ProfilerActivity, profile

    from gemma_tpu_torch.engine import GemmaEngine, RuntimeConfig, TimingInfo
    from gemma_tpu_torch.models.configs import (config_gemma2_2b,
                                                config_gemma2_9b,
                                                config_gemma2_27b)
    from gemma_tpu_torch.utils.synth import synth_params

    if not torch.cuda.is_available():
        raise SystemExit("time_decode times the card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    res = {"root": root, "card": card}
    gen = torch.Generator().manual_seed(3)
    sampled = dict(top_k=64, temperature=0.8, seed=1)
    params = None
    for label, config, kind, extra, env in (
            ("A", config_gemma2_2b(), "i8", {}, {}),
            ("E", config_gemma2_2b(), "i8", sampled, {}),
            ("N", config_gemma2_2b(), "i8", {}, {"GEMMA_SBLOCK_DECODE": "1"}),
            ("M", config_gemma2_2b(), "i8", {"kv_kind": "i8"},
             {"GEMMA_FUSED_DECODE": "0"}),
            ("I", config_gemma2_27b(), "i4", {}, {}),
            ("J", config_gemma2_9b(), "nuq4", {}, {})):
        for name in SWITCHES:
            os.environ.pop(name, None)
        os.environ.update(env)
        if label not in ("E", "N", "M"):  # E, N and M reuse A's weights
            params = synth_params(config, kind=kind, seed=0, device="cuda")
        engine = GemmaEngine(params, config,
                             RuntimeConfig(seq_len=8192, **extra))
        prompts = [torch.randint(2, config.vocab_size, (n,),
                                 generator=gen).tolist()
                   for n in (17, 130, 300, 700)]
        engine.generate_batch(prompts, max_generated_tokens=8)
        tok_s = []
        for _ in range(args.runs):
            tm = TimingInfo()
            engine.generate_batch(prompts, max_generated_tokens=16,
                                  timing_info=tm)
            tok_s.append(tm.generate_tokens_per_second)
        cache = engine.new_cache(len(prompts))
        cache, last = engine.prefill(prompts, cache)
        prev = torch.tensor(last, dtype=torch.int32, device="cuda")
        pos = torch.tensor([len(p) - 1 for p in prompts], dtype=torch.int32,
                           device="cuda")
        toks, _ = engine._decode_steps(prev, pos, cache, 4)
        prev, pos = toks[:, -1].contiguous(), pos + 4
        torch.cuda.synchronize()
        steps = 8
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.monotonic()
            for _ in range(steps // 4):
                toks, _ = engine._decode_steps(prev, pos, cache, 4)
                prev, pos = toks[:, -1].contiguous(), pos + 4
            torch.cuda.synchronize()
            wall = (time.monotonic() - t0) * 1e3
        device = dict.fromkeys(["K1", "K2", *(c for _, c in CLASSES),
                                "other"], 0.0)
        count = dict.fromkeys(device, 0)
        for e in prof.key_averages():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                device[kernel_class(e.key)] += e.self_device_time_total / 1e3
                count[kernel_class(e.key)] += e.count
        res[label] = {
            "tok_s": tok_s,
            "host_wall_ms_per_step": wall / steps,
            "device_ms_per_step": {k: v / steps for k, v in device.items()},
            "device_activities_per_step": {
                k: v / steps for k, v in count.items()},
        }
        del engine, cache
        if label not in ("A", "E", "N"):
            params = None
        torch.cuda.empty_cache()
    for name in SWITCHES:
        os.environ.pop(name, None)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
