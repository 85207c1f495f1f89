"""Device time of one 2048-row prefill round of path A, by kernel, on the
card (torch.profiler), for a checkout of the port, so that two checkouts
can be compared in one run:

    python3 gemma_tpu_torch/scripts/profile_prefill.py [--root DIR]

--root: the checkout whose `gemma_tpu_torch` is imported (default: the one
this file is in); its kernels build under DIR/build/.  The model is
chip_smoke.py's path A: Gemma2-2B at 26 layers, synthetic i8 weights
made on the card from seed 0, the default RuntimeConfig (bf16 KV).  Four
prompts of 513 tokens make exactly one prefill round of 4 x 512 = 2048
rows.  After two warm-up prefills, one is profiled; its device kernels
are summed by what they are: K1 by shape (a round launches them per
layer in the order qkv, att_w, linear), K2, K5 (prefill attention), and
every other kernel (the torch ops: norms, RoPE, casts, the cache write)
by name.  Then the wall time of three more prefills (host clock around a
synchronized call), median.  Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time


def classify(name: str) -> str | None:
    """The port's GEMM and attention kernels (any weight kind, either
    tile), or None for a torch op's kernel."""
    for prefix in ("void mm_sm90_", "void mm_"):
        if name.startswith(prefix) and "_kernel<" in name:
            if "stacked" in name:
                return None
            return "K2" if "true>" in name else "K1"
    if "flash_attention_" in name:
        return "K5"
    return None


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch
    from torch.profiler import ProfilerActivity, profile

    from gemma_tpu_torch.engine import GemmaEngine, RuntimeConfig
    from gemma_tpu_torch.models.configs import config_gemma2_2b
    from gemma_tpu_torch.utils.synth import synth_params

    if not torch.cuda.is_available():
        raise SystemExit("profile_prefill profiles the card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    cfg = config_gemma2_2b()
    params = synth_params(cfg, seed=0, device="cuda")
    engine = GemmaEngine(params, cfg, RuntimeConfig(seq_len=8192))
    gen = torch.Generator().manual_seed(3)
    prompts = [torch.randint(2, cfg.vocab_size, (513,), generator=gen).tolist()
               for _ in range(4)]
    chunk = engine.prefill_chunk(len(prompts), 513)
    if chunk != 512:
        raise SystemExit(f"expected one round of 512, the chunk is {chunk}")

    def run():
        engine.prefill(prompts, engine.new_cache(len(prompts)))
        torch.cuda.synchronize()

    for _ in range(2):
        run()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
    events = sorted(
        (e for e in prof.profiler.kineto_results.events()
         if e.device_type() == torch.autograd.DeviceType.CUDA),
        key=lambda e: e.start_ns())
    shapes = ("qkv", "att_w", "linear")
    groups: dict[str, list[float]] = {}
    others: dict[str, list[float]] = {}
    k1 = 0
    for e in events:
        ms = e.duration_ns() / 1e6
        kind = classify(e.name())
        if kind == "K1":
            kind = f"K1 {shapes[k1 % 3]}"
            k1 += 1
        if kind is None:
            others.setdefault(e.name()[:100], []).append(ms)
        else:
            groups.setdefault(kind, []).append(ms)
    walls = []
    for _ in range(3):
        t0 = time.monotonic()
        run()
        walls.append(time.monotonic() - t0)
    busy = sum(e.duration_ns() for e in events) / 1e6
    res = {
        "root": root, "card": card, "rows": len(prompts) * chunk,
        "device_ms": busy,
        "wall_ms_median": sorted(walls)[1] * 1e3,
        "kernels": {k: {"launches": len(v), "ms": sum(v)}
                    for k, v in sorted(groups.items())},
        "torch_ops_ms": sum(sum(v) for v in others.values()),
        "torch_ops": {k: {"launches": len(v), "ms": sum(v)}
                      for k, v in sorted(others.items(),
                                         key=lambda kv: -sum(kv[1]))[:12]},
    }
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
