#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`gemma_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py            # every phase, one card

Phases (any failure exits non-zero before the result line):
  1. device: nvidia-smi name and power limit, torch/CUDA versions, and the
     build of every kernel in gemma_tpu_torch/csrc (parallel nvcc), timed,
     with the registers and spills of each attention kernel, the decode
     tile, the heads and K13 (-Xptxas -v; a spill in K5, in the Gemma2
     (G = 2) instantiations of K4 / K8 / K10 / K11, in K9, in the decode
     tile of K1 / K2 / K12, in K3, in K6 and its selection or in K13
     fails);
  2. kernels vs their plain PyTorch versions on the card, at the shapes of
     the serving paths (Gemma2-2B, batch 4), each error printed beside its
     tolerance, each timed with CUDA events over a CUDA graph beside its
     plain version, its bound (bytes over 3.35 TB/s or operations over
     989 TFLOP/s bf16, the H100 SXM data-sheet peaks) and, for the dense
     GEMMs, torch.nn.functional.linear on the same inputs: the GEMMs
     with their norms folded in (and the norm passes alone, which the
     prefill tile still chains), the gated GEMM and the
     fused greedy head for i8, sfp, bf16, f32, i4 and nuq4 weights (kind
     nuq runs the sfp kernels),
     the fused top-k head for the same kinds (k_top 2, 64, 128; M = 4 and
     20; an allowed mask; fewer live columns than k_top; saturated ties;
     M = 1, 4, 13, 16 and 20 each repeated bit for bit and two graph
     replays; its values held to the plain version, to the plain head on
     the kernels' own prologue A and against a bf16-A control that must
     fail the limit, `check_topk_values`) with its selection alone as a
     merge; the decode tile of K1 and K2
     (csrc/matmul_decode.cu) for every kind, plain and stacked, at M = 1,
     4, 8, 13 and 16 (`check_decode_rows`: each call repeated bit for bit,
     row 0 alone equal to row 0 in the batch) and one-hot reads
     (`check_one_hot_rows`), and with its norms folded in, plain and
     stacked, at the same row counts, repeats and graph replays bit for
     bit (`check_fused_rows`), and its prologue read back through an
     identity weight bit for bit against the kernels' order of the sum of
     squares, and K6's top 128 of it (`check_prologue_bits`); the greedy
     head at M = 4 and 20
     for every kind, repeated and replayed in a graph bit for bit, its
     prob held to the plain version within a limit that a bf16-A control
     must fail (`check_top1_prob`); the packed kinds once more at the decode
     shapes of Gemma2-27B (i4, nuq4) and Gemma2-9B (nuq4), with a weight
     whose codes encode their column and nuq4 tables of equal, repeated
     and -0.0 entries; the draw kernel; decode attention (K4) and
     prefill attention (K5) over i8, bf16 and f32 KV pools at Gemma2-2B's
     head shape and at Gemma2-27B's (32/16 heads of 128), K5 at positions
     0 and 512, on a chunk whose live range wraps the local ring, at a
     long position (3584) and with per-slot prefixes, each K4 / K5 / K8 /
     K10 case repeated for the same bits (`phase_attention`); and the
     split-weight decode kernels at both head shapes: write + attend
     (in-kernel RoPE, and pre-encoded), the row write alone from raw
     rows (K9: f32 strided views, f32 and bf16 rows, every pool kind,
     bit for bit, repeated and replayed in a graph, `check_kv_write`),
     attention alone, and the S-blocked write + attend (K11: batch 4 on both pools,
     and batch 1 at 8001 live rows at Gemma2-2B's, -9B's and -27B's head
     shapes, each case repeated and replayed in a graph bit for bit);
     the stacked GEMMs (K12:
     qkv, att_w, linear and the gated GEMM on layers 0, 6 and 12 of 13
     stacked Gemma2-2B layers for every kind, and i4 at Gemma2-27B widths
     over 2), each timed beside the unstacked kernel on the same layer;
     the prefill tile (K1 and K2 at M > 16 rows, csrc/matmul_sm90.cu:
     TMA, wgmma, weights decoded in shared memory) at M = 2048 for every
     kind at Gemma2-2B widths (qkv, att_w, linear, gated), i4 at
     Gemma2-27B's and nuq4 at Gemma2-9B's, beside F.linear (dense kinds)
     or torch._weight_int4pack_mm (i4), then ragged rows, the passes, a
     stacked layer and one-hot reads at M = 130 (`phase_prefill` says
     what); and the nuq4 gather diagnostic's three GEMMs (K13, M = 16
     and 4, each repeated for the same bits, beside F.linear);
  3. a 2-layer model at Gemma2-2B width (synthetic weights): prefill +
     one decode step over an i8 cache, last logits on the card vs the
     plain path on the CPU, for i8, sfp, i4 and nuq4 weights, and for
     split sfp q / kv weights (two decode steps through K8);
     `generate_batch` with a bf16 cache and decode_chunk=4 on both, tokens
     and probs compared, and sampled steps (the top-k head and the draw)
     on both, for i8, i4 and nuq4; then the loader: five `.sbs` files
     written with the port's `write_model` into a temporary directory and
     loaded with `Gemma.load` on the card and on the CPU, kind_override
     None, "i4", "i8" and "nuq4", and None for a file under the split
     names whose qkv2_w has a tensor scale of its own (`phase_loader` says
     at what sizes), last logits compared;
  4. the serving paths at Gemma2-2B width, synthetic weights made on the
     card, 4 ragged requests (17, 130, 300, 700 prompt tokens).  For each
     path every kernel launch count is zeroed before the counted run and
     read after, checked against the path's per-layer schedule, and every
     plain version is made to raise.  At 26 layers:
       A. `GemmaEngine.generate_batch` with the default RuntimeConfig (bf16
          KV, decode_chunk=4, stream_probs), i8 weights: 32 new tokens, 3
          runs (medians reported); two chunks under torch.profiler must
          show the launches the counters show, and one chunk runs with
          CUDA's sync debug mode set to error (no host sync inside a
          chunk); each first token is checked against a prefill-only
          forward;
       B. `generate_fast` with an i8 KV cache, 32 steps, whose tokens must
          equal generate_batch's with kv_kind="i8", decode_chunk=4;
       C. slice 1's path: kv_kind="i8", decode_chunk=1 (the head as the
          i8 GEMM, picked on the host), decode logits checked against a
          prefill-only forward;
       D. kv_kind="f32", decode_chunk=4, 8 new tokens;
       E. sampled serving: top_k=64, temperature=0.8, seed=1, i8 weights,
          32 new tokens through the fused top-k head and the draw kernel;
          a chunk under sync debug mode "error"; the same seed gives the
          same tokens, and query 0 gets at batch 4 the tokens it gets
          alone;
       F. sfp weights, default (greedy) runtime, 32 new tokens; then 8
          sampled tokens;
       G. bf16 weights, sampled, 8 new tokens; then 8 greedy tokens;
     at 4 layers:
       H. f32 weights, 4 greedy and 4 sampled tokens;
     and with the 4.5-bit kinds, each model freed before the next is made
     and its peak device memory printed:
       I. Gemma2-27B (46 layers, 32/16 heads of 128, query scale
          1/sqrt(model_dim / heads)), i4 weights, default runtime: 16
          greedy tokens, 3 runs, two chunks under torch.profiler (device
          busy and idle share) and one under sync debug mode "error",
          first tokens against a prefill-only forward; then 8 sampled
          tokens;
       J. Gemma2-9B (42 layers), nuq4 weights, the same traffic and the
          same checks;
       K. Gemma2-2B width, 4 layers, nuq4 weights with att_w of kind nuq
          (what a nuq4 model loaded from a file holds): 8 greedy and 4
          sampled tokens;
     and, at 26 layers, the JAX package's split-weight decode and its
     switches (`phase_split_paths` says what each runs):
       L. split q / kv weights (sfp, qkv2's tensor scale apart): K8;
       M. GEMMA_FUSED_DECODE=0: K9 + K10;
       N. GEMMA_SBLOCK_DECODE=1: K11;
     L, M and N each run two chunks under torch.profiler and one under
     sync debug mode "error";
       O. GEMMA_SCAN_DECODE=1: the scan-over-layers decode, stacked GEMMs
          (K12) and K8 (`phase_scan_path` says what it runs), with its
          decode speed, device busy and idle share beside path A's;
  5. every timed case as one JSON line, one `kernels` JSON line (each
     kernel's primary case; launches summed over the counted runs of
     4A-O; the diagnostic's and the norm passes', on no path, 0),
     then nvidia-smi's line, then the result line.

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

# The synth's default embedding makes the last prompt token's own logit
# lead all others by ~10, so a sampler always draws it.  The sampled paths
# use embedding rows of this rms instead: the top 64 logits then lie
# within ~1 of each other and the draw decides the token.
FLAT_EMBEDDING_RMS = 0.012
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
    logs: dict = {}
    _cuda.build_all(verbose=True, logs=logs)
    print(f"[1] built {len(list(_cuda.CSRC.glob('*.cu')))} sources in "
          f"{time.monotonic() - t0:.1f} s", flush=True)
    ptxas_report(logs, ("flash_attention.cu", "decode_attention.cu",
                        "matmul_decode.cu", "matmul.cu", "nuq_diag.cu"))

    results = phase_kernels(torch)
    phase_two_layers(torch)
    counts = phase_main_path(torch)

    # Every timed case of every kernel, on a line of its own; the `kernels`
    # line below carries each kernel's primary case and stays short.
    print("[5] cases " + json.dumps(
        {name: r["cases"] for name, r in results.items()}), flush=True)
    print("[5] profiles taken again " + json.dumps(PROFILE_RETRIES),
          flush=True)
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
            "library_ms": r.get("library_ms"),
            "library_note": LIBRARY_NOTE[k.name],
            "case": r["case"],
            "changed": CHANGED.get(k.name),
        })
    print(json.dumps({"kernels": line}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


# kind nuq runs sfp's kernels
WEIGHT_KINDS = ("i8", "sfp", "bf16", "f32", "i4", "nuq4")
_CODEC_OF = {"i8": "_acc_step :539 (i8)", "sfp": "_acc_step :473 + "
             "_sfp_tile_to_bf16 :417 (sfp and nuq)",
             "bf16": "_acc_step :471 (bf16)", "f32": "_acc_step :471 (f32)",
             "i4": "_acc_step :517 (i4)", "nuq4": "_acc_step :475 (nuq4)"}
REPLACES = {
    "matmul_prenorm":
        "gemma_tpu/ops/matmul.py:563 (_norm_a, the _mm_kernel/_gated_kernel "
        "prologue)",
    "matmul_postnorm_add":
        "gemma_tpu/ops/matmul.py:612-626 (_mm_kernel post-norm + add epilogue)",
    "topk_merge": "gemma_tpu/ops/matmul.py:1423 (_topk_kernel, its running "
                  "list across the sequential N grid)",
    "draw_topk": "gemma_tpu/ops/sampling.py:57 (_draw_from_topk: XLA ops in "
                 "the JAX package, no TPU kernel)",
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
    "matmul_prenorm": "torch.nn.functional.rms_norm has no (1 + w) form "
                      "and no bf16 rounding of its f32 result in one call",
    "matmul_postnorm_add": "torch.nn.functional.rms_norm has no (1 + w) "
                           "form and no residual add in one call",
    "topk_merge": "no single PyTorch call merges sorted (value, index) "
                  "lists by value then index",
    "draw_topk": "torch.multinomial draws from torch's own generator, not "
                 "from a (seed, query, position) counter stream",
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
_POOL = {"i8": "i8 pool, _decode_fused_q_pallas", "bf16": "bf16 pool",
         "f32": "f32 pool"}
for _kind in ("i8", "bf16", "f32"):
    _q = "_q" if _kind == "i8" else ""
    REPLACES[f"decode_write_attend_{_kind}"] = (
        f"gemma_tpu/ops/decode_attention.py:386 (_decode_fused_kernel, "
        f"{_POOL[_kind]})")
    REPLACES[f"kv_write_{_kind}"] = (
        "gemma_tpu/ops/decode_attention.py:104 (_kv_write_q_kernel)"
        if _kind == "i8" else
        f"gemma_tpu/ops/decode_attention.py:61 (_kv_write_kernel, {_kind} pool)")
    REPLACES[f"decode_attend_{_kind}"] = (
        f"gemma_tpu/ops/decode_attention.py:212 (_decode_att_kernel through "
        f"_decode_att{_q}_pallas, {_kind} pool)")
    REPLACES[f"decode_sblocked_{_kind}"] = (
        f"gemma_tpu/ops/decode_attention.py:739 (_decode_fused_sblocked_kernel, "
        f"{_kind} pool)")
    _no_sdpa = ("scaled_dot_product_attention has no "
                + ("i8 per-row scales, " if _kind == "i8" else "")
                + "soft cap or ring mask")
    LIBRARY_NOTE[f"decode_write_attend_{_kind}"] = (
        _no_sdpa + ", and no in-place row write or RoPE")
    LIBRARY_NOTE[f"decode_sblocked_{_kind}"] = (
        _no_sdpa + ", and no in-place row write or RoPE")
    LIBRARY_NOTE[f"decode_attend_{_kind}"] = _no_sdpa
    LIBRARY_NOTE[f"kv_write_{_kind}"] = (
        "no single call: the library composition is _pool_rows of the "
        "stacked rows (" + ("quantize_rows's torch ops" if _kind == "i8"
                            else "a cast") + "), then index_copy_ of the rows"
        + (" and of the scales" if _kind == "i8" else "")
        + " at their flat indices (made beforehand)")
_INT4PACK_CALL = "torch._weight_int4pack_mm"
_INT4PACK = (f"{_INT4PACK_CALL} on the same A in bf16 and the codes repacked "
             "(zero = min + 8 * scale; no prologue, scale 1)")
for _kind in WEIGHT_KINDS:
    _dense = _kind in ("bf16", "f32")
    _what = {"i8": "i8 group-quantized", "sfp": "SFP-coded",
             "i4": "4-bit group-affine", "nuq4": "4-bit table-coded"
             }.get(_kind, _kind)
    REPLACES[f"matmul_{_kind}"] = (
        f"gemma_tpu/ops/matmul.py:577 (_mm_kernel, call :908) at M <= 16 "
        f"rows with {_CODEC_OF[_kind]}")
    REPLACES[f"gated_{_kind}"] = (
        f"gemma_tpu/ops/matmul.py:629 (_gated_kernel, call :998) at M <= 16 "
        f"rows with {_CODEC_OF[_kind]}")
    REPLACES[f"top1_{_kind}"] = (
        f"gemma_tpu/ops/matmul.py:1228 (_top1_kernel) with {_CODEC_OF[_kind]}")
    REPLACES[f"topk_{_kind}"] = (
        f"gemma_tpu/ops/matmul.py:1423 (_topk_kernel) with {_CODEC_OF[_kind]}")
    LIBRARY_NOTE[f"matmul_{_kind}"] = (
        "torch.nn.functional.linear on the same A and weights (no prologue, "
        "scale 1)" if _dense else _INT4PACK if _kind == "i4" else
        f"no single PyTorch call multiplies by {_what} weights")
    LIBRARY_NOTE[f"gated_{_kind}"] = (
        "gelu(linear(a, w1), approximate='tanh') * linear(a, w2), three "
        "PyTorch calls" if _dense else
        f"gelu({_INT4PACK_CALL}(a, w1)) * {_INT4PACK_CALL}(a, w2), three "
        "PyTorch calls on the same codes repacked" if _kind == "i4" else
        f"no single PyTorch call computes gelu(A.W1^T)*(A.W2^T) over {_what} "
        "weights")
    LIBRARY_NOTE[f"top1_{_kind}"] = (
        "no single PyTorch call computes the argmax and softmax prob of "
        "soft-capped logits without the logits")
    LIBRARY_NOTE[f"topk_{_kind}"] = (
        "no single PyTorch call selects the top k of soft-capped, masked "
        "logits without the logits (torch.topk needs them, and leaves ties "
        "unordered)")


for _kind in WEIGHT_KINDS:
    _dense = _kind in ("bf16", "f32")
    REPLACES[f"matmul_stacked_{_kind}"] = (
        f"gemma_tpu/ops/matmul.py:768 (_b_inputs_stacked) feeding _mm_kernel "
        f":577 through _matmul_pallas's stacked branch :847-900 (call :908), "
        f"with {_CODEC_OF[_kind]}")
    REPLACES[f"gated_stacked_{_kind}"] = (
        f"gemma_tpu/ops/matmul.py:768 (_b_inputs_stacked) feeding "
        f"_gated_kernel :629 through _gated_pallas's stacked branch :944-990 "
        f"(call :998), with {_CODEC_OF[_kind]}")
    LIBRARY_NOTE[f"matmul_stacked_{_kind}"] = (
        "torch.nn.functional.linear on the layer's w[t] view (no prologue)"
        if _dense else "on layer t's weights: "
        + LIBRARY_NOTE[f"matmul_{_kind}"] if _kind == "i4"
        else LIBRARY_NOTE[f"matmul_{_kind}"])
    LIBRARY_NOTE[f"gated_stacked_{_kind}"] = (
        "gelu(linear(a, w1[t]), approximate='tanh') * linear(a, w2[t]), three "
        "PyTorch calls" if _dense else "on layer t's weights: "
        + LIBRARY_NOTE[f"gated_{_kind}"] if _kind == "i4"
        else LIBRARY_NOTE[f"gated_{_kind}"])
for _kind in WEIGHT_KINDS:
    REPLACES[f"matmul_sm90_{_kind}"] = (
        f"gemma_tpu/ops/matmul.py:577 (_mm_kernel, call :908) at M > 16 "
        f"rows, and :768 (_b_inputs_stacked) on a stacked layer, with "
        f"{_CODEC_OF[_kind]}")
    REPLACES[f"gated_sm90_{_kind}"] = (
        f"gemma_tpu/ops/matmul.py:629 (_gated_kernel, call :998) at M > 16 "
        f"rows, and :768 (_b_inputs_stacked) on a stacked layer, with "
        f"{_CODEC_OF[_kind]}")
    LIBRARY_NOTE[f"matmul_sm90_{_kind}"] = (
        "torch.nn.functional.linear on the same A and weights (scale 1)"
        if _kind in ("bf16", "f32") else LIBRARY_NOTE[f"matmul_{_kind}"])
    LIBRARY_NOTE[f"gated_sm90_{_kind}"] = LIBRARY_NOTE[f"gated_{_kind}"]
# The kernels this slice of the port changed, and how.
CHANGED = {"matmul_prenorm": "no longer on any decode step: folded into "
                             "the decode tile, K3 and K6 (the prefill tile "
                             "keeps it)",
           "topk_merge": "redesigned as K6's selection: the k_top best of "
                         "each 4096-entry slice (a pruning bound, a radix "
                         "select over 64-bit keys, a bitonic sort), the "
                         "last block of a row merging the slices' lists",
           "matmul_postnorm_add": "no longer on a decode step: folded into "
                                  "the decode tile (the prefill tile keeps "
                                  "it)"}
for _kind in WEIGHT_KINDS:
    for _st in ("", "stacked_"):
        CHANGED[f"matmul_{_st}{_kind}"] = (
            "decode tile: the prologue norm and the post-norm + residual "
            "folded into its one launch")
        CHANGED[f"gated_{_st}{_kind}"] = (
            "decode tile: the prologue norm folded into its one launch")
    CHANGED[f"top1_{_kind}"] = (
        "redesigned on the decode tile's warp: persistent blocks over "
        "16-row vocabulary groups, the final norm folded in")
    CHANGED[f"topk_{_kind}"] = (
        "redesigned on K3's stream, the final norm folded in (no prologue "
        "pass): it writes the capped logits, and topk_merge selects")
for _kind in ("i8", "bf16", "f32"):
    CHANGED[f"kv_write_{_kind}"] = (
        "redesigned: takes the raw f32 or bf16 k and v through their "
        "strides and encodes them itself (i8 by K4 / K8's encode), one "
        "warp a row, four rows a block, one launch a layer (no stack or "
        "torch-op quantize before it)")
    CHANGED[f"decode_sblocked_{_kind}"] = (
        "redesigned on K4's body: runs of the live positions from the ring, "
        "the window and the head count alone, one block each, loads in "
        "flight before the encode, K read once, the last block merging the "
        "runs")
# On no serving path: K13, a standalone diagnostic; and the norm passes,
# which only the prefill tile's entries chain (the prefill branch norms in
# torch ops; decode folds the prologue into the decode tile, K3 and K6 and
# the post-norm into the decode tile).  Each is held against its plain
# version all the same.
STANDALONE = {f"nuq_diag_{_v}" for _v in ("d1", "d2", "d3")} | {
    "matmul_prenorm", "matmul_postnorm_add"}
for _v, _what in (("d1", "codes read as int8"),
                  ("d2", "codes zero-extended through int32"),
                  ("d3", "table entries gathered per 128-chunk")):
    REPLACES[f"nuq_diag_{_v}"] = (
        f"scripts/proto_nuq_diag.py:26 (kern, pallas_call :64), variant "
        f"{_v.upper()}")
    LIBRARY_NOTE[f"nuq_diag_{_v}"] = (
        f"torch.nn.functional.linear on A and the variant's B ({_what}) "
        "made beforehand as bf16")
    CHANGED[f"nuq_diag_{_v}"] = (
        "redesigned on the decode tile: codes as mma.sync's 16-row operand "
        "through its register ring, A staged once a block, warps and "
        "cluster splits from the shapes (diag_split)"
        + ("; the block's table slices staged once as bf16" if _v == "d3"
           else ""))


def _held(name: str) -> bool:
    """K5, the G = 2 instantiations (every Gemma2 head shape) of K4's body
    with K8, K10 and K11, the decode tile of K1 / K2 / K12, the greedy head
    K3 and the top-k head K6 with its selection, the row write K9 and the
    diagnostic K13 on the decode tile: the kernels this script holds to
    no spill."""
    return name.startswith(("flash_attention_", "mm_", "top1_", "topk_",
                            "kv_write_", "nuq_diag_")) \
        or "topk_merge_kernel" in name or (
            name.startswith(("decode_attention_", "decode_write_attend_",
                             "decode_attend_", "decode_sblocked_"))
            and name.endswith(",2>"))


def ptxas_report(logs: dict, sources, held=_held) -> None:
    """Registers and spills of every kernel of `sources`, from nvcc's
    -Xptxas -v output; a spill in a kernel `held` accepts fails."""
    import re

    for src in sources:
        entry, seen = None, []
        for line in logs.get(src, "").splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                name = m.group(1)
                k = re.search(r"\d+(\w+_kernel)I(.*)EEv", name)
                t = re.search(r"\d+(\w+_kernel)I(f|13__nv_bfloat16)Ev", name)
                if k:
                    targs = re.findall(r"L[ib](\d+)E?", k.group(2))
                    name = f"{k.group(1)}<{','.join(targs)}>"
                elif t:  # a kernel templated on its rows' type (K9)
                    name = f"{t.group(1)}<{'float' if t.group(2) == 'f' else 'bf16'}>"
                entry = [name, None, None]
                seen.append(entry)
                continue
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          line)
            if m and entry is not None:
                entry[2] = int(m.group(1)) + int(m.group(2))
            m = re.search(r"Used (\d+) registers", line)
            if m and entry is not None:
                entry[1] = int(m.group(1))
        if not seen:  # built by an earlier run of this checkout
            print(f"[1] ptxas {src}: not built in this run", flush=True)
            continue
        print(f"[1] ptxas {src}: " + "; ".join(
            f"{n} {r} regs {sp} B spilled" for n, r, sp in seen), flush=True)
        spilled = [n for n, _, sp in seen if sp and held(n)]
        if spilled:
            fail(f"{src}: kernels spill registers: {spilled}")


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    tb, to = nbytes / HBM_BYTES_PER_S * 1e3, ops / BF16_OPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def qkv_kind(lp) -> str:
    """The q / kv projections' kind, fused or split."""
    if lp.qkv_cat is not None:
        return lp.qkv_cat.kind
    if lp.qkv1.kind != lp.qkv2.kind:
        fail(f"qkv1 is {lp.qkv1.kind} but qkv2 {lp.qkv2.kind}")
    return lp.qkv1.kind


def params_bytes(params) -> int:
    """The weights' bytes, q / kv projections fused or split."""
    total = params.embedding.nbytes()
    for lp in params.layers:
        for w in (lp.qkv_cat, lp.qkv1, lp.qkv2, lp.att_w, lp.gating1,
                  lp.gating2, lp.linear):
            total += 0 if w is None else w.nbytes()
    return total


def weight_bytes(w) -> int:
    """The bytes of a weight that a GEMM must read: its arrays, less the
    zero padding of nuq4's table rows (16 bytes per 256-block are real)."""
    if w.kind != "nuq4":
        return w.nbytes()
    return w.arrays["codes"].numel() + w.n * (w.kp // 256) * 16


def int4pack(torch, a, w, w2=None):
    """The library call for an i4 GEMM: torch._weight_int4pack_mm (PyTorch's
    bf16 x group-wise int4 GEMM, 128-wide groups; it dequantizes
    (q - 8) * scale + zero) on A in bf16 and w's codes repacked, with zero
    = min + 8 * scale; with w2, gelu(A.W^T) * (A.W2^T) in three calls.  No
    norm pass and no tensor scale, as the dense kinds' F.linear.  Its
    products times the tensor scales are held against the plain version
    (bf16 products: 1e-2 of max|out|, 2e-2 for gelu(y1) * y2).  None, with the error printed,
    where the card's torch refuses the op."""
    import torch.nn.functional as F

    from gemma_tpu_torch.ops import matmul as mm

    def repack(w):
        codes = mm.unpack_nuq4(w.arrays["codes"])  # [N, K] int32, 0..15
        packed = ((codes[:, ::2] << 4) | codes[:, 1::2]).to(torch.uint8)
        sc, mn = w.arrays["scales"], w.arrays["mins"]  # [N, K/128]
        sz = torch.stack([sc.T, (mn + 8 * sc).T], dim=-1).to(
            torch.bfloat16).contiguous()  # [K/128, N, 2]
        return torch._convert_weight_to_int4pack(packed, 8), sz

    a = a.to(torch.bfloat16)
    try:
        wp, sz = repack(w)
        y1 = torch._weight_int4pack_mm(a, wp, 128, sz).float() * w.scale
        if w2 is None:
            fn = lambda: torch._weight_int4pack_mm(a, wp, 128, sz)  # noqa
            got, want = y1, mm.matmul_plain(a, w)
        else:
            wp2, sz2 = repack(w2)
            fn = lambda: F.gelu(  # noqa: E731
                torch._weight_int4pack_mm(a, wp, 128, sz),
                approximate="tanh") * torch._weight_int4pack_mm(
                    a, wp2, 128, sz2)
            y2 = torch._weight_int4pack_mm(a, wp2, 128, sz2).float()
            got = F.gelu(y1, approximate="tanh") * (y2 * w2.scale)
            want = mm.gated_ffn_plain(a, w, w2)
    except (RuntimeError, NotImplementedError, AttributeError) as e:
        print(f"[2] torch._weight_int4pack_mm refused: "
              f"{type(e).__name__}: {e}"[:400], flush=True)
        return None
    err = float((got - want.float()).abs().max())
    tol = (1e-2 if w2 is None else 2e-2) * float(want.float().abs().max())
    print(f"[2] library torch._weight_int4pack_mm M={a.shape[0]} "
          f"K={a.shape[1]} N={w.n}{' gated' if w2 is not None else ''}: "
          f"max_abs_err {err:.4g} against the plain version (tol "
          f"{tol:.4g})", flush=True)
    if err > tol:
        fail("torch._weight_int4pack_mm does not compute the i4 GEMM's "
             "function")
    return fn


def record(results, torch, name, case, got, want, tol, kern, plain, nbytes,
           ops, iters=20, primary=False, library=None):
    from gemma_tpu_torch.ops._cuda import time_ms

    got = got.float()
    want = want.float()
    if not torch.isfinite(got).all():
        fail(f"{name} [{case}]: non-finite output")
    err = float((got - want).abs().max())
    ok = err <= tol
    b_ms, b_by = bound(nbytes, ops)
    k_ms = time_ms(kern, iters)
    p_ms = time_ms(plain, max(3, iters // 4), warmup=1)
    l_ms = None if library is None else time_ms(library, iters)
    lib = "" if l_ms is None else f"library {l_ms:.4f} ms "
    print(f"[2] {name:24s} {case:44s} max_abs_err {err:.4g} (tol {tol:.4g}) "
          f"kernel {k_ms:.4f} ms plain {p_ms:.4f} ms {lib}"
          f"bound {b_ms:.4f} ms ({b_by}) {'ok' if ok else 'FAIL'}",
          flush=True)
    if not ok:
        fail(f"{name} [{case}] disagrees with its plain version: {err} > {tol}")
    entry = results.setdefault(name, {"cases": []})
    c = {"case": case, "max_abs_err": err, "tol": tol, "ms": k_ms,
         "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
         "library_ms": l_ms}
    entry["cases"].append(c)
    if primary:
        entry.update({k: v for k, v in c.items() if k != "tol"})


# The decode tile's row counts (matmul_decode.cu: one n-tile of A's rows to
# 8, two above; 16 is the most its entries take).
DECODE_ROWS_CHECKED = (1, 4, 8, 13, 16)

# K3's prob against its plain version, relative per row.  The plain
# version's prologue is rms_norm; the kernel's takes a row's sum of
# squares in its own fixed order (ops/matmul.py:prenorm_fixed_order).
# Where the two f32 multipliers differ in the last place, an element of
# the bf16 A can round one ulp apart, and each such flip moves prob by up
# to ~2e-4 at the head's shapes.  The limit was set from readings
# (PERF.md, K3): 17x the largest error of the sound runs (2.99e-5), 3.4x
# below the smallest error of a control that every run checks must fail
# it (the plain head on A rounded to bf16 before its norm: 1.72e-3).
TOP1_PROB_TOL = 5e-4
# The same prob against the plain head on the kernels' own prologue A:
# only the order of the exp sum differs.
TOP1_PROB_TOL_SAME_A = 1e-4
# K6's values against its plain version (rms_norm's prologue), over the
# largest |value| (the same products in another f32 order, and one-ulp
# flips of the bf16 prologue A where the kernels' sum of squares rounds
# the other way), and the limit of `check_topk`'s index pinning.  Set
# from readings (PERF.md, K6): 5e-4 sits above the largest error of the
# sound runs and below the smallest error of a control that every run
# checks must fail it (the plain head on A rounded to bf16 before its
# norm); K1's 1e-3 did not keep that control out by a clear margin.
TOPK_TOL = 5e-4
# The same values against the plain head on the kernels' own prologue A:
# only the order of the f32 sums differs.
TOPK_TOL_SAME_A = 1e-4


def check_decode_rows(torch, gen, label, k, call, plain, rel):
    """One decode GEMM at every M of DECODE_ROWS_CHECKED on bf16 A, held
    against its plain version (`rel` of max|out|: 1e-3 f32 out, 1e-2 the
    gated bf16 out); each call repeated gives the same bits (no atomics in
    the sums), and row 0 alone the same bits as row 0 in the batch (the
    split of K does not depend on M)."""
    a16 = torch.randn(16, k, generator=gen, device="cuda").mul_(3.0).to(
        torch.bfloat16)
    worst = 0.0
    for m in DECODE_ROWS_CHECKED:
        a = a16[:m].contiguous()
        got, want = call(a), plain(a)
        err = float((got.float() - want.float()).abs().max())
        tol = rel * float(want.float().abs().max())
        worst = max(worst, err / max(tol, 1e-30))
        if err > tol:
            fail(f"{label} M={m}: max_abs_err {err:.4g} over tol {tol:.4g}")
        if not torch.equal(got, call(a)):
            fail(f"{label} M={m}: a repeat gave other bits")
        if m > 1 and not torch.equal(got[:1], call(a[:1].contiguous())):
            fail(f"{label} M={m}: row 0 differs from row 0 alone")
    print(f"[2] {label}: M in {DECODE_ROWS_CHECKED} within tol (worst "
          f"err/tol {worst:.3g}), repeats and row 0 alone bit-identical",
          flush=True)


def check_fused_rows(torch, gen, label, k, n, call, plain, rel, pro):
    """A decode GEMM with a norm folded in (K1 / K2 / K12: call(a, add)),
    at every M of DECODE_ROWS_CHECKED, held against its plain version
    (`rel` of max|out|, as check_decode_rows); A f32 under the prologue
    (pro), else bf16, and a residual [M, n] for the epilogue.  Each call
    repeated gives the same bits, row 0 alone the same bits as row 0 in the
    batch (the norms' sums are taken in one order at every M), and a CUDA
    graph of the call replayed twice the call's bits (the epilogue's
    ticket is zero again after every launch)."""
    a16 = torch.randn(16, k, generator=gen, device="cuda")
    a16 = a16.mul_(30.0) if pro else a16.mul_(3.0).to(torch.bfloat16)
    add16 = torch.randn(16, n, generator=gen, device="cuda").mul_(10.0)
    worst = 0.0
    for m in DECODE_ROWS_CHECKED:
        a, add = a16[:m].contiguous(), add16[:m].contiguous()
        got, want = call(a, add), plain(a, add)
        err = float((got.float() - want.float()).abs().max())
        tol = rel * float(want.float().abs().max())
        worst = max(worst, err / max(tol, 1e-30))
        if err > tol or not bool(torch.isfinite(got.float()).all()):
            fail(f"{label} M={m}: max_abs_err {err:.4g} over tol {tol:.4g}")
        if not torch.equal(got, call(a, add)):
            fail(f"{label} M={m}: a repeat gave other bits")
        if m > 1 and not torch.equal(
                got[:1], call(a[:1].contiguous(), add[:1].contiguous())):
            fail(f"{label} M={m}: row 0 differs from row 0 alone")
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            call(a, add)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = call(a, add)
        for replay in range(2):
            graph.replay()
            torch.cuda.synchronize()
            if not torch.equal(out, got):
                fail(f"{label} M={m}: graph replay {replay} gave other bits")
        del graph
    print(f"[2] {label}: folded norms, M in {DECODE_ROWS_CHECKED} within tol "
          f"(worst err/tol {worst:.3g}), repeats, row 0 alone and two graph "
          "replays bit-identical", flush=True)


def check_prologue_bits(torch, gen):
    """The prologue folded into the decode tile, read back bit for bit: a
    bf16 identity weight (N = K) makes K1's f32 output the staged bf16 A
    itself (each output one exact product, the rest zeros), which must
    equal ops/matmul.py:prenorm_fixed_order (the kernels' order of the sum
    of squares) at every M of DECODE_ROWS_CHECKED, at K 2304 (a block sums
    its rows alone) and 9216 (K split over a cluster, whose blocks share
    their segments' sums), plain and stacked (K12).  K3 stages its A with
    the same functions (gemm_common.cuh: norm_segments, norm_row_mul,
    norm_stage); K6, which stages it as K3 does and returns values, reads
    it back too: through the identity at K 2304 and 4608 (no cap) its 128
    largest values of each row, with their indices, must equal those of
    prenorm_fixed_order's A bit for bit."""
    from gemma_tpu_torch.ops import matmul as mm

    for k in (2304, 9216):
        eye = torch.eye(k, device="cuda", dtype=torch.bfloat16)
        w = mm.QuantTensor("bf16", (k, k), 1.0, {"w": eye})
        stacked = mm.stack_quant_tensors([w, w])
        norm = torch.randn(k, generator=gen, device="cuda").mul_(0.05)
        a16 = torch.randn(16, k, generator=gen, device="cuda").mul_(30.0)
        for m in DECODE_ROWS_CHECKED:
            a = a16[:m].contiguous()
            want = mm.prenorm_fixed_order(a, norm).float()
            for label, got in (
                    ("plain", mm.matmul(a, w, prologue_norm=norm)),
                    ("stacked", mm.matmul(a, stacked, prologue_norm=norm,
                                          layer=1))):
                if not torch.equal(got, want):
                    fail(f"the decode tile's prologue ({label}, K={k}, M={m})"
                         f": {int((got != want).sum())} of {got.numel()} "
                         "elements of A differ from prenorm_fixed_order")
        del eye, w, stacked
    for k in (2304, 4608):
        eye = torch.eye(k, device="cuda", dtype=torch.bfloat16)
        w = mm.QuantTensor("bf16", (k, k), 1.0, {"w": eye})
        norm = torch.randn(k, generator=gen, device="cuda").mul_(0.05)
        a16 = torch.randn(16, k, generator=gen, device="cuda").mul_(30.0)
        for m in DECODE_ROWS_CHECKED:
            a = a16[:m].contiguous()
            vals, idxs = mm.matmul_topk(a, w, 128, prologue_norm=norm)
            want = torch.sort(mm.prenorm_fixed_order(a, norm).float(), dim=-1,
                              descending=True, stable=True)
            if not (torch.equal(vals, want.values[:, :128]) and torch.equal(
                    idxs, want.indices[:, :128].to(torch.int32))):
                fail(f"K6's prologue (K={k}, M={m}): its top 128 of A differ "
                     "from prenorm_fixed_order's")
        del eye, w
    print(f"[2] the decode tile's prologue, read back through an identity "
          f"weight (K 2304 and 9216, M in {DECODE_ROWS_CHECKED}, plain and "
          "stacked): bit-identical to prenorm_fixed_order; K6's top 128 of "
          "it (K 2304 and 4608) bit-identical", flush=True)


def check_one_hot_rows(torch, label, w, ms=DECODE_ROWS_CHECKED):
    """One-hot rows of A (row i reads column 7 i + 3 i^2 mod K): each
    output is one dequantized weight, which pins the fragment mapping of
    weights to A columns (1e-6 of max|w|: the group affines land on the
    output in f32)."""
    from gemma_tpu_torch.ops import matmul as mm

    k = w.k
    want_all = w.dequantize()
    if w.kind == "f32":  # the tile multiplies f32 weights rounded to bf16
        want_all = w.arrays["w"].to(torch.bfloat16).float() * w.scale
    for m in ms:
        cols = torch.tensor([(7 * i + 3 * i * i) % k for i in range(m)],
                            device="cuda")
        a = torch.zeros(m, k, device="cuda")
        a[torch.arange(m), cols] = 1.0
        got = mm.matmul(a.to(torch.bfloat16), w)
        want = want_all[:, cols].T
        err = float((got - want).abs().max())
        tol = 1e-6 * float(want_all.abs().max())
        if err > tol:
            fail(f"{label} one-hot A, M={m}: max_abs_err {err:.3g} over tol "
                 f"{tol:.3g}: a weight met the wrong A column")
    print(f"[2] {label} one-hot A, M in {tuple(ms)}: each output is one "
          f"dequantized weight", flush=True)


def fused_rows(torch, gen, kind, w_qkv, g1, g2, d, ff, layer=None):
    """check_fused_rows for one kind at Gemma2-2B widths (w_qkv [*, d], the
    gated pair [ff, d]; layer: on that layer of stacked weights): K1 qkv
    with the prologue, linear (K = ff, split over a cluster) with the
    post-norm and the residual, the same linear with the prologue too (a
    cluster's blocks share their segments' sums of squares), and K2 with
    the prologue.  Tolerances as check_decode_rows'."""
    from gemma_tpu_torch.ops import matmul as mm
    from gemma_tpu_torch.utils.synth import synth_quant

    def plain_w(w):
        return w if layer is None else mm.take_layer(w, layer)

    lay = {} if layer is None else {"layer": layer}
    dev = torch.device("cuda")
    norm = torch.randn(d, generator=gen, device=dev).mul_(0.05)
    norm_ff = torch.randn(ff, generator=gen, device=dev).mul_(0.05)
    post = torch.randn(d, generator=gen, device=dev).mul_(0.05)
    w_lin = synth_quant(gen, d, ff, dev, kind)
    if layer is not None:
        w_lin = mm.stack_quant_tensors([w_lin] * (layer + 1))
    tag = f"{'matmul_stacked' if layer is not None else 'matmul'}_{kind}"
    gtag = f"{'gated_stacked' if layer is not None else 'gated'}_{kind}"
    check_fused_rows(
        torch, gen, f"{tag} qkv +prologue", d, w_qkv.n,
        lambda a, add: mm.matmul(a, w_qkv, prologue_norm=norm, **lay),
        lambda a, add: mm.matmul_plain(a, plain_w(w_qkv), prologue_norm=norm),
        1e-3, True)
    check_fused_rows(
        torch, gen, f"{tag} linear +epilogue", ff, d,
        lambda a, add: mm.matmul(a, w_lin, epilogue_norm=post, add=add, **lay),
        lambda a, add: mm.matmul_plain(a, plain_w(w_lin), epilogue_norm=post,
                                       add=add), 1e-3, False)
    check_fused_rows(
        torch, gen, f"{tag} linear +prologue +epilogue", ff, d,
        lambda a, add: mm.matmul(a, w_lin, prologue_norm=norm_ff,
                                 epilogue_norm=post, add=add, **lay),
        lambda a, add: mm.matmul_plain(a, plain_w(w_lin),
                                       prologue_norm=norm_ff,
                                       epilogue_norm=post, add=add),
        1e-3, True)
    check_fused_rows(
        torch, gen, f"{gtag} +prologue", d, g1.n,
        lambda a, add: mm.gated_ffn(a, g1, g2, prologue_norm=norm, **lay),
        lambda a, add: mm.gated_ffn_plain(a, plain_w(g1), plain_w(g2),
                                          prologue_norm=norm), 1e-2, True)


def phase_kernels(torch):
    """Each kernel vs its plain version at the serving path's shapes."""
    import dataclasses

    from gemma_tpu_torch.models.configs import (config_gemma2_2b,
                                                config_gemma2_27b)
    from gemma_tpu_torch.ops import matmul as mm
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

    # --- K1 with its prologue and epilogue folded in, and the passes alone
    # (the prefill tile's and K6's) ---
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
    record(res, torch, "matmul_prenorm", "decode M=4 K=2304", f(), want,
           rel_tol(want, 2 ** -8), f, p, b * d * 4 + d * 4 + b * d * 2, 0,
           primary=True)
    f = lambda: mm.matmul(x, w_qkv, prologue_norm=norm)  # noqa: E731
    p = lambda: mm.matmul_plain(x, w_qkv, prologue_norm=norm)  # noqa: E731
    want = p()
    record(res, torch, "matmul_i8",
           "decode qkv M=4 K=2304 N=4096 (prologue folded)",
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
               f"decode {name} M=4 K={k_in} N={d} (epilogue folded)", f(),
               want, rel_tol(want, 1e-3), f, p,
               b * k_in * 2 + w.nbytes() + b * d * 4, 2 * b * d * k_in)
        y = mm.matmul(a, w)
        f = lambda: mm.postnorm_add(y.clone(), post, add)  # noqa: E731
        p = lambda: mm.postnorm_add_plain(y, post, add)  # noqa: E731
        want = p()
        record(res, torch, "matmul_postnorm_add",
               f"decode {name} M=4 N={d}", f(), want, rel_tol(want, 1e-5),
               f, p, 3 * b * d * 4 + d * 4, 0, primary=name == "att_w")
    w_head = synth_quant(gen, cfg.vocab_size, d, dev)
    fnorm = randn(d, s=0.05)
    f = lambda: mm.matmul(x, w_head, prologue_norm=fnorm)  # noqa: E731
    p = lambda: mm.matmul_plain(x, w_head, prologue_norm=fnorm)  # noqa: E731
    want = p()
    record(res, torch, "matmul_i8",
           "decode head M=4 K=2304 N=256000 (prologue folded)",
           f(), want, rel_tol(want, 1e-3), f, p,
           b * d * 4 + w_head.nbytes() + b * cfg.vocab_size * 4,
           2 * b * cfg.vocab_size * d, iters=5)
    # --- K2 ---  (bf16 output: one bf16 ulp, 2^-8 relative, plus the
    # GEMM's f32 reorder; 1e-2 of max|out| bounds it)
    g1 = synth_quant(gen, ff, d, dev)
    g2 = synth_quant(gen, ff, d, dev)
    fn2 = randn(d, s=0.05)
    xs = randn(b, d, s=30.0)
    f = lambda: mm.gated_ffn(xs, g1, g2, prologue_norm=fn2)  # noqa: E731
    p = lambda: mm.gated_ffn_plain(xs, g1, g2, prologue_norm=fn2)  # noqa: E731
    want = p()
    record(res, torch, "gated_i8",
           "decode M=4 K=2304 N=9216 (prologue folded)",
           f(),
           want, rel_tol(want, 1e-2), f, p,
           b * d * 4 + 2 * g1.nbytes() + b * ff * 2, 4 * b * ff * d,
           primary=True)
    # The decode tile at every row count, repeats, row 0 alone, one-hot.
    check_decode_rows(torch, gen, "matmul_i8 decode qkv", d,
                      lambda a: mm.matmul(a, w_qkv),
                      lambda a: mm.matmul_plain(a, w_qkv), 1e-3)
    check_decode_rows(torch, gen, "gated_i8 decode", d,
                      lambda a: mm.gated_ffn(a, g1, g2),
                      lambda a: mm.gated_ffn_plain(a, g1, g2), 1e-2)
    check_one_hot_rows(torch, "matmul_i8", w_qkv)
    fused_rows(torch, gen, "i8", w_qkv, g1, g2, d, ff)
    check_prologue_bits(torch, gen)

    phase_top1(torch, res, x, w_head, fnorm, cfg)
    phase_topk(torch, res, "i8", w_head, fnorm, cfg)
    del w_head
    phase_codecs(torch, res, cfg)
    phase_k7b(torch, res)
    phase_k12(torch, res)
    phase_prefill(torch, res)
    phase_k13(torch, res)
    phase_draw(torch, res, cfg)

    phase_attention(torch, res, cfg, ("i8", "bf16", "f32"))
    phase_split_attention(torch, res, cfg, ("i8", "bf16", "f32"))
    check_kv_write(torch, res, cfg)
    # Gemma2-27B's head shape (32 query heads over 16 KV heads of 128, the
    # query scale 1/sqrt(model_dim / heads)): the D=128 instantiations, on
    # a 2-layer cut of its caches (K4 and K5 of every pool kind; the split
    # kernels over bf16).
    big = config_gemma2_27b()
    big2 = dataclasses.replace(
        big, num_layers=2, layer_configs=big.layer_configs[:2],
        attention_window_sizes=big.attention_window_sizes[:2])
    phase_attention(torch, res, big2, ("i8", "bf16", "f32"), primary=False)
    phase_split_attention(torch, res, big2, ("bf16",), primary=False)
    check_kv_write(torch, res, big2, primary=False)
    phase_sblocked_long(torch, res)
    return res


def check_written_rows(torch, name, label, kind, ck, cp, layer):
    """The pool a kernel wrote (ck) against the one its plain version wrote
    (cp): the kernel and the plain version round RoPE alike (-fmad=false),
    so i8 codes may move by one, bf16 rows by one bf16 ulp (2^-7
    relative), f32 rows by 1e-5 relative; i8 scales are printed."""
    pk, idx, _ = ck.pool(layer)
    pp = cp.pool(layer)[0]
    if kind == "i8":
        code_diff = (pk[:, idx].int() - pp[:, idx].int()).abs()
        row_err, row_tol = float(code_diff.max()), 1.0
        sc_err = float((ck.pool_scale(layer)
                        - cp.pool_scale(layer)).abs().max())
        print(f"[2] {name} {label}: {int((code_diff > 0).sum())} pool codes "
              f"one off, scale max err {sc_err:.3g}", flush=True)
    else:
        a, w = pk[:, idx].float(), pp[:, idx].float()
        rel = 2 ** -7 if kind == "bf16" else 1e-5
        row_err = float(((a - w).abs() - rel * w.abs()).max())
        row_tol = 1e-6
        print(f"[2] {name} {label}: written rows max excess over {rel:.3g} "
              f"relative {row_err:.3g}", flush=True)
    if row_err > row_tol:
        fail(f"{name} [{label}]: written rows differ from the plain "
             f"version's ({row_err} > {row_tol})")


def random_cache(torch, cfg, kind, gen, seq_len=8192, b=4):
    """A batch-4 cache of `kind` (local slack 512) filled with random rows:
    i8 codes in [-127, 127] under scales |N(0, 0.02)|, else N(0, 0.5)."""
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


def phase_attention(torch, res, cfg, kinds, primary=True):
    """K4 and K5 against their plain versions at `cfg`'s head shape, over
    both pools (layer 0 local, layer 1 global) of a seq_len=8192 cache of
    each KV kind in `kinds`, batch 4."""
    from gemma_tpu_torch.ops import decode_attention as da
    from gemma_tpu_torch.ops import flash_attention as fa
    from gemma_tpu_torch.ops.attention import attention_mask
    from gemma_tpu_torch.ops.ops import create_inv_timescale

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(4242)

    def randn(*shape, s=1.0):
        return torch.randn(*shape, generator=gen, device=dev).mul_(s)

    def rel_tol(want, rel):
        return rel * float(want.float().abs().max())

    # --- K4: B=4 over both pools of a seq_len=8192 cache of each kind ---
    lc = cfg.layer_configs[0]
    heads, kvh, hd = lc.heads, lc.kv_heads, lc.qkv_dim
    b = 4
    shape = f"H={heads} KVH={kvh} D={hd}"
    its = torch.from_numpy(create_inv_timescale(hd)).to(dev)
    rope = da.RopeSpec(its, 0, cfg.query_scale_value())
    pos = torch.tensor([[300], [450], [600], [700]], device=dev)
    valid = torch.tensor([[True], [True], [False], [True]], device=dev)
    qkv = randn(b, (heads + 2 * kvh) * hd, s=2.0)
    caches = {kind: random_cache(torch, cfg, kind, gen) for kind in kinds}
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
            if not torch.equal(got, f()):  # rewrites the same row
                fail(f"{name} {shape} {pool_name}: a repeat gave other bits")
            check_written_rows(torch, name, f"{shape} {pool_name}", kind, ck,
                               cp, layer)
            live = sum(min(int(q) + 1, window, ck.pool(layer)[2])
                       for q in pos[:, 0])
            row_bytes = 2 * hd * item + (8 if kind == "i8" else 0)
            nbytes = (live * kvh * row_bytes + qkv.numel() * 4
                      + b * heads * hd * 2 + b * kvh * row_bytes)
            record(res, torch, name,
                   f"B=4 {shape} {pool_name} live {live} rows (1 invalid slot)", got,
                   want, rel_tol(want, 1e-2), f, p, nbytes,
                   4 * live * (heads // kvh) * kvh * hd, primary=primary and layer == 1)

    # --- K5: the two 512-token prefill rounds (positions 0..511, then
    # 512..1023) on both pools of each kind; then where those never go: a
    # chunk whose live range wraps the 4608-row local ring (positions
    # 4352..4863), a long position on the global pool (3584..4095), and
    # per-slot prefixes (prefix_end 300, 0, 700, 100 at position 0).  Each
    # case is run twice for the same bits.  Tolerance: the exact softmax of
    # both; the kernel rounds the unnormalised probabilities to bf16 where
    # the plain version rounds the normalised ones (i8, bf16 pools: 1e-2
    # of max|out| covers a flipped bf16 probability) or neither does (f32:
    # split-TF32 products and summation order, 1e-4). ---
    t = 512
    q = randn(b, t, heads, hd, s=0.1)
    pe_slots = torch.tensor([300, 0, 700, 100], device=dev,
                            dtype=torch.int32)
    cases = [(0, 1, "global", 0), (0, 0, "local", 0), (512, 1, "global", 0),
             (512, 0, "local", 0), (4352, 0, "local, the live range "
                                    "wrapping the ring", 0),
             (3584, 1, "global, long position", 0),
             (0, 1, "global, prefix_end 300/0/700/100", pe_slots)]
    for kind, cache in caches.items():
        name = f"flash_attention_{kind}"
        item = cache.kv.element_size()
        for start, layer, pool_name, pe in cases:
            positions = (torch.arange(t, device=dev) + start)[None].repeat(b, 1)
            window = cfg.attention_window_sizes[layer]
            f = lambda: fa.flash_prefill_attention(  # noqa: E731
                cache, layer, q, positions, window, cfg.att_cap, pe)
            p = lambda: fa.flash_prefill_attention_plain(  # noqa: E731
                cache, layer, q, positions, window, cfg.att_cap, pe)
            want = p()
            got = f()
            if not torch.equal(got, f()):
                fail(f"{name} at pos {start} {pool_name}: a repeat gave "
                     "other bits")
            ring = cache.pool(layer)[2]
            mask = attention_mask(positions, ring, window, pe)
            pairs = int(mask.sum()) * heads
            live_rows = int(mask.any(dim=1).sum())  # ring rows read, all b
            row_bytes = 2 * hd * item + (8 if kind == "i8" else 0)
            nbytes = 2 * q.numel() * 4 + live_rows * kvh * row_bytes
            record(res, torch, name,
                   f"B=4 T=512 {shape} at pos {start} {pool_name} pool",
                   got, want, rel_tol(want, 1e-4 if kind == "f32" else 1e-2),
                   f, p, nbytes, 4 * pairs * hd, iters=5,
                   primary=primary and start == 512 and layer == 1)


def _set_env(name, value):
    """Set (or with None, remove) an environment switch; returns the old
    value for _set_env to restore."""
    old = os.environ.get(name)
    if value is None:
        os.environ.pop(name, None)
    else:
        os.environ[name] = value
    return old


def phase_split_attention(torch, res, cfg, kinds, primary=True):
    """K8, K10 and K11 against their plain versions at `cfg`'s head
    shape, batch 4 at positions 300, 450, 600, 700 (K4's live rows) over
    both pools (layer 0 local, layer 1 global) of a seq_len=8192 cache of
    each KV kind in `kinds`:
      - K8 with RoPE in the kernel and one invalid slot on the global
        pool, and pre-encoded (torch-op RoPE, i8 rows quantized by torch
        ops) on the local pool;
      - K10 on both pools;
      - K11 (GEMMA_SBLOCK_DECODE=1) for bf16 and f32 on both pools (bf16
        blocks of 48 and 272 rows at Gemma2-2B's shape, f32 of 16), and
        for i8 on the global pool of a seq_len=8191 cache, whose 8192 rows
        have 128-row blocks (the local pool's 4640 have none).
    Tolerances: K8 and K10 compute the plain version's exact softmax in
    another order: 1e-2 of max|out| covers a flipped bf16 probability;
    K11 rounds its exp weights against each block's max where the plain
    version rounds against the running max (the JAX suite's bound between
    the S-blocked and the one-shot kernel is 5e-3 of max|out| + 5e-3 of
    |out|): 1e-2 of max|out|.  Written rows as check_written_rows says.
    K9 is check_kv_write's."""
    from gemma_tpu_torch.ops import decode_attention as da
    from gemma_tpu_torch.ops.ops import create_inv_timescale

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5151)

    def randn(*shape, s=1.0):
        return torch.randn(*shape, generator=gen, device=dev).mul_(s)

    def rel_tol(want, rel):
        return rel * float(want.float().abs().max())

    lc = cfg.layer_configs[0]
    heads, kvh, hd = lc.heads, lc.kv_heads, lc.qkv_dim
    g = heads // kvh
    b = 4
    shape = f"H={heads} KVH={kvh} D={hd}"
    qscale = cfg.query_scale_value()
    rope = da.RopeSpec(torch.from_numpy(create_inv_timescale(hd)).to(dev), 0,
                       qscale)
    pos = torch.tensor([[300], [450], [600], [700]], device=dev)
    valid = torch.tensor([[True], [True], [False], [True]], device=dev)
    # Raw rows as the split GEMMs leave them: q [B, 1, H, D]; k and v
    # views into one [B, 1, KVH, 2, D] row (qkv2's interleave).
    q_raw = randn(b, 1, heads, hd, s=2.0)
    kv_raw = randn(b, 1, kvh, 2, hd, s=2.0)
    k_raw, v_raw = kv_raw[..., 0, :], kv_raw[..., 1, :]
    q_enc = randn(b, 1, heads, hd, s=2.0 * qscale)  # pre-encoded

    def live_rows(cache, layer, window):
        return sum(min(int(p) + 1, window, cache.pool(layer)[2])
                   for p in pos[:, 0])

    def att_bytes(kind, item, live, new_row):
        row_bytes = 2 * hd * item + (8 if kind == "i8" else 0)
        return (live * kvh * row_bytes + b * heads * hd * 4 * 2
                + (b * kvh * (2 * hd * 4 + row_bytes) if new_row else 0))

    def ops_of(live):
        return 4 * live * g * kvh * hd

    for kind in kinds:
        cache = random_cache(torch, cfg, kind, gen)
        item = cache.kv.element_size()
        # --- K8 ---
        name = f"decode_write_attend_{kind}"
        for layer, pool_name, mode in ((1, "global ring 8192", "rope"),
                                       (0, "local ring 4608", "pre-encoded")):
            window = cfg.attention_window_sizes[layer]
            vmask = valid if mode == "rope" else None
            rp = rope if mode == "rope" else None
            qq = q_raw if mode == "rope" else q_enc
            ck, cp = cache.copy(), cache.copy()
            f = lambda: da.decode_attention_write(  # noqa: E731
                ck, layer, qq, pos, k_raw, v_raw, window, cfg.att_cap, vmask,
                rp)
            p = lambda: da.decode_attention_write_plain(  # noqa: E731
                cp, layer, qq, pos, k_raw, v_raw, window, cfg.att_cap, vmask,
                rp)
            got, want = f(), p()
            if not torch.equal(got, f()):  # rewrites the same row
                fail(f"{name} {shape} {pool_name}: a repeat gave other bits")
            label = f"{shape} {pool_name} {mode}"
            check_written_rows(torch, name, label, kind, ck, cp, layer)
            sel = slice(None) if vmask is None else valid[:, 0]
            live = live_rows(ck, layer, window)
            record(res, torch, name,
                   f"B=4 {label} live {live} rows"
                   + (" (1 invalid slot)" if vmask is not None else ""),
                   got[sel], want[sel], rel_tol(want[sel], 1e-2), f, p,
                   att_bytes(kind, item, live, True), ops_of(live),
                   primary=primary and layer == 1)
        # --- K10 ---
        name = f"decode_attend_{kind}"
        for layer, pool_name in ((1, "global ring 8192"),
                                 (0, "local ring 4608")):
            window = cfg.attention_window_sizes[layer]
            f = lambda: da.decode_attention(  # noqa: E731
                cache, layer, q_enc, pos, window, cfg.att_cap)
            p = lambda: da.decode_attention_plain(  # noqa: E731
                cache, layer, q_enc, pos, window, cfg.att_cap)
            got, want = f(), p()
            if not torch.equal(got, f()):
                fail(f"{name} {shape} {pool_name}: a repeat gave other bits")
            live = live_rows(cache, layer, window)
            record(res, torch, name, f"B=4 {shape} {pool_name} live {live} "
                   "rows", got, want, rel_tol(want, 1e-2), f, p,
                   att_bytes(kind, item, live, False), ops_of(live),
                   primary=primary and layer == 1)
        # --- K11 ---
        name = f"decode_sblocked_{kind}"
        sb_cache = cache if kind != "i8" else random_cache(
            torch, cfg, kind, gen, seq_len=8191)
        old = _set_env("GEMMA_SBLOCK_DECODE", "1")
        try:
            for layer, pool_name, mode in ((1, "global", "rope"),
                                           (0, "local", "pre-encoded")):
                block = da._s_block(sb_cache, layer)
                if block is None:
                    continue
                window = cfg.attention_window_sizes[layer]
                ring = sb_cache.pool(layer)[2]
                vmask = valid if mode == "rope" else None
                rp = rope if mode == "rope" else None
                qq = q_raw if mode == "rope" else q_enc
                ck, cp = sb_cache.copy(), sb_cache.copy()
                f = lambda: da.decode_attention_write(  # noqa: E731
                    ck, layer, qq, pos, k_raw, v_raw, window, cfg.att_cap,
                    vmask, rp)
                p = lambda: da.decode_attention_write_sblocked_plain(  # noqa
                    cp, layer, qq, pos, k_raw, v_raw, window, block,
                    cfg.att_cap, vmask, rp)
                before = da.DECODE_SBLOCKED[ck.kv.dtype].launches
                got, want = f(), p()
                kern_count = da.DECODE_SBLOCKED[ck.kv.dtype].launches - before
                if kern_count != 1:
                    fail(f"{name}: GEMMA_SBLOCK_DECODE=1 did not launch K11")
                runs, run = da.sblock_split(ring, window, kvh)
                label = (f"{shape} {pool_name} ring {ring} "
                         f"(s_alloc {ck.pool(layer)[0].shape[4]}, S block "
                         f"{block}; {runs} runs of {run}) {mode}")
                check_written_rows(torch, name, label, kind, ck, cp, layer)
                same_bits(torch, f"{name} {label}", f, got)
                sel = slice(None) if vmask is None else valid[:, 0]
                live = live_rows(ck, layer, window)
                record(res, torch, name,
                       f"B=4 {label} live {live} rows"
                       + (" (1 invalid slot)" if vmask is not None else ""),
                       got[sel], want[sel], rel_tol(want[sel], 1e-2), f, p,
                       att_bytes(kind, item, live, True), ops_of(live),
                       primary=primary and layer == 1)
        finally:
            _set_env("GEMMA_SBLOCK_DECODE", old)
        del sb_cache
    torch.cuda.empty_cache()


def check_kv_write(torch, res, cfg, primary=True):
    """K9, the ring-row write from the raw rows, at `cfg`'s head shape on
    the global pool (layer 1) of a seq_len=8192 cache of each KV kind,
    batch 4 at positions 300, 450, 600, 700 with slot 2 invalid: f32 k and
    v as strided views into one interleaved [B, 1, KVH, 2, D] row (the
    split kv GEMM's layout; path M's v), contiguous f32 rows (path M's k,
    RoPE's output) and bf16 rows.  The pool and its scales must equal the
    plain version's bit for bit (an i8 row's codes and scale as
    quantize_rows makes them), the local pool stay as it was, and a
    repeat and two replays of a CUDA graph of the call write the same
    bits.  Timed beside the library composition on the same rows:
    `_pool_rows` (the cast, or quantize_rows) of the stacked rows, then
    index_copy_ of the rows (and for i8 of the scales) at their flat
    indices made beforehand."""
    from gemma_tpu_torch.ops import decode_attention as da

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(9191)
    lc = cfg.layer_configs[0]
    heads, kvh, hd = lc.heads, lc.kv_heads, lc.qkv_dim
    b, layer = 4, 1
    shape = f"H={heads} KVH={kvh} D={hd}"
    pos = torch.tensor([[300], [450], [600], [700]], device=dev)
    valid = torch.tensor([[True], [True], [False], [True]], device=dev)
    kv_raw = torch.randn(b, 1, kvh, 2, hd, generator=gen, device=dev) * 2
    kv_raw[0, 0, 1, 0] = 0.0  # an all-zero K row: scale 0
    rows = {"f32 strided views": (kv_raw[..., 0, :], kv_raw[..., 1, :]),
            "f32 contiguous": (kv_raw[..., 0, :].contiguous(),
                               kv_raw[..., 1, :].contiguous()),
            "bf16": (kv_raw[..., 0, :].to(torch.bfloat16).contiguous(),
                     kv_raw[..., 1, :].to(torch.bfloat16).contiguous())}
    for kind in ("i8", "bf16", "f32"):
        name = f"kv_write_{kind}"
        cache = random_cache(torch, cfg, kind, gen)
        for what, (k, v) in rows.items():
            ck, cp = cache.copy(), cache.copy()
            f = lambda: da.kv_write_decode(ck, layer, pos, k, v, valid)  # noqa
            p = lambda: da.kv_write_decode_plain(  # noqa: E731
                cp, layer, pos, k, v, valid)
            label = f"B=4 {shape} global ring 8192, {what}, 1 invalid slot"
            before = da.KV_WRITE[ck.kv.dtype].launches
            f()
            if da.KV_WRITE[ck.kv.dtype].launches - before != 1:
                fail(f"{name} {label}: kv_write_decode did not launch K9 "
                     "once")
            p()

            def same(tag):
                for a, w in ((ck.kv, cp.kv), (ck.kv_scale, cp.kv_scale)):
                    if a is not None and not torch.equal(a, w):
                        fail(f"{name} {label}: {tag}: the pool differs from "
                             "the plain version's")
                if not torch.equal(ck.kv_local, cache.kv_local):
                    fail(f"{name} {label}: a write to the global pool moved "
                         "the local one")

            same("first call")
            f()
            same("a repeat")
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                f()
            torch.cuda.current_stream().wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                f()
            for _ in range(2):
                graph.replay()
            torch.cuda.synchronize()
            same("two graph replays")
            del graph

            pool, idx, ring = ck.pool(layer)
            nl, s_alloc = pool.shape[1], pool.shape[4]
            bi = torch.arange(b, device=dev)
            ring_rows = torch.where(valid[:, 0], pos[:, 0] % ring,
                                    torch.full_like(pos[:, 0], ring))
            panel = ((bi[:, None, None] * nl + idx) * 2
                     + torch.arange(2, device=dev)[None, :, None]) * kvh \
                + torch.arange(kvh, device=dev)[None, None, :]
            flat = (panel * s_alloc + ring_rows[:, None, None]).reshape(-1)
            flat_pool = pool.view(-1, hd)
            sc = ck.pool_scale(layer)
            flat_sc = None if sc is None else sc.view(-1)

            def library():
                new, nsc = da._pool_rows(
                    ck, torch.stack([k[:, 0], v[:, 0]], dim=1))
                flat_pool.index_copy_(0, flat, new.reshape(-1, hd))
                if nsc is not None:
                    flat_sc.index_copy_(0, flat, nsc.reshape(-1))

            def written(c):  # [B, 2, KVH, D]: the rows K9 writes
                return c.pool(layer)[0][:, idx][bi, :, :, ring_rows]

            library()
            same("the library composition")
            in_item = k.element_size()
            record(res, torch, name, label, written(ck), written(cp), 0.0, f,
                   p, 2 * b * kvh * hd * (in_item + ck.kv.element_size())
                   + (2 * b * kvh * 4 if kind == "i8" else 0), 0,
                   primary=primary and what == "f32 strided views",
                   library=library)
        del cache
    torch.cuda.empty_cache()


def same_bits(torch, label, f, got):
    """f() again, and a CUDA graph of f replayed once, give `got`'s bits
    (K11: the runs' partials merge in one order; its tickets are zero
    again after every launch)."""
    if not torch.equal(f(), got):
        fail(f"{label}: a repeat gave other bits")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        f()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = f()
    graph.replay()
    torch.cuda.synchronize()
    if not torch.equal(out, got):
        fail(f"{label}: a graph replay gave other bits")
    del graph


def phase_sblocked_long(torch, res):
    """K11 where its split exists for: batch 1 at position 8000 (8001 live
    rows) on the global pool of a seq_len 8192 bf16 cache, at Gemma2-2B's,
    -9B's and -27B's head shapes, RoPE in the kernel; against its plain
    version (1e-2 of max|out|, as phase_split_attention holds K11), the
    written rows as check_written_rows says, a repeat and a graph replay
    bit for bit."""
    import dataclasses

    from gemma_tpu_torch.models.configs import (config_gemma2_2b,
                                                config_gemma2_9b,
                                                config_gemma2_27b)
    from gemma_tpu_torch.ops import decode_attention as da
    from gemma_tpu_torch.ops.ops import create_inv_timescale

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(8000)
    pos = torch.tensor([[8000]], device=dev)
    old = _set_env("GEMMA_SBLOCK_DECODE", "1")
    try:
        for model, full in (("2B", config_gemma2_2b()),
                            ("9B", config_gemma2_9b()),
                            ("27B", config_gemma2_27b())):
            cfg = dataclasses.replace(
                full, num_layers=2, layer_configs=full.layer_configs[:2],
                attention_window_sizes=full.attention_window_sizes[:2])
            lc = cfg.layer_configs[0]
            heads, kvh, hd = lc.heads, lc.kv_heads, lc.qkv_dim
            rope = da.RopeSpec(
                torch.from_numpy(create_inv_timescale(hd)).to(dev), 0,
                cfg.query_scale_value())
            cache = random_cache(torch, cfg, "bf16", gen, b=1)
            block = da._s_block(cache, 1)
            if block is None:
                fail(f"K11 {model}: pick_s_block finds no block for the "
                     "global pool")
            q = torch.randn(1, 1, heads, hd, generator=gen, device=dev) * 2
            kv = torch.randn(1, 1, kvh, 2, hd, generator=gen, device=dev) * 2
            k, v = kv[..., 0, :], kv[..., 1, :]
            window = cfg.attention_window_sizes[1]
            ring = cache.pool(1)[2]
            ck, cp = cache.copy(), cache.copy()
            f = lambda: da.decode_attention_write(  # noqa: E731
                ck, 1, q, pos, k, v, window, cfg.att_cap, None, rope)
            p = lambda: da.decode_attention_write_sblocked_plain(  # noqa
                cp, 1, q, pos, k, v, window, block, cfg.att_cap, None, rope)
            got, want = f(), p()
            runs, run = da.sblock_split(ring, window, kvh)
            label = (f"{model} B=1 H={heads} KVH={kvh} D={hd} global ring "
                     f"{ring}, live 8001 rows ({runs} runs of {run})")
            check_written_rows(torch, "decode_sblocked_bf16", label, "bf16",
                               ck, cp, 1)
            same_bits(torch, f"decode_sblocked_bf16 {label}", f, got)
            row_bytes = 2 * hd * 2
            record(res, torch, "decode_sblocked_bf16", label, got, want,
                   1e-2 * float(want.abs().max()), f, p,
                   8001 * kvh * row_bytes + heads * hd * 4 * 2
                   + kvh * (2 * hd * 4 + row_bytes), 4 * 8001 * heads * hd)
            del cache, ck, cp
            torch.cuda.empty_cache()
    finally:
        _set_env("GEMMA_SBLOCK_DECODE", old)


def check_top1_prob(torch, label, prob, x, w_head, fnorm, cfg, control=True,
                    **kw):
    """K3's prob [M] (kw: allowed_mask, need_prob) held three ways,
    relative per row: to the plain version (rms_norm's prologue) within
    TOP1_PROB_TOL; to the plain head on the kernels' own prologue A
    (prenorm_fixed_order: the same bf16 A, only the exp sum's order
    differs) within TOP1_PROB_TOL_SAME_A; and, with `control`, to the plain
    head on A rounded to bf16 before its norm, which must differ by more
    than TOP1_PROB_TOL (else the limit would pass such a fault)."""
    from gemma_tpu_torch.ops import matmul as mm

    def err(a, **norm):
        want = mm.matmul_top1_plain(a, w_head, final_cap=cfg.final_cap,
                                    **norm, **kw)[1]
        return float(((prob - want).abs() / want).max())

    e = err(x, prologue_norm=fnorm)
    same = err(mm.prenorm_fixed_order(x, fnorm))
    ctrl = err(x.to(torch.bfloat16).float(), prologue_norm=fnorm) \
        if control else None
    print(f"[2] {label}: prob max relative err {e:.4g} (tol "
          f"{TOP1_PROB_TOL:g}), {same:.4g} against the kernels' prologue "
          f"order (tol {TOP1_PROB_TOL_SAME_A:g})"
          + ("" if ctrl is None else
             f", bf16-A control {ctrl:.4g} (must exceed {TOP1_PROB_TOL:g})"),
          flush=True)
    if e > TOP1_PROB_TOL:
        fail(f"{label}: prob disagrees with the plain version: {e:.4g}")
    if same > TOP1_PROB_TOL_SAME_A:
        fail(f"{label}: prob disagrees with the plain head on the kernels' "
             f"prologue A: {same:.4g}")
    if ctrl is not None and ctrl <= TOP1_PROB_TOL:
        fail(f"{label}: the bf16-A control passes the prob limit "
             f"({ctrl:.4g}): the limit cannot tell a fault apart")


def clear_margin(torch, logits):
    """Rows whose top1-top2 logit margin exceeds 1e-4 of the largest finite
    |top1| or |top2| (the kernel's logits move by ~1e-6 of it, as K1's do;
    closer pairs are capped ties, which either may break)."""
    top2 = logits.topk(2, dim=-1).values
    live = torch.isfinite(top2)
    scale = float(top2[live].abs().max()) if bool(live.any()) else 1.0
    return (top2[:, 0] - top2[:, 1]) > 1e-4 * scale


def phase_top1(torch, res, x, w_head, fnorm, cfg, kind="i8"):
    """K3 at the decode head's shape: M=4, N=256000, K=2304, with the
    final norm folded in; need_prob on and off, an allowed mask of about
    1/8 of the vocab, and a mask that bans every column; then
    top1_rows_and_replays; and, for i8, the sweep of the block count.

    Tolerance: tokens equal wherever the plain version's top1-top2 margin
    exceeds 1e-4 of max|logit| (clear_margin); probs as check_top1_prob
    says."""
    from gemma_tpu_torch.ops import matmul as mm
    from gemma_tpu_torch.ops._cuda import time_ms

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
        clear = clear_margin(torch, logits)
        if allowed is banned:
            clear = torch.ones_like(clear)
            if not (bool((tok == 0).all()) and bool((want_tok == 0).all())):
                fail(f"top1_{kind} [{label}]: a row with no allowed column "
                     f"gave tokens {tok.tolist()} / {want_tok.tolist()}")
        bad = int(((tok != want_tok) & clear).sum())
        print(f"[2] top1_{kind} {label}: tokens {tok.tolist()} (plain "
              f"{want_tok.tolist()}), {int(clear.sum())} rows with a clear "
              f"margin, {bad} differ", flush=True)
        if bad or not bool(clear.any()):
            fail(f"top1_{kind} [{label}]: tokens differ from the plain version")
        check_top1_prob(torch, f"top1_{kind} {label}", prob, x, w_head, fnorm,
                        cfg, control=need_prob and allowed is not banned,
                        allowed_mask=allowed, need_prob=need_prob)
        nbytes = (x.numel() * 4 + fnorm.numel() * 4 + weight_bytes(w_head)
                  + (n if allowed is not None else 0) + 2 * x.shape[0] * 4)
        record(res, torch, f"top1_{kind}",
               f"M=4 K=2304 N=256000 (prologue folded), {label}", prob,
               want_prob, TOP1_PROB_TOL * float(want_prob.abs().max()), f, p,
               nbytes, 2 * x.shape[0] * n * x.shape[1], iters=5,
               primary=label == "prob")
    top1_rows_and_replays(torch, x, w_head, fnorm, cfg, kind)
    if kind != "i8":
        return
    # The block count is a tuning constant: more blocks lengthen the last
    # block's serial merge of their states, fewer leave SMs idle.
    # TOP1_BLOCKS caps the blocks; the launch takes no more than fit on
    # the card at once (two an SM).
    def head():
        return mm.matmul_top1(x, w_head, final_cap=cfg.final_cap,
                              prologue_norm=fnorm)

    chosen = mm.TOP1_BLOCKS
    sweep = []
    for blocks in (66, 132, 198, 264):
        mm.TOP1_BLOCKS = blocks
        sweep.append(f"{blocks}: {time_ms(head, 5):.4f}")
    mm.TOP1_BLOCKS = chosen
    print(f"[2] top1_{kind} prob, ms by TOP1_BLOCKS (the port uses {chosen}, "
          f"which the card's residency caps): {', '.join(sweep)}", flush=True)


def top1_rows_and_replays(torch, x, w_head, fnorm, cfg, kind):
    """K3 at M = 20 (two n-tiles of 8 rows, then a second row of blocks,
    grid.y = 2) against its plain version as phase_top1 holds M = 4; then
    at M = 4 a repeat and a CUDA graph replayed twice, bit for bit (the
    merges run in one order; the ticket is zero again after every
    launch)."""
    from gemma_tpu_torch.ops import matmul as mm

    gen = torch.Generator(device="cuda").manual_seed(20)
    x20 = torch.randn(20, x.shape[1], generator=gen, device="cuda") * 30
    tok, prob = mm.matmul_top1(x20, w_head, final_cap=cfg.final_cap,
                               prologue_norm=fnorm)
    want_tok, _ = mm.matmul_top1_plain(
        x20, w_head, final_cap=cfg.final_cap, prologue_norm=fnorm)
    logits = mm.matmul_plain(x20, w_head, prologue_norm=fnorm)
    clear = clear_margin(
        torch, cfg.final_cap * torch.tanh(logits / cfg.final_cap))
    del logits
    bad = int(((tok != want_tok) & clear).sum())
    print(f"[2] top1_{kind} M=20: {bad} of {int(clear.sum())} tokens with a "
          "clear margin differ", flush=True)
    if bad or not bool(clear.any()):
        fail(f"top1_{kind} [M=20]: tokens differ from the plain version")
    check_top1_prob(torch, f"top1_{kind} M=20", prob, x20, w_head, fnorm, cfg)

    def head():
        tok, prob = mm.matmul_top1(x, w_head, final_cap=cfg.final_cap,
                                   prologue_norm=fnorm)
        return torch.stack([tok.float(), prob])

    got = head()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        head()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = head()
    same = torch.equal(head(), got)
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        same = same and torch.equal(out, got)
    del graph
    print(f"[2] top1_{kind}: a repeat and two graph replays bit-identical "
          f"{same}", flush=True)
    if not same:
        fail(f"top1_{kind}: a repeat or a graph replay gave other bits")


def check_topk(torch, label, got, want, tol):
    """K6 against its plain version: values within `tol`, the same live
    entries, and indices equal wherever both neighbouring plain values are
    further apart than `tol` (closer pairs are ties either may order).
    `want` may hold one entry more than `got` (the plain version's
    (k_top + 1)-th): then the last entry's neighbour past the list counts
    too, as a logit that moves by less than `tol` may cross the list's
    edge.  Returns the max value error."""
    (vals, idxs), (wv_all, wi) = got, want
    k = vals.shape[1]
    wv, wi = wv_all[:, :k], wi[:, :k]
    live = torch.isfinite(wv)
    if not bool((torch.isfinite(vals) == live).all()):
        fail(f"{label}: live entries differ from the plain version's")
    if not bool(((idxs == 0) | live).all()):
        fail(f"{label}: a dead entry's index is not 0")
    if not bool(live.any()):
        return 0.0
    err = float((vals - wv)[live].abs().max())
    filled = torch.where(torch.isfinite(wv_all), wv_all,
                         torch.full_like(wv_all, -1e30))
    gap = (filled[:, :-1] - filled[:, 1:]) > tol
    pinned = live.clone()
    pinned[:, 1:] &= gap[:, :k - 1]
    pinned &= gap[:, :k] if wv_all.shape[1] > k else \
        torch.cat([gap[:, :k - 1], torch.ones_like(gap[:, :1])], dim=1)
    wrong = (idxs != wi) & pinned
    bad = int(wrong.sum())
    for r, j in wrong.nonzero()[:4].tolist():
        print(f"[2] {label}: row {r} rank {j}: index {int(idxs[r, j])} "
              f"value {float(vals[r, j]):.7g}, plain {int(wi[r, j])} "
              f"{float(wv[r, j]):.7g}", flush=True)
    order = bool((vals[:, :-1] >= vals[:, 1:])[live[:, 1:]].all()) \
        if vals.shape[1] > 1 else True
    print(f"[2] {label}: value max_abs_err {err:.4g} (tol {tol:.4g}), "
          f"{int(pinned.sum())} of {int(live.sum())} live entries pinned, "
          f"{bad} indices differ, descending {order}", flush=True)
    if err > tol or bad or not order or not bool(pinned.any()):
        fail(f"{label}: disagrees with the plain version")
    return err


def check_topk_values(torch, label, got, x, w_head, fnorm, cfg, k_top,
                      control=True, **kw):
    """K6's values [M, k_top] (kw: allowed_mask) held three ways, each as
    max |difference| over max |plain value|: to the plain version
    (rms_norm's prologue) within TOPK_TOL; to the plain head on the
    kernels' own prologue A (prenorm_fixed_order: the same bf16 A, only the
    order of the f32 sums differs) within TOPK_TOL_SAME_A; and, with
    `control`, to the plain head on A rounded to bf16 before its norm,
    which must differ by more than TOPK_TOL (else the limit would pass such
    a fault).  Values are compared rank by rank, so near ties that swap
    their indices do not count."""
    from gemma_tpu_torch.ops import matmul as mm

    def err(a, **norm):
        want = mm.matmul_topk_plain(a, w_head, k_top,
                                    final_cap=cfg.final_cap, **norm, **kw)[0]
        live = torch.isfinite(want)
        return float((got[0] - want)[live].abs().max()
                     / want[live].abs().max()) if bool(live.any()) else 0.0

    e = err(x, prologue_norm=fnorm)
    same = err(mm.prenorm_fixed_order(x, fnorm))
    ctrl = err(x.to(torch.bfloat16).float(), prologue_norm=fnorm) \
        if control else None
    print(f"[2] {label}: values max err {e:.4g} of max|value| (tol "
          f"{TOPK_TOL:g}), {same:.4g} against the kernels' prologue order "
          f"(tol {TOPK_TOL_SAME_A:g})"
          + ("" if ctrl is None else
             f", bf16-A control {ctrl:.4g} (must exceed {TOPK_TOL:g})"),
          flush=True)
    if e > TOPK_TOL:
        fail(f"{label}: values disagree with the plain version: {e:.4g}")
    if same > TOPK_TOL_SAME_A:
        fail(f"{label}: values disagree with the plain head on the kernels' "
             f"prologue A: {same:.4g}")
    if ctrl is not None and ctrl <= TOPK_TOL:
        fail(f"{label}: the bf16-A control passes the value limit "
             f"({ctrl:.4g}): the limit cannot tell a fault apart")


def topk_rows_and_replays(torch, kind, w_head, fnorm, cfg, label=""):
    """K6 (k_top 64, the final norm folded in, cap 30) at M = 1, 4, 13, 16
    and 20 against its plain version: indices and values as `check_topk`
    holds them (tolerance TOPK_TOL of max|value|), the values three ways
    (`check_topk_values`), each call repeated bit for bit; then at M = 4 a
    CUDA graph replayed twice, bit for bit (the selection's tickets are
    zero again after every launch)."""
    from gemma_tpu_torch.ops import matmul as mm

    gen = torch.Generator(device="cuda").manual_seed(16)
    d = w_head.k
    xs = torch.randn(20, d, generator=gen, device="cuda") * 30
    kw = dict(final_cap=cfg.final_cap, prologue_norm=fnorm)
    for m in (1, 4, 13, 16, 20):
        x = xs[:m].contiguous()
        got = mm.matmul_topk(x, w_head, 64, **kw)
        want = mm.matmul_topk_plain(x, w_head, 65, **kw)
        tag = f"topk_{kind}{label} M={m}"
        check_topk(torch, tag, got, want,
                   TOPK_TOL * float(want[0].abs().max()))
        check_topk_values(torch, tag, got, x, w_head, fnorm, cfg, 64)
        again = mm.matmul_topk(x, w_head, 64, **kw)
        if not (torch.equal(got[0], again[0]) and torch.equal(got[1],
                                                              again[1])):
            fail(f"{tag}: a repeat gave other bits")
    x = xs[:4].contiguous()

    def head():
        v, i = mm.matmul_topk(x, w_head, 64, **kw)
        return torch.cat([v, i.float()])

    got = head()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        head()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = head()
    same = True
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        same = same and torch.equal(out, got)
    del graph
    print(f"[2] topk_{kind}{label}: M in (1, 4, 13, 16, 20) within tol, "
          f"repeats bit-identical; two graph replays bit-identical {same}",
          flush=True)
    if not same:
        fail(f"topk_{kind}{label}: a graph replay gave other bits")


def phase_topk(torch, res, kind, w_head, fnorm, cfg, full=True):
    """K6 at the decode head's shape (N=256000, K=2304, the final norm
    folded in, cap 30) for one weight kind: M = 4 and 20, k_top 2, 64 and
    128 under a 1-in-8 allowed mask (k_top 64 also without), a mask that
    leaves fewer live columns than k_top, and an input whose top logits
    saturate the cap into exact ties (full=False: M=4, k_top=64 only);
    then `topk_rows_and_replays`.

    Tolerance: values within TOPK_TOL of max|logit| (the same products in
    another f32 order, and rare one-ulp flips of the bf16 prologue A where
    the kernels' sum of squares rounds the other way); indices as
    `check_topk` says."""
    import dataclasses

    from gemma_tpu_torch.ops import matmul as mm
    from gemma_tpu_torch.ops._cuda import time_ms

    name = f"topk_{kind}"
    n, d = cfg.vocab_size, cfg.model_dim
    gen = torch.Generator(device="cuda").manual_seed(77)
    mask = torch.rand(n, generator=gen, device="cuda") < 0.125
    xs = {m: torch.randn(m, d, generator=gen, device="cuda") * 30
          for m in ((4, 20) if full else (4,))}
    cases = [(4, 64, None), (4, 64, mask)]
    if full:
        cases += [(4, 2, mask), (4, 128, mask), (20, 2, mask),
                  (20, 64, mask), (20, 128, mask)]
    for m, k_top, allowed in cases:
        x = xs[m]
        kw = dict(final_cap=cfg.final_cap, prologue_norm=fnorm,
                  allowed_mask=allowed)
        f = lambda: mm.matmul_topk(x, w_head, k_top, **kw)  # noqa: E731
        p = lambda: mm.matmul_topk_plain(x, w_head, k_top, **kw)  # noqa: E731
        got = f()
        want = mm.matmul_topk_plain(x, w_head, k_top + 1, **kw)
        label = (f"M={m} K={d} N={n} k_top={k_top} (norm folded, "
                 f"selection), "
                 f"{'mask 1/8' if allowed is not None else 'no mask'}")
        tol = TOPK_TOL * float(want[0][torch.isfinite(want[0])].abs().max())
        check_topk(torch, f"{name} {label}", got, want, tol)
        want = (want[0][:, :k_top], want[1][:, :k_top])
        nbytes = (x.numel() * 4 + fnorm.numel() * 4 + weight_bytes(w_head)
                  + (n if allowed is not None else 0) + m * k_top * 8)
        if (m, k_top) == (4, 64):
            check_topk_values(torch, f"{name} {label}", got, x, w_head,
                              fnorm, cfg, k_top, allowed_mask=allowed)
        record(res, torch, name, label, got[0], want[0], tol, f, p, nbytes,
               2 * m * n * d, iters=5,
               primary=(m, k_top, allowed is not None) == (4, 64, False))
    topk_rows_and_replays(torch, kind, w_head, fnorm, cfg)
    if not full:
        return
    x = xs[4]
    # Fewer live columns than k_top: the rest is (-inf, index 0).
    few = torch.zeros(n, dtype=torch.bool, device="cuda")
    few[[5, 77, 131072, 200000, n - 1]] = True
    kw = dict(final_cap=cfg.final_cap, prologue_norm=fnorm, allowed_mask=few)
    got = mm.matmul_topk(x, w_head, 8, **kw)
    want = mm.matmul_topk_plain(x, w_head, 8, **kw)
    tol = TOPK_TOL * float(want[0][:, :5].abs().max())
    check_topk(torch, f"{name} 5 live columns, k_top=8", got, want, tol)
    if not (bool(torch.isneginf(got[0][:, 5:]).all())
            and bool((got[1][:, 5:] == 0).all())):
        fail(f"{name}: dead entries are not (-inf, 0): {got}")
    # Saturated ties: logits scaled to a spread of 100, where f32 tanh
    # gives exactly 1 for the top few hundred of a row (x / cap > 9.1), so
    # the order among those equals is the index order alone.
    spread = float(mm.matmul_plain(x, w_head, prologue_norm=fnorm).std())
    hot = dataclasses.replace(w_head, scale=w_head.scale * 100 / spread)
    kw = dict(final_cap=cfg.final_cap, prologue_norm=fnorm)
    got = mm.matmul_topk(x, hot, 64, **kw)
    want = mm.matmul_topk_plain(x, hot, 64, **kw)
    ties = int((want[0] == want[0][:, :1]).sum())
    print(f"[2] {name} saturated: {ties} of {want[0].numel()} entries tie "
          f"with their row's maximum; indices equal "
          f"{bool((got[1] == want[1]).all())}", flush=True)
    if ties < 64 or not bool((got[1] == want[1]).all()) \
            or float((got[0] - want[0]).abs().max()) > 1e-3 * cfg.final_cap:
        fail(f"{name}: saturated ties are not broken by the lower index")
    if kind != "i8":
        return

    def head():
        return mm.matmul_topk(x, w_head, 64, final_cap=cfg.final_cap,
                              prologue_norm=fnorm)

    chosen = mm.TOPK_BLOCKS
    sweep = []
    for blocks in (66, 132, 198, 264):
        mm.TOPK_BLOCKS = blocks
        sweep.append(f"{blocks}: {time_ms(head, 5):.4f}")
    mm.TOPK_BLOCKS = chosen
    print(f"[2] {name} k_top=64, ms by TOPK_BLOCKS (the port uses {chosen}, "
          f"which the card's residency caps): {', '.join(sweep)}", flush=True)
    # The selection alone as a merge: 528 sorted lists of 64 per row,
    # exact.
    m, blocks, k_top = 4, 528, 64
    pv = torch.sort(torch.randn(m, blocks, k_top, generator=gen,
                                device="cuda"), dim=-1,
                    descending=True).values.contiguous()
    pi = torch.randperm(m * blocks * k_top, generator=gen, device="cuda"
                        ).to(torch.int32).reshape(m, blocks, k_top)
    f = lambda: mm.topk_merge(pv, pi, k_top)  # noqa: E731
    p = lambda: mm.topk_merge_plain(pv, pi, k_top)  # noqa: E731
    got, want = f(), p()
    if not bool((got[1] == want[1]).all()):
        fail("topk_merge: indices differ from the plain version's")
    record(res, torch, "topk_merge", f"M={m}, {blocks} lists of {k_top}",
           got[0], want[0], 0.0, f, p,
           2 * pv.numel() * 4 + 2 * m * k_top * 4, 0, primary=True)


def phase_codecs(torch, res, cfg):
    """K1, K2, K3 and K6 at decode rows (M = 4) for sfp, bf16, f32, i4 and
    nuq4 weights (kind nuq holds SFP bytes and runs the sfp kernels: it is
    not timed twice), every case with a tensor scale != 1; the library
    call (F.linear for the dense kinds) runs alone on the normalized A at
    scale 1.  The prefill rows are phase_prefill's.

    Tolerances as for i8: 1e-3 of max|out| for f32 outputs (exact bf16
    products, f32 sums in another order, rare one-ulp flips of the
    bf16-rounded prologue A), 1e-2 for the gated GEMM's bf16 output."""
    import dataclasses

    import torch.nn.functional as F

    from gemma_tpu_torch.ops import matmul as mm
    from gemma_tpu_torch.utils.synth import synth_quant

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(4321)
    d, ff, b = cfg.model_dim, 9216, 4
    esize = {"sfp": 1, "bf16": 2, "f32": 4, "i4": 0.5625, "nuq4": 0.5625}

    def randn(*shape, s=1.0):
        return torch.randn(*shape, generator=gen, device=dev).mul_(s)

    def rel_tol(want, rel):
        return rel * float(want.float().abs().max())

    norm = randn(d, s=0.05)
    x = randn(b, d, s=30.0)
    x_bf = mm.prenorm(x, norm)  # the decode A of the library calls
    nuq = synth_quant(gen, 256, d, dev, "nuq")
    got = mm.matmul(x, nuq, prologue_norm=norm)
    want = mm.matmul_plain(x, nuq, prologue_norm=norm)
    err = float((got - want).abs().max())
    print(f"[2] kind nuq runs the sfp kernels (matmul_sfp launches "
          f"{mm.MATMUL['sfp'].launches}): M=4 N=256 max_abs_err {err:.4g}",
          flush=True)
    if err > rel_tol(want, 1e-3):
        fail("kind nuq disagrees with its plain version")
    for kind in ("sfp", "bf16", "f32", "i4", "nuq4"):
        dense = kind in ("bf16", "f32")

        def quant(n, k, scale=None, rms=None):
            w = synth_quant(gen, n, k, dev, kind, rms=rms)
            if scale is not None:
                w = dataclasses.replace(w, scale=scale)
            if w.scale == 1.0 and scale is None:
                w = dataclasses.replace(w, scale=0.37)
            return w

        # At decode the library call (dense kinds) is F.linear alone on the
        # normalized bf16 A and the same weights: no pass, no scale.
        w_qkv = quant(4096, d)
        lib = int4pack(torch, x_bf, w_qkv) if kind == "i4" else None
        if dense:
            a_lib = x_bf.to(w_qkv.arrays["w"].dtype)
            lib = lambda: F.linear(a_lib, w_qkv.arrays["w"])  # noqa: E731
        f = lambda: mm.matmul(x, w_qkv, prologue_norm=norm)  # noqa: E731
        p = lambda: mm.matmul_plain(x, w_qkv, prologue_norm=norm)  # noqa
        want = p()
        record(res, torch, f"matmul_{kind}",
               f"decode qkv M=4 K={d} N=4096 (prologue folded), scale "
               f"{w_qkv.scale:.3g}", f(), want, rel_tol(want, 1e-3), f, p,
               b * d * 4 + d * 4 + weight_bytes(w_qkv) + b * 4096 * 4,
               2 * b * 4096 * d, primary=True, library=lib)
        w_lin = quant(d, ff)
        a = randn(b, ff, s=3.0).to(torch.bfloat16)
        post, add = randn(d, s=0.05), randn(b, d, s=10.0)
        lib = int4pack(torch, a, w_lin) if kind == "i4" else None
        if dense:
            a_lin = a.to(w_lin.arrays["w"].dtype)
            lib = lambda: F.linear(a_lin, w_lin.arrays["w"])  # noqa: E731
        f = lambda: mm.matmul(a, w_lin, epilogue_norm=post, add=add)  # noqa
        p = lambda: mm.matmul_plain(a, w_lin, epilogue_norm=post,  # noqa
                                    add=add)
        want = p()
        record(res, torch, f"matmul_{kind}",
               f"decode linear M=4 K={ff} N={d} (epilogue folded)", f(), want,
               rel_tol(want, 1e-3), f, p,
               b * ff * 2 + weight_bytes(w_lin) + b * d * 4, 2 * b * d * ff,
               library=lib)
        check_decode_rows(torch, gen, f"matmul_{kind} decode qkv", d,
                          lambda a: mm.matmul(a, w_qkv),
                          lambda a: mm.matmul_plain(a, w_qkv), 1e-3)
        # K split over a cluster of blocks (decode_split: 9216 > 4608).
        check_decode_rows(torch, gen, f"matmul_{kind} decode linear", ff,
                          lambda a: mm.matmul(a, w_lin),
                          lambda a: mm.matmul_plain(a, w_lin), 1e-3)
        check_one_hot_rows(torch, f"matmul_{kind}", w_qkv)
        del w_lin
        g1, g2 = quant(ff, d), quant(ff, d)
        lib = int4pack(torch, x_bf, g1, g2) if kind == "i4" else None
        if dense:
            a_g = x_bf.to(g1.arrays["w"].dtype)
            lib = lambda: F.gelu(F.linear(a_g, g1.arrays["w"]),  # noqa
                                 approximate="tanh") * F.linear(
                a_g, g2.arrays["w"])
        f = lambda: mm.gated_ffn(x, g1, g2, prologue_norm=norm)  # noqa: E731
        p = lambda: mm.gated_ffn_plain(x, g1, g2, prologue_norm=norm)  # noqa
        want = p()
        record(res, torch, f"gated_{kind}",
               f"decode M=4 K={d} N={ff} (prologue folded), scales "
               f"{g1.scale:.3g}", f(), want, rel_tol(want, 1e-2), f, p,
               b * d * 4 + 2 * weight_bytes(g1) + b * ff * 2, 4 * b * ff * d,
               primary=True, library=lib)
        check_decode_rows(torch, gen, f"gated_{kind} decode", d,
                          lambda a: mm.gated_ffn(a, g1, g2),
                          lambda a: mm.gated_ffn_plain(a, g1, g2), 1e-2)
        fused_rows(torch, gen, kind, w_qkv, g1, g2, d, ff)
        del g1, g2, w_qkv
        # The heads, at the embedding's size.
        w_head = quant(cfg.vocab_size, d)
        fnorm = randn(d, s=0.05)
        n = cfg.vocab_size
        assert weight_bytes(w_head) == n * d * esize[kind]
        if kind in ("i4", "nuq4"):
            # The packed kinds take K3's whole case list (prob, no prob,
            # masks, M=20) and K6's.
            phase_top1(torch, res, x, w_head, fnorm, cfg, kind)
            phase_topk(torch, res, kind, w_head, fnorm, cfg)
            del w_head
            torch.cuda.empty_cache()
            continue
        kw = dict(final_cap=cfg.final_cap, prologue_norm=fnorm)
        f = lambda: mm.matmul_top1(x, w_head, **kw)  # noqa: E731
        p = lambda: mm.matmul_top1_plain(x, w_head, **kw)  # noqa: E731
        (tok, prob), (want_tok, want_prob) = f(), p()
        logits = mm.matmul_plain(x, w_head, prologue_norm=fnorm)
        clear = clear_margin(
            torch, cfg.final_cap * torch.tanh(logits / cfg.final_cap))
        del logits
        bad = int(((tok != want_tok) & clear).sum())
        print(f"[2] top1_{kind}: tokens {tok.tolist()} (plain "
              f"{want_tok.tolist()}), {int(clear.sum())} rows with a clear "
              f"margin, {bad} differ", flush=True)
        if bad or not bool(clear.any()):
            fail(f"top1_{kind}: tokens differ from the plain version")
        check_top1_prob(torch, f"top1_{kind} prob", prob, x, w_head, fnorm,
                        cfg)
        record(res, torch, f"top1_{kind}",
               f"M=4 K={d} N={n} (prologue folded), prob, scale "
               f"{w_head.scale:.3g}", prob, want_prob,
               TOP1_PROB_TOL * float(want_prob.abs().max()), f, p,
               x.numel() * 4 + d * 4 + w_head.nbytes() + 2 * b * 4,
               2 * b * n * d, iters=5, primary=True)
        top1_rows_and_replays(torch, x, w_head, fnorm, cfg, kind)
        phase_topk(torch, res, kind, w_head, fnorm, cfg, full=kind != "f32")
        del w_head
        torch.cuda.empty_cache()


def phase_k7b(torch, res):
    """K7b beyond phase_codecs' Gemma2-2B-width cases: the decode GEMMs and
    heads at the widths of the models the packed kinds serve here (i4 and
    nuq4 at Gemma2-27B's, nuq4 at Gemma2-9B's), a weight whose codes
    encode their own column (a one-hot A then reads single dequantized
    weights back, which pins which A columns a lane pairs with the low and
    the high nibbles), and nuq4 tables with all-equal entries, with
    repeated entries and with -0.0 (0x80) bytes.  Tolerances as in
    phase_codecs."""
    import dataclasses

    from gemma_tpu_torch.models.configs import (config_gemma2_9b,
                                                config_gemma2_27b)
    from gemma_tpu_torch.ops import matmul as mm
    from gemma_tpu_torch.utils.synth import EMBEDDING_RMS, synth_quant

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2727)
    b = 4

    def randn(*shape, s=1.0):
        return torch.randn(*shape, generator=gen, device=dev).mul_(s)

    def rel_tol(want, rel):
        return rel * float(want.float().abs().max())

    for kind, cfg, width in (("i4", config_gemma2_27b(), "27B"),
                             ("nuq4", config_gemma2_27b(), "27B"),
                             ("nuq4", config_gemma2_9b(), "9B")):
        lc = cfg.layer_configs[0]
        d, ff, n_vocab = cfg.model_dim, lc.ff_hidden_dim, cfg.vocab_size
        n_qkv = (lc.heads + 2 * lc.kv_heads) * lc.qkv_dim
        k_att = lc.heads * lc.qkv_dim
        x, norm = randn(b, d, s=30.0), randn(d, s=0.05)
        post, add = randn(d, s=0.05), randn(b, d, s=10.0)
        x_bf = mm.prenorm(x, norm)  # the library calls' A
        w = synth_quant(gen, n_qkv, d, dev, kind)
        f = lambda: mm.matmul(x, w, prologue_norm=norm)  # noqa: E731
        p = lambda: mm.matmul_plain(x, w, prologue_norm=norm)  # noqa: E731
        want = p()
        record(res, torch, f"matmul_{kind}",
               f"{width} decode qkv M=4 K={d} N={n_qkv} (prologue folded)", f(),
               want, rel_tol(want, 1e-3), f, p,
               b * d * 4 + d * 4 + weight_bytes(w) + b * n_qkv * 4,
               2 * b * n_qkv * d,
               library=int4pack(torch, x_bf, w) if kind == "i4" else None)
        check_decode_rows(torch, gen, f"matmul_{kind} {width} decode qkv", d,
                          lambda a, w=w: mm.matmul(a, w),
                          lambda a, w=w: mm.matmul_plain(a, w), 1e-3)
        for name, k_in in (("att_w", k_att), ("linear", ff)):
            w = synth_quant(gen, d, k_in, dev, kind)
            a = randn(b, k_in, s=3.0).to(torch.bfloat16)
            f = lambda: mm.matmul(a, w, epilogue_norm=post, add=add)  # noqa
            p = lambda: mm.matmul_plain(a, w, epilogue_norm=post,  # noqa
                                        add=add)
            want = p()
            record(res, torch, f"matmul_{kind}",
                   f"{width} decode {name} M=4 K={k_in} N={d} (epilogue "
                   "folded)", f(), want, rel_tol(want, 1e-3), f, p,
                   b * k_in * 2 + weight_bytes(w) + 2 * b * d * 4,
                   2 * b * d * k_in,
                   library=int4pack(torch, a, w) if kind == "i4" else None)
            if name == "linear":  # K split over a cluster of 4 or 8 blocks
                check_decode_rows(
                    torch, gen, f"matmul_{kind} {width} decode linear", k_in,
                    lambda a, w=w: mm.matmul(a, w),
                    lambda a, w=w: mm.matmul_plain(a, w), 1e-3)
        g1 = synth_quant(gen, ff, d, dev, kind)
        g2 = synth_quant(gen, ff, d, dev, kind)
        f = lambda: mm.gated_ffn(x, g1, g2, prologue_norm=norm)  # noqa: E731
        p = lambda: mm.gated_ffn_plain(x, g1, g2, prologue_norm=norm)  # noqa
        want = p()
        record(res, torch, f"gated_{kind}",
               f"{width} decode M=4 K={d} N={ff} (prologue folded)", f(), want,
               rel_tol(want, 1e-2), f, p,
               b * d * 4 + 2 * weight_bytes(g1) + b * ff * 2, 4 * b * ff * d,
               library=int4pack(torch, x_bf, g1, g2) if kind == "i4" else None)
        check_decode_rows(torch, gen, f"gated_{kind} {width} decode", d,
                          lambda a: mm.gated_ffn(a, g1, g2),
                          lambda a: mm.gated_ffn_plain(a, g1, g2), 1e-2)
        del g1, g2, w
        w_head = synth_quant(gen, n_vocab, d, dev, kind, rms=EMBEDDING_RMS)
        kw = dict(final_cap=cfg.final_cap, prologue_norm=norm)
        f = lambda: mm.matmul_top1(x, w_head, **kw)  # noqa: E731
        p = lambda: mm.matmul_top1_plain(x, w_head, **kw)  # noqa: E731
        (tok, prob), (want_tok, want_prob) = f(), p()
        logits = mm.matmul_plain(x, w_head, prologue_norm=norm)
        clear = clear_margin(
            torch, cfg.final_cap * torch.tanh(logits / cfg.final_cap))
        del logits
        bad = int(((tok != want_tok) & clear).sum())
        print(f"[2] top1_{kind} {width}: tokens {tok.tolist()} (plain "
              f"{want_tok.tolist()}), {int(clear.sum())} rows with a clear "
              f"margin, {bad} differ", flush=True)
        if bad or not bool(clear.any()):
            fail(f"top1_{kind} [{width}]: tokens differ from the plain "
                 "version")
        check_top1_prob(torch, f"top1_{kind} {width} prob", prob, x, w_head,
                        norm, cfg)
        head_bytes = x.numel() * 4 + d * 4 + weight_bytes(w_head)
        record(res, torch, f"top1_{kind}",
               f"{width} M=4 K={d} N={n_vocab} (prologue folded), prob", prob,
               want_prob, TOP1_PROB_TOL * float(want_prob.abs().max()), f, p,
               head_bytes + 2 * b * 4, 2 * b * n_vocab * d, iters=5)
        f = lambda: mm.matmul_topk(x, w_head, 64, **kw)  # noqa: E731
        p = lambda: mm.matmul_topk_plain(x, w_head, 64, **kw)  # noqa: E731
        got = f()
        want = mm.matmul_topk_plain(x, w_head, 65, **kw)
        tol = TOPK_TOL * float(want[0].abs().max())
        label = (f"{width} M=4 K={d} N={n_vocab} k_top=64 (norm folded, "
                 "selection)")
        check_topk(torch, f"topk_{kind} {label}", got, want, tol)
        want = (want[0][:, :64], want[1][:, :64])
        check_topk_values(torch, f"topk_{kind} {label}", got, x, w_head,
                          norm, cfg, 64)
        record(res, torch, f"topk_{kind}", label, got[0], want[0], tol, f, p,
               head_bytes + b * 64 * 8, 2 * b * n_vocab * d, iters=5)
        if (kind, width) in (("i4", "27B"), ("nuq4", "9B")):
            topk_rows_and_replays(torch, kind, w_head, norm, cfg, f" {width}")
        del w_head
        torch.cuda.empty_cache()

    # --- which A columns meet which nibbles ---
    n, k = 64, 1024
    cols = torch.arange(k, device=dev)
    rows = torch.arange(n, device=dev)
    # Neighbours in a byte (j, 128 + j), in a step (j, j + 1) and across
    # 16-byte lane loads all get different codes.
    codes = (cols[None, :] * 7 + rows[:, None] * 3 + cols[None, :] // 16) % 16
    packed = torch.from_numpy(mm.pack_nuq4(
        codes.to(torch.uint8).cpu().numpy())).to(dev)
    sel = torch.tensor([0, 1, 2, 3, 127, 128, 129, 255, 256, 300, 511, 640,
                        777, 1000, 1023, 64, 65, 191, 192, 16], device=dev)
    # 110 more distinct columns for the prefill tile's 130 rows.
    rest = torch.ones(k, dtype=torch.bool, device=dev)
    rest[sel] = False
    rest = rest.nonzero()[:, 0]
    sel = torch.cat([sel, rest[torch.randperm(
        len(rest), generator=gen, device=dev)[:110]]])
    for kind in ("i4", "nuq4"):
        base = synth_quant(gen, n, k, dev, kind)
        w = dataclasses.replace(base, arrays={**base.arrays, "codes": packed})
        want_all = w.dequantize()
        # the decode tile (one n-tile of A's rows to 8, two above); the
        # prefill tile (M > 16), its second block of rows holding 2 at M =
        # 130
        for m in (*DECODE_ROWS_CHECKED, 20, 130):
            a = torch.zeros(m, k, device=dev)
            a[torch.arange(m), sel[:m]] = 1.0
            got = mm.matmul(a.to(torch.bfloat16), w)
            want = want_all[:, sel[:m]].T
            err = float((got - want).abs().max())
            tol = 1e-6 * float(want.abs().max())
            print(f"[2] matmul_{kind} one-hot A, M={m}: each output is one "
                  f"dequantized weight; max_abs_err {err:.3g} (tol "
                  f"{tol:.3g})", flush=True)
            if err > tol:
                fail(f"matmul_{kind}: a nibble is paired with the wrong A "
                     "column")

    # --- nuq4 tables: all-equal, repeated and -0.0 entries ---
    base = synth_quant(gen, n, k, dev, "nuq4")
    blocks = k // 256
    entries = base.arrays["tables"][:, :blocks * 16].reshape(n, blocks, 16)
    entries = entries.clone()
    entries[:21] = entries[:21, :, :1]                    # all 16 equal
    entries[21:42] = entries[21:42, :, [0] * 6 + [7] * 5 + [15] * 5]
    entries[42:, :, 3] = 0x80                             # -0.0
    entries[42:, :, 4] = 0x00
    tables = base.arrays["tables"].clone()
    tables[:, :blocks * 16] = entries.reshape(n, -1)
    w = dataclasses.replace(base, arrays={**base.arrays, "tables": tables})
    a = randn(b, k).to(torch.bfloat16)
    got, want = mm.matmul(a, w), mm.matmul_plain(a, w)
    err, tol = float((got - want).abs().max()), rel_tol(want, 1e-3)
    hot = torch.zeros(16, k, device=dev)
    hot[torch.arange(16), sel[:16]] = 1.0
    err_hot = float((mm.matmul(hot.to(torch.bfloat16), w)
                     - w.dequantize()[:, sel[:16]].T).abs().max())
    print(f"[2] matmul_nuq4 tables with all-equal, repeated and -0.0 "
          f"entries: max_abs_err {err:.3g} (tol {tol:.3g}); one-hot reads "
          f"max_abs_err {err_hot:.3g} (exact)", flush=True)
    if err > tol or err_hot != 0.0:
        fail("matmul_nuq4 disagrees with its plain version on degenerate "
             "tables")


def phase_k12(torch, res):
    """K12, the stacked K1 and K2 (ops/matmul.py `matmul(..., layer=)`,
    `gated_ffn(..., layer=)`), for every kind (nuq runs the sfp kernels) at
    Gemma2-2B widths over T = 13 stacked layers, at layers t = 0, 6 and
    12: the qkv GEMM with its prologue norm, att_w and linear with the
    post-norm + residual, and the gated GEMM with its prologue, all folded
    into the kernel; then i4 at Gemma2-27B widths over T = 2, at t = 0 and
    1; and `fused_rows` on the middle layer.  Each is held
    against its plain version (take_layer, then the unstacked plain
    version) at K1's and K2's tolerances (1e-3 and 1e-2 of max|out|); the
    middle layer is timed beside the unstacked kernel on that layer alone
    ("unstacked_ms") and beside the library call on that layer: F.linear
    on the w[t] view for bf16 and f32, torch._weight_int4pack_mm on its
    repacked codes for i4 (`int4pack`)."""
    import dataclasses

    import torch.nn.functional as F

    from gemma_tpu_torch.models.configs import (config_gemma2_2b,
                                                config_gemma2_27b)
    from gemma_tpu_torch.ops import matmul as mm
    from gemma_tpu_torch.ops._cuda import time_ms
    from gemma_tpu_torch.utils.synth import synth_quant

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1212)
    b = 4

    def randn(*shape, s=1.0):
        return torch.randn(*shape, generator=gen, device=dev).mul_(s)

    def stacked(n, k, kind, t_layers):
        ws = [synth_quant(gen, n, k, dev, kind) for _ in range(t_layers)]
        # One tensor scale across layers, as stacking needs (nuq4's synth
        # scale is per tensor).
        ws = [dataclasses.replace(w, scale=ws[0].scale) for w in ws]
        return mm.stack_quant_tensors(ws)

    for kind, cfg, t_layers, width in (
            *((k, config_gemma2_2b(), 13, "2B") for k in
              ("i8", "sfp", "nuq", "bf16", "f32", "i4", "nuq4")),
            ("i4", config_gemma2_27b(), 2, "27B")):
        codec = "sfp" if kind == "nuq" else kind
        lc = cfg.layer_configs[0]
        d, ff = cfg.model_dim, lc.ff_hidden_dim
        n_qkv = (lc.heads + 2 * lc.kv_heads) * lc.qkv_dim
        k_att = lc.heads * lc.qkv_dim
        dense = kind in ("bf16", "f32")
        ts = (0, t_layers // 2, t_layers - 1)
        x, norm = randn(b, d, s=30.0), randn(d, s=0.05)
        post, add = randn(d, s=0.05), randn(b, d, s=10.0)
        a_att = randn(b, k_att, s=3.0).to(torch.bfloat16)
        a_lin = randn(b, ff, s=3.0).to(torch.bfloat16)
        x_bf = mm.prenorm(x, norm)
        lib_a = x_bf if kind == "bf16" else x_bf.float()
        cases = []
        w = w_qkv = stacked(n_qkv, d, kind, t_layers)
        cases.append((
            "matmul", f"{width} {kind} qkv M=4 K={d} N={n_qkv} (prologue folded)",
            w, None, lambda t, w=w: mm.matmul(x, w, prologue_norm=norm,
                                              layer=t),
            lambda t, w=w: mm.matmul_plain(x, mm.take_layer(w, t),
                                           prologue_norm=norm),
            lambda wl: mm.matmul(x, wl, prologue_norm=norm),
            (lambda t, w=w: F.linear(lib_a, w.arrays["w"][t])) if dense
            else None, x_bf, b * d * 4 + b * n_qkv * 4, 2 * b * n_qkv * d,
            1e-3))
        for name, a_in, k_in in (("att_w", a_att, k_att),
                                 ("linear", a_lin, ff)):
            w = stacked(d, k_in, kind, t_layers)
            lib_in = a_in if kind == "bf16" else a_in.float()
            cases.append((
                "matmul", f"{width} {kind} {name} M=4 K={k_in} N={d} "
                "(epilogue folded)", w, None,
                lambda t, w=w, a=a_in: mm.matmul(a, w, epilogue_norm=post,
                                                 add=add, layer=t),
                lambda t, w=w, a=a_in: mm.matmul_plain(
                    a, mm.take_layer(w, t), epilogue_norm=post, add=add),
                lambda wl, a=a_in: mm.matmul(a, wl, epilogue_norm=post,
                                             add=add),
                (lambda t, w=w, a=lib_in: F.linear(a, w.arrays["w"][t]))
                if dense else None, a_in, b * k_in * 2 + 2 * b * d * 4,
                2 * b * d * k_in, 1e-3))
        g1, g2 = stacked(ff, d, kind, t_layers), stacked(ff, d, kind,
                                                         t_layers)
        cases.append((
            "gated", f"{width} {kind} M=4 K={d} N={ff} (prologue folded)",
            g1, g2,
            lambda t: mm.gated_ffn(x, g1, g2, prologue_norm=norm, layer=t),
            lambda t: mm.gated_ffn_plain(x, mm.take_layer(g1, t),
                                         mm.take_layer(g2, t),
                                         prologue_norm=norm),
            None,
            (lambda t: F.gelu(F.linear(lib_a, g1.arrays["w"][t]),
                              approximate="tanh")
             * F.linear(lib_a, g2.arrays["w"][t])) if dense else None, x_bf,
            b * d * 4 + b * ff * 2, 4 * b * ff * d, 1e-2))
        for op, label, w, w2, kern, plain, unstacked, lib, a_lib, io_bytes, \
                ops, rel in cases:
            name = f"{op}_stacked_{codec}"
            for t in ts:
                if t == ts[1]:
                    continue
                want = plain(t)
                err = float((kern(t).float() - want.float()).abs().max())
                tol = rel * float(want.float().abs().max())
                print(f"[2] {name:24s} {label} layer {t}/{t_layers}: "
                      f"max_abs_err {err:.4g} (tol {tol:.4g})", flush=True)
                if err > tol:
                    fail(f"{name} [{label}] layer {t} disagrees with its "
                         "plain version")
            t = ts[1]
            wl = mm.take_layer(w, t)
            w2l = None if w2 is None else mm.take_layer(w2, t)
            nbytes = io_bytes + weight_bytes(wl) * (1 if w2 is None else 2)
            want = plain(t)
            # The library call on layer t alone: F.linear on the w[t] view
            # (dense kinds), torch._weight_int4pack_mm on its repacked codes
            # (i4).
            library = (int4pack(torch, a_lib, wl, w2l) if kind == "i4"
                       else None if lib is None else (lambda: lib(t)))
            record(res, torch, name, f"{label} layer {t}/{t_layers}",
                   kern(t), want, rel * float(want.float().abs().max()),
                   lambda: kern(t), lambda: plain(t), nbytes, ops,
                   primary=width == "2B" and kind == codec
                   and (op == "gated" or "qkv" in label),
                   library=library)
            if w2 is None:
                u_ms = time_ms(lambda: unstacked(wl))
            else:
                u_ms = time_ms(lambda: mm.gated_ffn(
                    x, wl, w2l, prologue_norm=norm))
            res[name]["cases"][-1]["unstacked_ms"] = u_ms
            print(f"[2] {name:24s} {label} layer {t}: unstacked kernel on "
                  f"the layer alone {u_ms:.4f} ms", flush=True)
            if "att_w" not in label:  # the stacked tile at every row count
                k_in = a_lib.shape[1]
                if w2 is None:
                    check_decode_rows(
                        torch, gen, f"{name} {label.split(' M=')[0]} layer "
                        f"{t}", k_in,
                        lambda a, w=w, t=t: mm.matmul(a, w, layer=t),
                        lambda a, wl=wl: mm.matmul_plain(a, wl), rel)
                else:
                    check_decode_rows(
                        torch, gen, f"{name} {label.split(' M=')[0]} layer "
                        f"{t}", k_in,
                        lambda a, t=t: mm.gated_ffn(a, w, w2, layer=t),
                        lambda a: mm.gated_ffn_plain(a, wl, w2l), rel)
        fused_rows(torch, gen, kind, w_qkv, g1, g2, d, ff, layer=ts[1])
        del cases, w, w_qkv, g1, g2
        torch.cuda.empty_cache()


def phase_prefill(torch, res):
    """K1 and K2 at prefill rows: matmul_sm90.cu's wgmma tile (entries
    matmul_sm90_<kind>, gated_sm90_<kind>), which takes every M > 16.

    Timed at M = 2048 (path A's first prefill round, 4 x 512 rows), bf16
    A, f32 out (K2: bf16), no passes (the prefill branch norms and adds in
    torch ops), for every kind at Gemma2-2B widths (qkv, att_w, linear and
    the gated FFN; kind nuq through the sfp kernels), i4 at Gemma2-27B's
    and nuq4 at Gemma2-9B's, each beside its plain version, its ops bound
    and the library call: F.linear (gelu(linear) * linear for K2) on the
    same A and weights for bf16 and f32, whose synthetic weights have
    scale 1; torch._weight_int4pack_mm on the codes repacked for i4
    (`int4pack`).  Then, untimed, on a 264 x 1024 weight of each kind at
    scale != 1 (N past a 128-column tile, K over 16 stages): ragged rows
    (M = 17, 130, 1143) for K1 and K2, the prologue and epilogue passes at
    M = 130, a stacked weight's layer (K12) at M = 130, and a one-hot A of
    130 rows whose outputs are single weights (a misplaced k names its
    16-byte chunk and stage); and a decode entry handed 17 rows, which must
    raise.  Tolerances as phase_codecs': 1e-3 of max|out| for f32 outputs,
    1e-2 for the gated GEMM's bf16 output; the one-hot reads 1e-6 (single
    products; i8 closes inv * c - inv * zp against inv * (c - zp))."""
    import dataclasses

    import torch.nn.functional as F

    from gemma_tpu_torch.models.configs import (config_gemma2_2b,
                                                config_gemma2_9b,
                                                config_gemma2_27b)
    from gemma_tpu_torch.ops import matmul as mm
    from gemma_tpu_torch.utils.synth import synth_quant

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2048)
    m = 4 * 512

    def randn(*shape, s=1.0):
        return torch.randn(*shape, generator=gen, device=dev).mul_(s)

    def rel_tol(want, rel):
        return rel * float(want.float().abs().max())

    def library(kind, a, w, w2=None):
        if kind == "i4":
            return int4pack(torch, a, w, w2)
        if kind not in ("bf16", "f32"):
            return None
        al = a.to(w.arrays["w"].dtype)
        if w2 is None:
            return lambda: F.linear(al, w.arrays["w"])
        return lambda: F.gelu(F.linear(al, w.arrays["w"]),
                              approximate="tanh") * F.linear(al,
                                                             w2.arrays["w"])

    for width, cfg, kinds in (
            ("2B", config_gemma2_2b(),
             ("i8", "sfp", "nuq", "bf16", "f32", "i4", "nuq4")),
            ("27B", config_gemma2_27b(), ("i4",)),
            ("9B", config_gemma2_9b(), ("nuq4",))):
        lc = cfg.layer_configs[0]
        d, ff = cfg.model_dim, lc.ff_hidden_dim
        n_qkv = (lc.heads + 2 * lc.kv_heads) * lc.qkv_dim
        k_att = lc.heads * lc.qkv_dim
        for kind in kinds:
            codec = "sfp" if kind == "nuq" else kind
            primary = width == "2B" and kind == codec
            for name, n, k in (("qkv", n_qkv, d), ("att_w", d, k_att),
                               ("linear", d, ff)):
                w = synth_quant(gen, n, k, dev, kind)
                a = randn(m, k).to(torch.bfloat16)
                f = lambda: mm.matmul(a, w)  # noqa: E731
                p = lambda: mm.matmul_plain(a, w)  # noqa: E731
                want = p()
                record(res, torch, f"matmul_sm90_{codec}",
                       f"{width} {kind} prefill {name} M={m} K={k} N={n}, "
                       f"scale {w.scale:.3g}", f(), want, rel_tol(want, 1e-3),
                       f, p, m * k * 2 + weight_bytes(w) + m * n * 4,
                       2 * m * n * k, iters=5,
                       primary=primary and name == "qkv",
                       library=library(kind, a, w))
                del w, want
            g1 = synth_quant(gen, ff, d, dev, kind)
            g2 = synth_quant(gen, ff, d, dev, kind)
            a = randn(m, d).to(torch.bfloat16)
            f = lambda: mm.gated_ffn(a, g1, g2)  # noqa: E731
            p = lambda: mm.gated_ffn_plain(a, g1, g2)  # noqa: E731
            want = p()
            record(res, torch, f"gated_sm90_{codec}",
                   f"{width} {kind} prefill M={m} K={d} N={ff}, scales "
                   f"{g1.scale:.3g}", f(), want, rel_tol(want, 1e-2), f, p,
                   m * d * 2 + 2 * weight_bytes(g1) + m * ff * 2,
                   4 * m * ff * d, iters=5, primary=primary,
                   library=library(kind, a, g1, g2))
            del g1, g2, want
            torch.cuda.empty_cache()

    n, k = 264, 1024
    sel = torch.randperm(k, generator=gen, device=dev)[:130]
    hot = torch.zeros(130, k, device=dev)
    hot[torch.arange(130, device=dev), sel] = 1.0
    hot = hot.to(torch.bfloat16)

    def quant(kind):
        w = synth_quant(gen, n, k, dev, kind)
        return w if w.scale != 1.0 else dataclasses.replace(w, scale=0.37)

    def check(label, got, want, rel):
        err = float((got.float() - want.float()).abs().max())
        tol = rel * float(want.float().abs().max())
        if not torch.isfinite(got.float()).all() or err > tol:
            fail(f"{label}: max_abs_err {err} > {tol}")
        return err / float(want.float().abs().max())

    for kind in ("i8", "sfp", "bf16", "f32", "i4", "nuq4"):
        w, w2 = quant(kind), quant(kind)
        errs = []
        for rows in (17, 130, 1143):
            a = randn(rows, k).to(torch.bfloat16)
            errs.append(check(f"matmul_sm90_{kind} M={rows}", mm.matmul(a, w),
                              mm.matmul_plain(a, w), 1e-3))
            errs.append(check(f"gated_sm90_{kind} M={rows}",
                              mm.gated_ffn(a, w, w2),
                              mm.gated_ffn_plain(a, w, w2), 1e-2))
        x, norm = randn(130, k, s=30.0), randn(k, s=0.05)
        post, add = randn(n, s=0.05), randn(130, n, s=10.0)
        kw = dict(prologue_norm=norm, epilogue_norm=post, add=add)
        errs.append(check(f"matmul_sm90_{kind} M=130 +pre +post",
                          mm.matmul(x, w, **kw), mm.matmul_plain(x, w, **kw),
                          1e-3))
        errs.append(check(f"gated_sm90_{kind} M=130 +pre",
                          mm.gated_ffn(x, w, w2, prologue_norm=norm),
                          mm.gated_ffn_plain(x, w, w2, prologue_norm=norm),
                          1e-2))
        layers = [w] + [dataclasses.replace(quant(kind), scale=w.scale)
                        for _ in range(2)]
        st = mm.stack_quant_tensors(layers)
        a = randn(130, k).to(torch.bfloat16)
        errs.append(check(f"matmul_sm90_{kind} stacked layer 2 M=130",
                          mm.matmul(a, st, layer=2),
                          mm.matmul_plain(a, mm.take_layer(st, 2)), 1e-3))
        errs.append(check(f"gated_sm90_{kind} stacked layer 1 M=130",
                          mm.gated_ffn(a, st, st, layer=1),
                          mm.gated_ffn_plain(a, mm.take_layer(st, 1),
                                             mm.take_layer(st, 1)), 1e-2))
        got, want = mm.matmul(hot, w), mm.matmul_plain(hot, w)
        bad = (got - want).abs() > 1e-6 * float(want.abs().max())
        if bool(bad.any()):
            r, c = bad.nonzero()[0].tolist()
            kk = int(sel[r])
            fail(f"matmul_sm90_{kind}: one-hot row {r} (k {kk}: stage "
                 f"{kk // 64}, 16-byte chunk {kk % 64 // 8}, nibble half "
                 f"{kk % 256 // 128}) column {c} reads {float(got[r, c])}, "
                 f"not the weight {float(want[r, c])}; {int(bad.sum())} "
                 "outputs misplaced")
        print(f"[2] prefill tile {kind}: M=17/130/1143 K1 and K2, M=130 with "
              f"the passes, stacked layers, one-hot reads of 130 weights "
              f"exact; max rel err {max(errs):.3g}", flush=True)
    # A decode entry refuses prefill rows: routed there, 17 rows raise.
    w = quant("i8")
    saved, mm.DECODE_ROWS = mm.DECODE_ROWS, 4096
    try:
        mm.matmul(randn(17, k).to(torch.bfloat16), w)
    except RuntimeError as e:
        print(f"[2] the i8 decode entry refuses 17 rows: {e}", flush=True)
    else:
        fail("the decode entry took 17 rows")
    finally:
        mm.DECODE_ROWS = saved


def phase_k13(torch, res):
    """K13, the nuq4 gather diagnostic (gemma_tpu_torch/ops/nuq_diag.py),
    D1, D2 and D3 at its script's shape (M=16, K=2304, N=9216, codes
    pre-offset below 128) and at the decode batch (M=4), and D1 and D2
    again on codes over all 256 bytes, where they part; each against
    run_plain at K1's rule, 1e-3 of max|out| (exact bf16 products, f32
    sums in another order), a repeat giving the same bits, and timed
    beside torch.nn.functional.linear on A and the variant's B made
    beforehand as bf16."""
    import torch.nn.functional as F

    from gemma_tpu_torch.ops import nuq_diag as diag
    from gemma_tpu_torch.scripts.proto_nuq_diag import make_inputs

    k, n = 2304, 9216
    dev = torch.device("cuda")
    a16, codes, tables = make_inputs(16, k, n, dev)
    full = torch.randint(0, 256, (n, k), dtype=torch.uint8, device=dev,
                         generator=torch.Generator(device=dev).manual_seed(13))
    for m in (16, 4):
        a = a16[:m].contiguous()
        for variant in diag.VARIANTS:
            for c, what in ((codes, "codes < 128"), (full, "codes 0..255")):
                if variant == "D3" and c is full:
                    continue
                f = lambda: diag.run(a, c, tables, variant)  # noqa: E731
                p = lambda: diag.run_plain(a, c, tables, variant)  # noqa
                want = p()
                got = f()
                if not torch.equal(got, f()):
                    fail(f"nuq_diag_{variant.lower()} M={m} {what}: a repeat "
                         "gave other bits")
                bb = diag.b_operand(c, tables, variant)
                lib = lambda: F.linear(a, bb)  # noqa: E731
                nbytes = m * k * 2 + n * k + m * n * 4 + (
                    tables.numel() * 4 if variant == "D3" else 0)
                kw, splits = diag.diag_split(n, k, variant)
                record(res, torch, f"nuq_diag_{variant.lower()}",
                       f"M={m} K={k} N={n} {what} (kw {kw}, splits "
                       f"{splits})", got, want,
                       1e-3 * float(want.abs().max()), f, p, nbytes,
                       2 * m * n * k, primary=m == 16 and c is codes,
                       library=lib)


def phase_draw(torch, res, cfg):
    """The draw kernel against its plain version: rows of a top-k head's
    shape ([M, k] descending values), T in {0, 0.8, 1, 2}, k in {2, 64,
    128}.  Probs within 1e-5 relative (the same softmax in another
    order); tokens equal wherever the plain version's Gumbel-max margin
    exceeds 1e-4 (log, exp and pow may differ in the last ulp)."""
    from gemma_tpu_torch.ops import sampling
    from gemma_tpu_torch.utils.basics import sample_key

    gen = torch.Generator(device="cuda").manual_seed(55)
    for temperature in (0.0, 0.8, 1.0, 2.0):
        for m, k in ((4, 64), (20, 2), (20, 128)):
            vals = torch.sort(torch.randn(m, k, generator=gen, device="cuda")
                              * 2, dim=-1, descending=True).values.contiguous()
            idxs = torch.randint(0, cfg.vocab_size, (m, k), generator=gen,
                                 device="cuda", dtype=torch.int32)
            qi = torch.arange(m, dtype=torch.int32, device="cuda")
            pos = torch.randint(0, 8192, (m,), generator=gen, device="cuda",
                                dtype=torch.int32)
            args = (vals, idxs, 20240607, qi, pos, temperature)
            f = lambda: sampling.sample_stream(*args)  # noqa: E731
            p = lambda: sampling.sample_stream_plain(*args)  # noqa: E731
            (tok, prob), (want_tok, want_prob) = f(), p()
            clear = torch.ones(m, dtype=torch.bool, device="cuda")
            if temperature != 0.0:
                pr = torch.softmax(vals, -1)
                adj = pr ** (1.0 / temperature)
                score = torch.log(adj / adj.sum(-1, keepdim=True)) \
                    + sampling.gumbel(sample_key(20240607, qi, pos), k)
                top2 = score.topk(2).values
                clear = (top2[:, 0] - top2[:, 1]) > 1e-4
            bad = int(((tok != want_tok) & clear).sum())
            case = f"M={m} k={k} T={temperature}"
            print(f"[2] draw_topk {case}: {int(clear.sum())} rows with a "
                  f"clear Gumbel margin, {bad} tokens differ", flush=True)
            if bad or not bool(clear.any()):
                fail(f"draw_topk [{case}]: tokens differ from the plain "
                     "version")
            record(res, torch, "draw_topk", case, prob, want_prob,
                   1e-5 * float(want_prob.abs().max()), f, p,
                   m * k * 8 + m * 16, 0,
                   primary=(m, k, temperature) == (4, 64, 0.8))


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
    gen = torch.Generator().manual_seed(7)
    t = 96
    tokens = torch.randint(2, cfg.vocab_size, (1, t), generator=gen)
    for kind in ("i8", "sfp", "i4", "nuq4"):
        params = synth_params(cfg, kind=kind, seed=7, device="cuda")
        params_cpu = _to_device(params, "cpu")
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
            fail(f"2-layer {kind} model: non-finite logits on the card")
        err = float((logits["cuda"] - logits["cpu"]).abs().max())
        scale = float(logits["cpu"].abs().max())
        # i8-KV full-forward tolerance of the JAX suite (test_parity_full.py).
        tol = 2e-2 * scale
        print(f"[3] 2-layer full-width {kind} weights, prefill {t - 1} + "
              f"decode 1: card vs CPU plain last-logit max_abs_err {err:.4g} "
              f"(tol {tol:.4g}, max|logit| {scale:.4g})", flush=True)
        if err > tol:
            fail(f"2-layer {kind} model disagrees between the card and the "
                 "CPU")
        if kind != "sfp":
            # The packed kinds' plain head costs seconds a step on the CPU
            # (it unpacks the whole embedding): one chunk, three draws.
            short = kind != "i8"
            two_layer_chunks(torch, cfg, params, params_cpu,
                             tokens[0].tolist(), new_tokens=4 if short else 8,
                             label=kind)
            # Sampled steps want a flat head: see FLAT_EMBEDDING_RMS.
            flat = synth_params(cfg, kind=kind, seed=7, device="cuda",
                                embedding_rms=FLAT_EMBEDDING_RMS)
            two_layer_sampled(torch, cfg, flat, _to_device(flat, "cpu"),
                              tokens[0].tolist(), steps=3 if short else 4,
                              label=kind)
            del flat
        del params, params_cpu
        torch.cuda.empty_cache()
    # Split q / kv weights (qkv2's tensor scale apart, as a file gives):
    # decode through K8-i8, card against CPU.
    params = synth_params(cfg, kind="sfp", seed=7, device="cuda",
                          fuse_qkv=False)
    for lp in params.layers:
        lp.qkv2 = dataclasses.replace(lp.qkv2, scale=lp.qkv2.scale * 1.25)
    params_cpu = _to_device(params, "cpu")
    logits = {}
    for dev, prm in (("cuda", params), ("cpu", params_cpu)):
        cache = KVCache.create(cfg, 1, 8192, kind="i8", local_slack=256,
                               device=dev)
        forward(prm, tokens[:, :-2].to(dev), torch.arange(t - 2)[None].to(dev),
                cache, cfg, return_logits="none")
        for i in (t - 2, t - 1):
            out, _ = forward(prm, tokens[:, i:i + 1].to(dev),
                             torch.tensor([[i]], device=dev), cache, cfg,
                             return_logits="last")
        logits[dev] = out.float().cpu()
    err = float((logits["cuda"] - logits["cpu"]).abs().max())
    scale = float(logits["cpu"].abs().max())
    print(f"[3] 2-layer full-width split sfp weights (qkv2 scale x1.25), "
          f"prefill {t - 2} + decode 2, i8 KV: card vs CPU plain last-logit "
          f"max_abs_err {err:.4g} (tol {2e-2 * scale:.4g})", flush=True)
    if not torch.isfinite(logits["cuda"]).all() or err > 2e-2 * scale:
        fail("the 2-layer split model disagrees between the card and the CPU")
    del params, params_cpu
    torch.cuda.empty_cache()
    phase_loader(torch)


def write_synth_sbs(torch, path, cfg, type_name: str, seed: int,
                    split: bool = False) -> int:
    """Write `cfg`'s tensors (the stacked names a converted checkpoint
    holds: qkv_ein, gating_ein, att_ein, linear_w and the norms; with
    `split` the split ones: qkv1_w, qkv2_w, gating1_w, gating2_w, att_w)
    with the port's `write_model`; returns the weights' count.  SFP-typed:
    every byte but 0x80 is a valid SFP code, so the streams are random
    bytes drawn on the card (rms 0.42) under a tensor scale that brings the
    weights to rms 1/sqrt(K) (qkv2_w to 1.25 times that: a tensor scale of
    its own, as a file whose kv weights pass 1.875 has).  NUQ-typed:
    N(0, 1/sqrt(K)) values clustered by the numpy encoder."""
    import numpy as np

    from gemma_tpu_torch.compression import (PackedTensor, Type,
                                             compress_tensor)
    from gemma_tpu_torch.io.model_store import write_model
    from gemma_tpu_torch.models.tensor_info import TensorInfoRegistry
    from gemma_tpu_torch.utils.synth import EMBEDDING_RMS, sfp_rms

    gen = torch.Generator(device="cuda").manual_seed(seed)
    registry = TensorInfoRegistry(cfg)
    names = ["c_embedding", "c_final_norm"]
    weights = (("qkv1_w", "qkv2_w", "gating1_w", "gating2_w", "att_w")
               if split else ("qkv_ein", "gating_ein", "att_ein"))
    for i in range(cfg.num_layers):
        names += [f"{base}_{i}" for base in weights + (
            "linear_w", "pre_att_ns", "pre_ff_ns", "post_att_ns",
            "post_ff_ns")]
    tensors, count = [], 0
    for name in names:
        rows, cols = registry.find(name).extents
        if rows == 1:
            vals = torch.randn(1, cols, generator=gen, device="cuda") * 0.05
            tensors.append(compress_tensor(Type.F32, name, vals.cpu().numpy()))
            continue
        count += rows * cols
        lc = cfg.layer_configs[0]
        k = lc.heads * lc.qkv_dim if name.startswith("att_ein") else cols
        rms = EMBEDDING_RMS if name == "c_embedding" else k ** -0.5
        if name.startswith("qkv2_w"):
            rms *= 1.25
        if type_name == "sfp":
            data = torch.randint(0, 256, (rows * cols,), generator=gen,
                                 device="cuda", dtype=torch.uint8)
            data[data == 0x80] = 0
            tensors.append(PackedTensor(
                name, Type.SFP, rows, cols, data.cpu().numpy(),
                float(np.float32(rms / sfp_rms()))))
        else:
            vals = torch.randn(rows, cols, generator=gen, device="cuda") * rms
            tensors.append(compress_tensor(Type.NUQ, name,
                                           vals.cpu().numpy()))
    write_model(path, cfg, tensors)
    return count


def phase_loader(torch):
    """`Gemma.load` from files written here with the port's `write_model`,
    on the card and on the CPU from the same file, last logits (prefill 23
    tokens + one decode step, bf16 KV) compared at the 2-layer tolerance
    above.  The numpy transcodes bound the sizes: int4 takes ~0.05 s and
    int8 ~0.75 s per million weights, NUQ clustering ~17 s:
      - kind_override None (sfp) and "i4": 2 layers at Gemma2-2B's full
        width and vocab / with the vocab cut to 4096 (165M weights);
      - "i8": 2 layers of model_dim 512, ff 2048, 2 heads of 256 over 1 KV
        head, vocab 2048 (9M weights);
      - "nuq4" from a NUQ-typed file: 1 layer of model_dim 256, ff 512, 2
        heads of 128 over 1 KV head, vocab 256 (0.65M weights); att_w
        loads as kind nuq beside nuq4 everything else;
      - None from an SFP-typed file under the split names whose qkv2_w
        has a tensor scale of its own: 2 layers at Gemma2-2B's width,
        vocab 4096; qkv1 and qkv2 load split and decode runs K8."""
    import dataclasses
    import tempfile

    from gemma_tpu_torch.engine import RuntimeConfig
    from gemma_tpu_torch.gemma import Gemma
    from gemma_tpu_torch.models.configs import config_gemma2_2b
    from gemma_tpu_torch.models.gemma import forward

    full = config_gemma2_2b()

    def cut(layers, vocab, **lc_kw):
        lcs = [dataclasses.replace(lc, **lc_kw)
               for lc in full.layer_configs[:layers]]
        return dataclasses.replace(
            full, num_layers=layers, layer_configs=lcs, vocab_size=vocab,
            model_dim=lcs[0].model_dim,
            attention_window_sizes=[64, 8192] if layers == 2 else [8192])

    narrow = dict(model_dim=512, ff_hidden_dim=2048, heads=2, kv_heads=1)
    tiny = dict(model_dim=256, ff_hidden_dim=512, heads=2, kv_heads=1,
                qkv_dim=128)
    cases = (("sfp", False, cut(2, full.vocab_size), (None,)),
             ("sfp", False, cut(2, 4096), ("i4",)),
             ("sfp", False, cut(2, 2048, **narrow), ("i8",)),
             ("nuq", False, cut(1, 256, **tiny), ("nuq4",)),
             ("sfp", True, cut(2, 4096), (None,)))
    gen = torch.Generator().manual_seed(21)
    with tempfile.TemporaryDirectory() as tmp:
        for ci, (type_name, split, cfg, overrides) in enumerate(cases):
            path = os.path.join(tmp, f"model{ci}.sbs")
            t0 = time.monotonic()
            count = write_synth_sbs(torch, path, cfg, type_name, seed=30 + ci,
                                    split=split)
            print(f"[3] wrote a {type_name}-typed .sbs"
                  f"{' under the split names' if split else ''}: "
                  f"{cfg.num_layers} "
                  f"layers, model_dim {cfg.model_dim}, vocab "
                  f"{cfg.vocab_size}, {count / 1e6:.2f}M weights, "
                  f"{os.path.getsize(path) / 1e6:.1f} MB in "
                  f"{time.monotonic() - t0:.1f} s", flush=True)
            tokens = torch.randint(2, cfg.vocab_size, (1, 24), generator=gen)
            for override in overrides:
                logits, kinds = {}, None
                for dev in ("cuda", "cpu"):
                    t0 = time.monotonic()
                    g = Gemma.load(path, kind_override=override,
                                   runtime=RuntimeConfig(seq_len=8192),
                                   device=dev)
                    took = time.monotonic() - t0
                    cache = g.new_cache(1)
                    forward(g.params, tokens[:, :-1].to(dev),
                            torch.arange(23, device=dev)[None], cache,
                            g.config, return_logits="none")
                    out, _ = forward(g.params, tokens[:, -1:].to(dev),
                                     torch.tensor([[23]], device=dev), cache,
                                     g.config, return_logits="last")
                    logits[dev] = out.float().cpu()
                    lp = g.params.layers[0]
                    kinds = (g.params.embedding.kind, qkv_kind(lp),
                             lp.att_w.kind, lp.gating1.kind, lp.linear.kind)
                    if split != (lp.qkv_cat is None):
                        fail(f"the {'split' if split else 'stacked'}-names "
                             "file loaded with the q / kv projections "
                             f"{'fused' if split else 'split'}")
                    if g.params.device.type != dev:
                        fail(f"Gemma.load(device={dev!r}) put the params on "
                             f"{g.params.device}")
                    print(f"[3] Gemma.load(kind_override={override!r}, "
                          f"device={dev!r}): {took:.2f} s; kinds (embedding, "
                          f"qkv, att_w, gating, linear) {kinds}", flush=True)
                    del g, cache
                want = {None: ("sfp",) * 5,
                        "nuq4": ("nuq4", "nuq4", "nuq", "nuq4", "nuq4")}.get(
                    override, (override,) * 5)
                if kinds != want:
                    fail(f"kind_override={override!r} loaded kinds {kinds}")
                if not torch.isfinite(logits["cuda"]).all():
                    fail(f"loaded model ({override}): non-finite logits")
                err = float((logits["cuda"] - logits["cpu"]).abs().max())
                scale = float(logits["cpu"].abs().max())
                tol = 2e-2 * scale
                print(f"[3] loaded model, kind_override={override!r}: card "
                      f"vs CPU last-logit max_abs_err {err:.4g} (tol "
                      f"{tol:.4g}, max|logit| {scale:.4g})", flush=True)
                if err > tol:
                    fail(f"the model loaded with kind_override={override!r} "
                         "disagrees between the card and the CPU")
    torch.cuda.empty_cache()


def two_layer_sampled(torch, cfg, params, params_cpu, prompt, steps: int = 4,
                      top_k: int = 64, temperature: float = 0.8,
                      seed: int = 1, label: str = "i8"):
    """Sampled steps on the card and on the CPU, teacher-forced by the
    CPU's tokens so every step compares like with like: the fused top-k
    head's values within 5e-3 of max|logit| (the bound of the greedy chunk
    check above) and its indices wherever both neighbouring CPU values
    are further apart than twice that; the drawn token wherever the CPU's
    Gumbel-max margin exceeds 4 tol / T (each score moves by at most
    2 tol / T with the values; entries that swap places below that margin
    cannot win) and both lists hold the same index at the winning place."""
    from gemma_tpu_torch.engine import GemmaEngine, RuntimeConfig
    from gemma_tpu_torch.models.gemma import forward
    from gemma_tpu_torch.ops import sampling
    from gemma_tpu_torch.utils.basics import sample_key

    state = {}
    for dev, prm in (("cuda", params), ("cpu", params_cpu)):
        engine = GemmaEngine(prm, cfg, RuntimeConfig(seq_len=8192),
                             device=dev)
        cache = engine.new_cache(1)
        engine.prefill([prompt], cache)
        state[dev] = (prm, cache)
    prev, pos = prompt[-1], len(prompt) - 1
    pinned_total = drawn = 0
    for step in range(steps):
        heads = {}
        for dev, (prm, cache) in state.items():
            (vals, idxs), _ = forward(
                prm, torch.tensor([[prev]], device=dev),
                torch.tensor([[pos]], device=dev), cache, cfg,
                return_logits="topk", top_k_n=top_k)
            qi = torch.zeros(1, dtype=torch.int32, device=dev)
            at = torch.tensor([pos + 1], dtype=torch.int32, device=dev)
            tok, prob = sampling.sample_stream(vals, idxs, seed, qi, at,
                                               temperature)
            heads[dev] = (vals.cpu(), idxs.cpu(), int(tok[0]), float(prob[0]))
        (cv, ci, ctok, _), (kv, ki, ktok, _) = heads["cpu"], heads["cuda"]
        tol = 5e-3 * float(cv.abs().max())
        err = float((kv - cv).abs().max())
        gap = (cv[:, :-1] - cv[:, 1:]) > 2 * tol
        pinned = torch.ones_like(cv, dtype=torch.bool)
        pinned[:, 1:] &= gap
        pinned[:, :-1] &= gap
        bad = int(((ki != ci) & pinned).sum())
        pr = torch.softmax(cv, -1) ** (1.0 / temperature)
        score = torch.log(pr / pr.sum(-1, keepdim=True)) + sampling.gumbel(
            sample_key(seed, 0, pos + 1), top_k)
        top2 = score.topk(2).values[0]
        margin = float(top2[0] - top2[1])
        won = int(score.argmax())
        decided = int(ki[0, won]) == int(ci[0, won]) \
            and margin > 4 * tol / temperature
        print(f"[3] {label} sampled step {step}: top-{top_k} value max_abs_err "
              f"{err:.4g} (tol {tol:.4g}), {int(pinned.sum())} entries "
              f"pinned, {bad} indices differ; token card {ktok} CPU {ctok}, "
              f"Gumbel margin {margin:.4g} "
              f"({'decides' if decided else 'too close to call'})",
              flush=True)
        if err > tol or bad:
            fail("the 2-layer top-k head disagrees between the card and "
                 "the CPU")
        if decided:
            drawn += 1
            if ktok != ctok:
                fail("a sampled token with a clear Gumbel margin differs "
                     "between the card and the CPU")
        pinned_total += int(pinned.sum())
        prev, pos = ctok, pos + 1
    if not pinned_total or not drawn:
        fail("2-layer sampled steps: no top-k entry or no drawn token had "
             "a clear margin")
    print(f"[3] 2-layer {label} sampled steps: {drawn} of {steps} tokens decided "
          "by a clear margin, all equal", flush=True)


def two_layer_chunks(torch, cfg, params, params_cpu, prompt,
                     new_tokens: int = 8, label: str = "i8"):
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
    print(f"[3] 2-layer {label} generate_batch, bf16 KV, decode_chunk=4: card "
          f"{tk}, CPU {tc}; {clear} steps with a clear margin, log-prob "
          f"max err {err:.4g} (tol {2 * logit_tol:.4g})", flush=True)
    if tk[:clear] != tc[:clear] or err > 2 * logit_tol or not clear:
        fail("2-layer decode chunks disagree between the card and the CPU")


# The device functions of each counted kernel, as the profiler names them
# (mm_<kind>_kernel's and mm_sm90_<kind>_kernel's last template argument
# is GATED; the heads and the
# attention kernels carry their weight or pool type in their names).
def _port_kernel(device_name: str) -> str | None:
    for kind in WEIGHT_KINDS:
        if device_name.startswith(f"void mm_sm90_{kind}_kernel<"):
            return f"gated_sm90_{kind}" if "true>" in device_name \
                else f"matmul_sm90_{kind}"
        if device_name.startswith(f"void mm_stacked_{kind}_kernel<"):
            return f"gated_stacked_{kind}" if "true>" in device_name \
                else f"matmul_stacked_{kind}"
        if device_name.startswith(f"void mm_{kind}_kernel<"):
            return f"gated_{kind}" if "true>" in device_name \
                else f"matmul_{kind}"
        for op in ("top1", "topk"):
            if f"{op}_{kind}_kernel(" in device_name or \
                    f"{op}_{kind}_kernel<" in device_name:
                return f"{op}_{kind}"
    for fn, name in (("prenorm_kernel(", "matmul_prenorm"),
                     ("postnorm_add_kernel(", "matmul_postnorm_add"),
                     ("topk_merge_kernel(", "topk_merge"),
                     ("draw_topk_kernel(", "draw_topk"),
                     ("nuq_diag_d1_kernel(", "nuq_diag_d1"),
                     ("nuq_diag_d2_kernel(", "nuq_diag_d2"),
                     ("nuq_diag_d3_kernel(", "nuq_diag_d3")):
        if fn in device_name:
            return name
    for kind in ("i8", "bf16", "f32"):
        for op in ("decode_attention", "flash_attention", "decode_write_attend",
                   "decode_attend", "decode_sblocked", "kv_write"):
            if f" {op}_{kind}_kernel" in f" {device_name}":
                return f"{op}_{kind}"
    return None


# Profiles taken again because the tracer dropped device records, printed
# before the `kernels` line: {path, attempt, missing, orphan_launches}.
PROFILE_RETRIES: list[dict] = []
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx")


def orphan_launches(torch, prof) -> int:
    """Runtime kernel-launch records of the profiled window whose
    correlation id no device record carries: launches that ran (the
    runtime saw them) but whose device record the tracer dropped."""
    events = prof.profiler.kineto_results.events()
    on_device = {e.correlation_id() for e in events
                 if e.device_type() == torch.autograd.DeviceType.CUDA}
    return sum(1 for e in events if e.name() in LAUNCH_CALLS
               and e.correlation_id() not in on_device)


def profile_chunks(torch, engine, prompts, chunks: int = 2, k: int = 4,
                   label: str = "4A"):
    """Device time by kernel over `chunks` decode chunks of k steps
    (torch.profiler), beside the host wall time of the same chunks: the
    device's idle share.  The profiler's own count of each kernel's
    device launches must equal what the launch counters gained over the
    same chunks.  One more chunk then runs with CUDA's sync debug mode
    set to error: a host sync inside a chunk fails the run."""
    from torch.profiler import ProfilerActivity, profile, schedule

    from gemma_tpu_torch.ops import _cuda

    cache = engine.new_cache(len(prompts))
    cache, last = engine.prefill(prompts, cache)
    prev = torch.tensor(last, dtype=torch.int32, device="cuda")
    pos = torch.tensor([len(p) - 1 for p in prompts], dtype=torch.int32,
                       device="cuda")
    torch.cuda.synchronize()
    # One chunk in the profiler's warm-up step first: device activity
    # recorded while the tracer starts can be lost, and only the active
    # step's events are read.  The tracer can also drop a run of device
    # records (seen on an H100 now and then: kineto counts them out of
    # the window while their runtime launch records stay).  A
    # window whose trace lacks launches the counters saw is profiled
    # again, at most three times, only when that second witness covers
    # the shortfall: at least as many runtime launch records without a
    # device record (by correlation id) as launches missing.  Each
    # discarded profile is kept in PROFILE_RETRIES.
    steps = chunks * k
    for attempt in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as prof:
            toks, _ = engine._decode_steps(prev, pos, cache, k)
            prev, pos = toks[:, -1].contiguous(), pos + k
            torch.cuda.synchronize()
            prof.step()
            before = {kn.name: kn.launches for kn in _cuda.all_kernels()}
            t0 = time.monotonic()
            for _ in range(chunks):
                toks, _ = engine._decode_steps(prev, pos, cache, k)
                prev, pos = toks[:, -1].contiguous(), pos + k
            torch.cuda.synchronize()
            wall = (time.monotonic() - t0) * 1e3
            prof.step()
        counted = {kn.name: kn.launches - before[kn.name]
                   for kn in _cuda.all_kernels()}
        # The step annotation spans the whole step on the device too: it
        # is not a kernel.
        kern = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and not e.key.startswith("ProfilerStep")]
        seen = {name: 0 for name in counted}
        for e in kern:
            name = _port_kernel(e.key)
            if name is not None:
                seen[name] += e.count
        print(f"[{label}] {chunks} chunks of {k}: launches by counter "
              f"{json.dumps(counted)}, by profiler {json.dumps(seen)}",
              flush=True)
        if seen == counted:
            break
        short = {n: counted[n] - seen[n] for n in counted
                 if seen[n] != counted[n]}
        orphans = orphan_launches(torch, prof)
        print(f"[{label}] profile {attempt}: the trace lacks launches the "
              f"counters saw {json.dumps(short)}; runtime launch records "
              f"without a device record: {orphans}", flush=True)
        if any(v < 0 for v in short.values()):
            fail("the profiler's device trace shows launches the counters "
                 "did not count")
        if orphans < sum(short.values()):
            fail(f"path {label}: {sum(short.values())} counted launches are "
                 f"missing from the device trace, and only {orphans} runtime "
                 "launch records lack a device record: the counters report "
                 "launches that did not run")
        PROFILE_RETRIES.append({"path": label, "attempt": attempt,
                                "missing": short, "orphan_launches": orphans})
    else:
        fail("the launch counters disagree with the profiler's device trace "
             "in three profiles")
    busy = sum(e.self_device_time_total for e in kern) / 1e3
    if busy > wall:
        fail(f"path {label}: device busy {busy:.3f} ms exceeds the host wall "
             f"{wall:.3f} ms of the same chunks")
    launches = sum(counted.values()) / steps
    # Every device activity of the window (the port's kernels, torch's
    # kernels, copies, sets), per step.
    activities = sum(e.count for e in kern) / steps
    print(f"[{label}] decode profile, {steps} steps in chunks of {k}: host "
          f"wall {wall / steps:.3f} ms/step, device busy {busy / steps:.3f} "
          f"ms/step, idle share {1 - busy / wall:.3f}, device activities "
          f"{activities:.3f}/step", flush=True)
    for e in sorted(kern, key=lambda e: -e.self_device_time_total)[:10]:
        print(f"[{label}]   "
              f"{e.self_device_time_total / 1e3 / steps:9.4f} ms/step "
              f"{e.count / steps:6.2f}/step  {e.key[:90]}", flush=True)
    torch.cuda.set_sync_debug_mode("error")
    try:
        engine._decode_steps(prev, pos, cache, k)
    except RuntimeError as e:
        fail(f"a decode chunk synchronized with the host: {e}")
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    print(f"[{label}] one chunk of {k} under sync debug mode 'error': no "
          "host sync", flush=True)
    return {"wall_ms": wall / steps, "busy_ms": busy / steps,
            "idle": 1 - busy / wall, "launches": launches,
            "activities": activities}


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
    from gemma_tpu_torch.ops import sampling

    plain = {(mm, "matmul_plain"), (mm, "gated_ffn_plain"),
             (mm, "postnorm_add_plain"), (mm, "prenorm_plain"),
             (mm, "matmul_top1_plain"), (mm, "matmul_topk_plain"),
             (mm, "topk_merge_plain"), (mm, "take_layer"),
             (sampling, "sample_stream_plain"),
             (da, "decode_attention_write_packed_plain"),
             (da, "decode_attention_write_plain"),
             (da, "decode_attention_write_sblocked_plain"),
             (da, "kv_write_decode_plain"), (da, "decode_attention_plain"),
             # the torch-op row encode: K9 (path M) and K8 encode in-kernel
             (da, "_pool_rows"), (da, "quantize_rows"),
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
    return {"tok_s": _med([t.generate_tokens_per_second for t in timings]),
            "step_ms": _med(step_ms)}


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
    import dataclasses

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
          f"({params_bytes(params) / 1e9:.2f} GB) "
          f"in {time.monotonic() - t0:.2f} s", flush=True)
    gen = torch.Generator().manual_seed(3)
    lens = (17, 130, 300, 700)
    prompts = [torch.randint(2, cfg.vocab_size, (n,), generator=gen).tolist()
               for n in lens]
    totals: dict = {}

    def add(counts):
        for name, c in counts.items():
            totals[name] = totals.get(name, 0) + c

    def schedule(engine, steps, head, kv="bf16", wkind="i8", att_kind=None,
                 dec=None, scan=False):
        """Launches per path: prefill rounds run 3 GEMMs, the gated GEMM
        (their prefill tile, M = B x chunk rows > 16) and prefill
        attention per layer; a decode step 3 GEMMs and the gated GEMM,
        their norms folded in (one launch each), and decode attention per
        layer, then its head: "top1" the fused greedy head (its norm folded
        in), "topk" the fused top-k head (its norm folded in) with its
        selection and the draw, "gemm" the head as one more GEMM (one-step
        chunks).
        Split q / kv weights add one GEMM per layer.  att_kind: the codec of att_w where it differs from
        the rest's.  dec: the decode attention kernels' launches per step
        by name (default K4 of the KV kind on every layer).  scan: the
        decode step's GEMMs are the stacked ones (K12), prefill's and the
        head's stay unstacked."""
        layers = len(engine.params.layers)
        split = int(engine.params.layers[0].qkv_cat is None)
        chunk = engine.prefill_chunk(len(prompts), max(lens))
        rounds = -(-(max(lens) - 1) // chunk)
        d_mm = "matmul_stacked_" if scan else "matmul_"
        d_gated = "gated_stacked_" if scan else "gated_"
        per_layer = (2 if att_kind else 3) + split
        want = {f"matmul_sm90_{wkind}": rounds * per_layer * layers,
                f"matmul_{wkind}": steps if head == "gemm" else 0,
                "matmul_prenorm": 0,
                f"gated_sm90_{wkind}": rounds * layers,
                f"flash_attention_{kv}": rounds * layers}
        want[f"{d_mm}{wkind}"] = want.get(f"{d_mm}{wkind}", 0) \
            + steps * per_layer * layers
        want[f"{d_gated}{wkind}"] = want.get(f"{d_gated}{wkind}", 0) \
            + steps * layers
        for name, n in (dec or {f"decode_attention_{kv}": layers}).items():
            want[name] = steps * n
        if head == "top1":
            want[f"top1_{wkind}"] = steps
        if head == "topk":
            want.update({f"topk_{wkind}": steps, "topk_merge": steps,
                         "draw_topk": steps})
        if att_kind:
            want[f"matmul_sm90_{att_kind}"] = rounds * layers
            want[f"{d_mm}{att_kind}"] = want.get(f"{d_mm}{att_kind}", 0) \
                + steps * layers
        return want, rounds, chunk

    # --- A: the default RuntimeConfig ---
    engine = GemmaEngine(params, cfg, RuntimeConfig(seq_len=8192))
    rt = engine.runtime
    print(f"[4A] RuntimeConfig: kv_kind {rt.kv_kind}, decode_chunk "
          f"{rt.decode_chunk}, stream_probs {rt.stream_probs}", flush=True)
    engine.generate_batch([p[:40] for p in prompts], max_generated_tokens=6)
    timing = TimingInfo()
    outs, counts = counted_run(torch, lambda: engine.generate_batch(
        prompts, max_generated_tokens=new_tokens, timing_info=timing))
    want, rounds, chunk = schedule(engine, timing.decode_steps, "top1")
    print(f"[4A] prefill chunk {chunk} x {rounds} rounds, "
          f"{timing.decode_steps} decode steps", flush=True)
    check_counts("4A", counts, want)
    add(counts)
    for qi, o in enumerate(outs):
        if not o or any(not (0 <= tok < cfg.vocab_size) for tok in o):
            fail(f"path A, request {qi}: bad tokens {o}")
    print(f"[4A] first tokens: {[o[:8] for o in outs]}", flush=True)
    a_runs = timed_runs(torch, engine, prompts, new_tokens, "4A", timing)
    a_prof = profile_chunks(torch, engine, prompts)
    check_first_tokens(torch, engine, prompts, outs, cfg, "4A")

    # --- B: generate_fast over an i8 KV cache, against generate_batch ---
    engine = GemmaEngine(params, cfg, RuntimeConfig(seq_len=8192,
                                                    kv_kind="i8"))
    engine.generate_fast([p[:40] for p in prompts], 4)
    fast, counts = counted_run(
        torch, lambda: engine.generate_fast(prompts, new_tokens))
    want, _, _ = schedule(engine, new_tokens, "top1", kv="i8")
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
    want, _, _ = schedule(engine, timing.decode_steps, "gemm", kv="i8")
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
    want, _, _ = schedule(engine, timing.decode_steps, "top1", kv="f32")
    check_counts("4D", counts, want)
    add(counts)
    check_first_tokens(torch, engine, prompts, outs, cfg, "4D")
    def counted_generate(label, engine, head, wkind, n_new, **kw):
        """One counted generate_batch held to its schedule; (outs, timing)."""
        timing = TimingInfo()
        outs, counts = counted_run(torch, lambda: engine.generate_batch(
            prompts, max_generated_tokens=n_new, timing_info=timing))
        want, _, _ = schedule(engine, timing.decode_steps, head, wkind=wkind,
                              **kw)
        check_counts(label, counts, want)
        add(counts)
        for qi, o in enumerate(outs):
            if not o or any(not (0 <= tok < cfg.vocab_size) for tok in o):
                fail(f"path {label}, request {qi}: bad tokens {o}")
        return outs, timing

    sampled = dict(top_k=64, temperature=0.8, seed=1)

    # --- E: sampled serving on the i8 weights, with a flat head so that
    # the draw, not one dominant logit, decides each token ---
    from gemma_tpu_torch.utils.synth import synth_quant

    flat_gen = torch.Generator(device="cuda").manual_seed(11)
    params = dataclasses.replace(params, embedding=synth_quant(
        flat_gen, cfg.vocab_size, cfg.model_dim, "cuda", "i8",
        rms=FLAT_EMBEDDING_RMS))
    engine = GemmaEngine(params, cfg, RuntimeConfig(seq_len=8192, **sampled))
    engine.generate_batch([p[:40] for p in prompts], max_generated_tokens=6)
    outs, timing = counted_generate("4E", engine, "topk", "i8", new_tokens)
    print(f"[4E] top_k 64, temperature 0.8, seed 1, embedding rms "
          f"{FLAT_EMBEDDING_RMS}: first tokens {[o[:8] for o in outs]}",
          flush=True)
    greedy = GemmaEngine(params, cfg, RuntimeConfig(seq_len=8192)
                         ).generate_batch(prompts, max_generated_tokens=8)
    if all(o[:8] == g for o, g in zip(outs, greedy)):
        fail("path E: the sampled transcripts equal the greedy ones")
    timed_runs(torch, engine, prompts, new_tokens, "4E", timing)
    profile_chunks(torch, engine, prompts, label="4E")
    again = engine.generate_batch(prompts, max_generated_tokens=new_tokens)
    if again != outs:
        fail(f"path E: the same seed gave other tokens: {again} != {outs}")
    # Query 0 alone (batch 1, the same 512-token prefill chunk) draws from
    # the same (seed, query 0, position) streams as in the batch of 4.
    alone = GemmaEngine(params, cfg, RuntimeConfig(
        seq_len=8192, prefill_tbatch_size=512, **sampled)).generate_batch(
        prompts[:1], max_generated_tokens=new_tokens)
    if alone[0] != outs[0]:
        fail(f"path E: query 0 alone {alone[0]} != in the batch {outs[0]}")
    other = GemmaEngine(params, cfg, RuntimeConfig(
        seq_len=8192, **{**sampled, "seed": 2})).generate_batch(
        prompts, max_generated_tokens=8)
    if other == [o[:8] for o in outs]:
        fail("path E: another seed gave the same tokens")
    print(f"[4E] same seed twice: equal tokens; query 0 alone at batch 1: "
          f"equal tokens; seed 2 differs", flush=True)
    del params, engine, greedy
    torch.cuda.empty_cache()

    # --- F: sfp weights, greedy (the default runtime), then sampled ---
    # --- G: bf16 weights, sampled, then greedy ---
    # --- H: f32 weights at 4 layers, greedy and sampled ---
    short = dataclasses.replace(
        cfg, num_layers=4, layer_configs=cfg.layer_configs[:4],
        attention_window_sizes=cfg.attention_window_sizes[:4])
    for label, wkind, config, runs in (
            ("4F", "sfp", cfg, (("top1", new_tokens), ("topk", 8))),
            ("4G", "bf16", cfg, (("topk", 8), ("top1", 8))),
            ("4H", "f32", short, (("top1", 4), ("topk", 4)))):
        t0 = time.monotonic()
        prm = synth_params(config, kind=wkind, seed=0, device="cuda")
        torch.cuda.synchronize()
        print(f"[{label}] Gemma2-2B width, {config.num_layers} layers, "
              f"synthetic {wkind} weights on the card in "
              f"{time.monotonic() - t0:.2f} s, "
              f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated",
              flush=True)
        for i, (head, n_new) in enumerate(runs):
            rt = RuntimeConfig(seq_len=8192,
                               **(sampled if head == "topk" else {}))
            engine = GemmaEngine(prm, config, rt)
            if i == 0:
                engine.generate_batch([p[:40] for p in prompts],
                                      max_generated_tokens=6)
            outs, timing = counted_generate(
                f"{label} {'sampled' if head == 'topk' else 'greedy'}",
                engine, head, wkind, n_new)
            if i == 0:
                timed_runs(torch, engine, prompts, n_new, label, timing)
            if head == "top1":
                check_first_tokens(torch, engine, prompts, outs, config,
                                   label)
        del prm, engine
        torch.cuda.empty_cache()

    # --- I: Gemma2-27B, i4 weights, every layer; greedy, then sampled ---
    # --- J: Gemma2-9B, nuq4 weights, every layer; the same traffic ---
    # --- K: Gemma2-2B width, 4 layers, nuq4 weights with att_w of kind nuq:
    # the mix a nuq4 model loaded from a file has ---
    from gemma_tpu_torch.models.configs import (config_gemma2_9b,
                                                config_gemma2_27b)

    for label, name, wkind, config, att_kind, n_greedy, n_sampled in (
            ("4I", "Gemma2-27B", "i4", config_gemma2_27b(), None, 16, 8),
            ("4J", "Gemma2-9B", "nuq4", config_gemma2_9b(), None, 16, 8),
            ("4K", "Gemma2-2B width", "nuq4", short, "sfp", 8, 4)):
        torch.cuda.reset_peak_memory_stats()
        t0 = time.monotonic()
        prm = synth_params(config, kind=wkind, seed=0, device="cuda")
        if att_kind:
            mix_gen = torch.Generator(device="cuda").manual_seed(12)
            for lp in prm.layers:
                lp.att_w = synth_quant(mix_gen, lp.att_w.n, lp.att_w.k,
                                       "cuda", "nuq")
        torch.cuda.synchronize()
        lc = config.layer_configs[0]
        print(f"[{label}] {name}, {config.num_layers} layers, model_dim "
              f"{config.model_dim}, {lc.heads}/{lc.kv_heads} heads of "
              f"{lc.qkv_dim}, query scale {config.query_scale_value():.4g}, "
              f"synthetic {wkind} weights"
              f"{' (att_w of kind nuq)' if att_kind else ''} on the card in "
              f"{time.monotonic() - t0:.2f} s, "
              f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated",
              flush=True)
        engine = GemmaEngine(prm, config, RuntimeConfig(seq_len=8192))
        engine.generate_batch([p[:40] for p in prompts],
                              max_generated_tokens=6)
        outs, timing = counted_generate(
            f"{label} greedy", engine, "top1", wkind, n_greedy,
            att_kind=att_kind)
        print(f"[{label}] first tokens: {[o[:8] for o in outs]}", flush=True)
        timed_runs(torch, engine, prompts, n_greedy, label, timing)
        if label != "4K":
            profile_chunks(torch, engine, prompts, label=label)
        check_first_tokens(torch, engine, prompts, outs, config, label)
        engine = GemmaEngine(prm, config,
                             RuntimeConfig(seq_len=8192, **sampled))
        counted_generate(f"{label} sampled", engine, "topk", wkind,
                         n_sampled, att_kind=att_kind)
        print(f"[{label}] peak device memory "
              f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB", flush=True)
        del prm, engine
        torch.cuda.empty_cache()

    phase_split_paths(torch, cfg, prompts, counted_generate, sampled,
                      new_tokens)
    phase_scan_path(torch, cfg, prompts, counted_generate, sampled,
                    new_tokens, {**a_runs, **a_prof})

    missing = [name for name, c in totals.items()
               if c == 0 and name not in STANDALONE]
    if missing:
        fail(f"kernels no counted path launched: {missing}")
    return totals


def check_same_tokens(torch, engine, prompts, got, want, cfg, label):
    """A switch's tokens (got) against the same model and runtime with the
    switch unset (want): equal up to each request's first difference,
    where the top1-top2 margin of a prefill-only forward over the prompt
    and the common tokens must be within the i8-KV logit tolerance of
    test_parity_full.py (2e-2 of max|logit|): a near tie, which either
    path may break."""
    from gemma_tpu_torch.models.gemma import forward

    equal = 0
    for qi, (p, g, w) in enumerate(zip(prompts, got, want)):
        n = next((i for i, (a, b) in enumerate(zip(g, w)) if a != b), None)
        if n is None:
            equal += len(w)
            continue
        equal += n
        seq = p + w[:n]
        ref, _ = forward(engine.params, torch.tensor([seq], device="cuda"),
                         torch.arange(len(seq), device="cuda")[None],
                         engine.new_cache(1), cfg, return_logits="last")
        top2 = ref[0].topk(2).values
        margin = float(top2[0] - top2[1])
        tol = 2e-2 * float(ref.abs().max())
        print(f"[{label}] request {qi}: tokens part at step {n} ({g[n]} vs "
              f"{w[n]}), margin there {margin:.4g} (tol {tol:.4g})",
              flush=True)
        if margin > tol:
            fail(f"path {label}: request {qi}'s tokens differ from the "
                 f"switch-off run's at step {n} with a clear margin")
    print(f"[{label}] {equal} of {sum(map(len, want))} tokens equal the "
          "run with the switch unset", flush=True)
    if equal <= len(prompts):
        fail(f"path {label}: no decoded token matched the switch-off run")


def phase_split_paths(torch, cfg, prompts, counted_generate, sampled,
                      new_tokens):
    """Paths L, M and N: Gemma2-2B at 26 layers, the environment restored
    after each.

    L. Split q / kv weights: synth_params(kind="sfp", fuse_qkv=False) with
       qkv2's tensor scale 1.25 times qkv1's (they cannot join, as in a
       file whose kv weights pass 1.875): two GEMMs and K8 per decode
       layer.  Default runtime: 32 greedy tokens (3 runs, two chunks under
       torch.profiler, one under sync debug mode "error", first tokens
       against a prefill-only forward), 8 sampled; then 4 greedy tokens
       each over i8 and f32 KV (K8-i8, K8-f32).
    M. GEMMA_FUSED_DECODE=0, i8 weights, kv_kind="i8": RoPE in torch ops,
       then K9-i8 (the raw rows encoded in the kernel: one launch a
       layer) and K10-i8; 8 tokens against the same run with the switch
       unset (K4), 3 runs, two chunks under torch.profiler (its device
       activities a step printed) and one under sync debug mode "error";
       then 4 tokens each over bf16 and f32 KV.
    N. GEMMA_SBLOCK_DECODE=1, the default runtime with fused i8 weights:
       the packed call routes to the split one and K11-bf16 (pick_s_block
       finds S blocks for both pools, so K11 takes both: runs of 128 rows);
       8 tokens against the switch unset, profiled as M; then 4 tokens
       over f32 KV (K11-f32) and over i8 KV at seq_len=8191 (8192-row
       global pools have 128-row S blocks: K11-i8; the local pools have
       none: K8-i8)."""
    import dataclasses

    from gemma_tpu_torch.engine import GemmaEngine, RuntimeConfig
    from gemma_tpu_torch.ops import decode_attention as da
    from gemma_tpu_torch.utils.synth import synth_params

    L = cfg.num_layers

    # --- L ---
    t0 = time.monotonic()
    prm = synth_params(cfg, kind="sfp", seed=0, device="cuda", fuse_qkv=False)
    for lp in prm.layers:
        lp.qkv2 = dataclasses.replace(lp.qkv2, scale=lp.qkv2.scale * 1.25)
    torch.cuda.synchronize()
    print(f"[4L] Gemma2-2B {L} layers, split synthetic sfp q / kv weights "
          f"(qkv2 scale {prm.layers[0].qkv2.scale:.4g}, qkv1 "
          f"{prm.layers[0].qkv1.scale:.4g}) on the card in "
          f"{time.monotonic() - t0:.2f} s, {params_bytes(prm) / 1e9:.2f} GB",
          flush=True)
    engine = GemmaEngine(prm, cfg, RuntimeConfig(seq_len=8192))
    engine.generate_batch([p[:40] for p in prompts], max_generated_tokens=6)
    outs, timing = counted_generate(
        "4L greedy", engine, "top1", "sfp", new_tokens,
        dec={"decode_write_attend_bf16": L})
    print(f"[4L] first tokens: {[o[:8] for o in outs]}", flush=True)
    timed_runs(torch, engine, prompts, new_tokens, "4L", timing)
    profile_chunks(torch, engine, prompts, label="4L")
    check_first_tokens(torch, engine, prompts, outs, cfg, "4L")
    counted_generate("4L sampled", GemmaEngine(
        prm, cfg, RuntimeConfig(seq_len=8192, **sampled)), "topk", "sfp", 8,
        dec={"decode_write_attend_bf16": L})
    for kv in ("i8", "f32"):
        counted_generate(f"4L {kv} KV", GemmaEngine(
            prm, cfg, RuntimeConfig(seq_len=8192, kv_kind=kv)), "top1", "sfp",
            4, kv=kv, dec={f"decode_write_attend_{kv}": L})
    del prm, engine
    torch.cuda.empty_cache()

    params = synth_params(cfg, seed=0, device="cuda")  # i8, fused

    # --- M ---
    ref_engine = GemmaEngine(params, cfg, RuntimeConfig(seq_len=8192,
                                                        kv_kind="i8"))
    want = ref_engine.generate_batch(prompts, max_generated_tokens=8)
    old = _set_env("GEMMA_FUSED_DECODE", "0")
    try:
        engine = GemmaEngine(params, cfg, RuntimeConfig(seq_len=8192,
                                                        kv_kind="i8"))
        outs, timing = counted_generate(
            "4M i8 KV", engine, "top1", "i8", 8, kv="i8",
            dec={"kv_write_i8": L, "decode_attend_i8": L})
        check_same_tokens(torch, ref_engine, prompts, outs, want, cfg, "4M")
        timed_runs(torch, engine, prompts, 8, "4M", timing)
        profile_chunks(torch, engine, prompts, label="4M")
        for kv in ("bf16", "f32"):
            counted_generate(f"4M {kv} KV", GemmaEngine(
                params, cfg, RuntimeConfig(seq_len=8192, kv_kind=kv)),
                "top1", "i8", 4, kv=kv,
                dec={f"kv_write_{kv}": L, f"decode_attend_{kv}": L})
    finally:
        _set_env("GEMMA_FUSED_DECODE", old)

    # --- N ---
    ref_engine = GemmaEngine(params, cfg, RuntimeConfig(seq_len=8192))
    want = ref_engine.generate_batch(prompts, max_generated_tokens=8)
    old = _set_env("GEMMA_SBLOCK_DECODE", "1")
    try:
        engine = GemmaEngine(params, cfg, RuntimeConfig(seq_len=8192))
        blocks = {da._s_block(engine.new_cache(1), i) for i in range(L)}
        print(f"[4N] S blocks of the bf16 pools: {sorted(blocks)}", flush=True)
        outs, timing = counted_generate(
            "4N bf16 KV", engine, "top1", "i8", 8,
            dec={"decode_sblocked_bf16": L})
        check_same_tokens(torch, ref_engine, prompts, outs, want, cfg, "4N")
        timed_runs(torch, engine, prompts, 8, "4N", timing)
        profile_chunks(torch, engine, prompts, label="4N")
        counted_generate("4N f32 KV", GemmaEngine(
            params, cfg, RuntimeConfig(seq_len=8192, kv_kind="f32")),
            "top1", "i8", 4, kv="f32", dec={"decode_sblocked_f32": L})
        engine = GemmaEngine(params, cfg, RuntimeConfig(seq_len=8191,
                                                        kv_kind="i8"))
        cache = engine.new_cache(1)
        n_sb = sum(da._s_block(cache, i) is not None for i in range(L))
        print(f"[4N] i8 KV at seq_len 8191: {n_sb} layers with S blocks "
              f"(s_alloc {cache.kv.shape[4]}), {L - n_sb} one-shot (local "
              f"s_alloc {cache.kv_local.shape[4]})", flush=True)
        if not 0 < n_sb < L:
            fail("path N: the i8 pools do not mix S-blocked and one-shot")
        counted_generate("4N i8 KV", engine, "top1", "i8", 4, kv="i8",
                         dec={"decode_sblocked_i8": n_sb,
                              "decode_write_attend_i8": L - n_sb})
    finally:
        _set_env("GEMMA_SBLOCK_DECODE", old)
    del params, engine, ref_engine
    torch.cuda.empty_cache()


def phase_scan_path(torch, cfg, prompts, counted_generate, sampled,
                    new_tokens, path_a):
    """Path O: GEMMA_SCAN_DECODE=1, the scan-over-layers decode
    (engine/scan_decode.py): each decode step runs the 13 iterations of
    Gemma2-2B's period-2 body over stacked weights, its GEMMs through K12
    and its attention through K8; prefill stays unrolled.  Gemma2-2B at 26
    layers, i8 weights, the default runtime (bf16 KV, decode_chunk=4):
    32 greedy tokens against the same run with the switch unset (3 runs,
    two chunks under torch.profiler, one under sync debug mode "error"),
    then 8 sampled tokens (path E's settings and flat head) against the
    switch unset; then 4 greedy tokens each over i8 and f32 KV; then, at 4
    layers, 4 greedy tokens each with sfp and nuq4 weights (nuq4 tensor
    scales made equal per weight across layers, as a loaded file's are:
    weights that differ in scale do not stack) and with bf16, f32 and i4
    weights, so that every stacked kernel serves a counted run.  Every run
    holds its launch counts to the schedule (no unstacked K1 / K2 launch
    in decode) with the plain versions made to raise; the environment is
    restored afterwards."""
    import dataclasses

    from gemma_tpu_torch.engine import GemmaEngine, RuntimeConfig
    from gemma_tpu_torch.utils.synth import synth_params, synth_quant

    L = cfg.num_layers
    params = synth_params(cfg, seed=0, device="cuda")  # i8, path A's
    flat = dataclasses.replace(params, embedding=synth_quant(
        torch.Generator(device="cuda").manual_seed(11), cfg.vocab_size,
        cfg.model_dim, "cuda", "i8", rms=FLAT_EMBEDDING_RMS))
    rt = RuntimeConfig(seq_len=8192)
    ref_engine = GemmaEngine(params, cfg, rt)
    want = ref_engine.generate_batch(prompts, max_generated_tokens=new_tokens)
    flat_ref = GemmaEngine(flat, cfg, RuntimeConfig(seq_len=8192, **sampled))
    want_sampled = flat_ref.generate_batch(prompts, max_generated_tokens=8)
    old = _set_env("GEMMA_SCAN_DECODE", "1")
    try:
        engine = GemmaEngine(params, cfg, rt)
        t0 = time.monotonic()
        sp = engine.scan_params
        torch.cuda.synchronize()
        if sp is None:
            fail("path O: Gemma2-2B i8 weights did not stack")
        print(f"[4O] stacked into {len(sp.layers)} period positions x "
              f"{sp.layers[0].pre_att_norm.shape[0]} layers in "
              f"{time.monotonic() - t0:.2f} s, "
              f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated",
              flush=True)
        engine.generate_batch([p[:40] for p in prompts],
                              max_generated_tokens=6)
        dec = {"decode_write_attend_bf16": L}
        outs, timing = counted_generate("4O greedy", engine, "top1", "i8",
                                        new_tokens, dec=dec, scan=True)
        check_same_tokens(torch, ref_engine, prompts, outs, want, cfg, "4O")
        o_runs = timed_runs(torch, engine, prompts, new_tokens, "4O", timing)
        o_prof = profile_chunks(torch, engine, prompts, label="4O")
        print(f"[4O] scan against path A in this call: decode "
              f"{o_runs['tok_s']:.1f} tok/s (A {path_a['tok_s']:.1f}), step "
              f"wall median {o_runs['step_ms']:.3f} ms (A "
              f"{path_a['step_ms']:.3f}); profiled host wall "
              f"{o_prof['wall_ms']:.3f} ms/step (A {path_a['wall_ms']:.3f}), "
              f"device busy {o_prof['busy_ms']:.3f} ms/step (A "
              f"{path_a['busy_ms']:.3f}), idle share {o_prof['idle']:.3f} (A "
              f"{path_a['idle']:.3f}), launches {o_prof['launches']:.2f}/step "
              f"(A {path_a['launches']:.2f})", flush=True)
        engine = GemmaEngine(flat, cfg, RuntimeConfig(seq_len=8192,
                                                      **sampled))
        outs, _ = counted_generate("4O sampled", engine, "topk", "i8", 8,
                                   dec=dec, scan=True)
        check_same_tokens(torch, flat_ref, prompts, outs, want_sampled, cfg,
                          "4O sampled")
        del flat, flat_ref, engine
        for kv in ("i8", "f32"):
            engine = GemmaEngine(params, cfg, RuntimeConfig(seq_len=8192,
                                                            kv_kind=kv))
            outs, _ = counted_generate(
                f"4O {kv} KV", engine, "top1", "i8", 4, kv=kv,
                dec={f"decode_write_attend_{kv}": L}, scan=True)
            print(f"[4O] {kv} KV first tokens: {[o[:4] for o in outs]}",
                  flush=True)
        del params, engine, ref_engine, sp
        torch.cuda.empty_cache()
        short = dataclasses.replace(
            cfg, num_layers=4, layer_configs=cfg.layer_configs[:4],
            attention_window_sizes=cfg.attention_window_sizes[:4])
        for wkind in ("sfp", "nuq4", "bf16", "f32", "i4"):
            prm = synth_params(short, kind=wkind, seed=0, device="cuda")
            if wkind == "nuq4":
                for name in ("qkv_cat", "att_w", "gating1", "gating2",
                             "linear"):
                    s0 = getattr(prm.layers[0], name).scale
                    for lp in prm.layers:
                        setattr(lp, name, dataclasses.replace(
                            getattr(lp, name), scale=s0))
            engine = GemmaEngine(prm, short, rt)
            if engine.scan_params is None:
                fail(f"path O: {wkind} weights did not stack")
            _set_env("GEMMA_SCAN_DECODE", "0")
            try:
                want4 = GemmaEngine(prm, short, rt).generate_batch(
                    prompts, max_generated_tokens=4)
            finally:
                _set_env("GEMMA_SCAN_DECODE", "1")
            outs, _ = counted_generate(f"4O {wkind} 4 layers", engine, "top1",
                                       wkind, 4, dec={
                                           "decode_write_attend_bf16": 4},
                                       scan=True)
            check_same_tokens(torch, engine, prompts, outs, want4, short,
                              f"4O {wkind}")
            del prm, engine
            torch.cuda.empty_cache()
    finally:
        _set_env("GEMMA_SCAN_DECODE", old)
    print(f"[4O] GEMMA_SCAN_DECODE restored to {old!r}", flush=True)


if __name__ == "__main__":
    sys.exit(main())
