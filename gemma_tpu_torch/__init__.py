"""PyTorch + CUDA port of `gemma_tpu` for NVIDIA Hopper (sm_90a).

The JAX package `gemma_tpu` stays the reference; this package imports
nothing from it.  Layout mirrors it: `gemma.py` (the `Gemma` facade:
load a `.sbs`, generate ids or text), `models/` (configs, KV cache, the
forward pass, the loader, the tokenizer), `ops/` (elementwise ops,
attention references, the quantized-weight GEMMs and the hand-written
CUDA kernels behind them), `compression/` and `io/` (the weight codecs and
the `.sbs` file format, numpy), `engine/` (the serving loop, the
continuous batcher and the scan-over-layers decode), the frontends
(`run.py` the REPL, `api_server.py` / `api_client.py` the HTTP API,
`gemma_py.py`, `bindings/`, `args.py`, `evals/benchmark_helper.py`),
`scripts/` (diagnostics and timings run on the card) and `utils/`.

Every entry point runs on CUDA unless the caller passes `device="cpu"`;
on CPU tensors each kernel wrapper takes its plain PyTorch version, on
CUDA tensors it launches its kernel (built from `csrc/` at first use by
`ops/_cuda.py`) or raises.
"""
