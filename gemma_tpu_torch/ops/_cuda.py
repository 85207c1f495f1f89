"""Build, bind and count the hand-written CUDA kernels of `csrc/`.

Each `csrc/*.cu` source is compiled on first use by `nvcc` for sm_90a
into its own shared library with a plain C interface, under
`build/gemma_tpu_torch/` at the checkout root, named by a hash of the
source, the shared header and the flags (a changed source rebuilds).
All sources compile in parallel, one `nvcc` each.  The libraries are
loaded with ctypes; every C entry returns `cudaGetLastError()` after its
launch, and `Kernel.launch` raises when that is not 0.

Each `Kernel` carries `launches`, a plain integer that grows by one per
launch of that kernel and nowhere else.  Every C entry reports, through a
trailing `int* launched` before the stream, a bitmask of the kernels it
put on the stream: bit 0 its own, bit i + 1 the i-th of the `passes` it
was declared with (the prefill GEMMs' and the top-k head's entries chain
norm passes in the same call).
`Kernel.launch` adds to the counts from that report alone, so a count says
what ran, not what the wrapper asked for.  `chip_smoke.py` zeroes and
reads the counts around the main path to show the path ran through the
kernels.  `time_ms` is the one device timer of `chip_smoke.py` and the
scripts.
Nothing here runs at import: the CPU tests import every module, on
machines with neither `nvcc` nor a card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "gemma_tpu_torch"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
BASE_FLAGS = ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
              "-lineinfo"]
# Per-source extra flags.  decode_attention.cu keeps mul/add unfused so
# its RoPE and quantization round like the plain (separate-op) version.
EXTRA_FLAGS = {"decode_attention.cu": ["-fmad=false"]}
SHARED_HEADERS = ["common.cuh", "gemm_common.cuh"]

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}

P = ctypes.c_void_p
I = ctypes.c_int
F = ctypes.c_float


def nvcc_path() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build on a machine "
                       "with the CUDA toolkit")


def _target(source: str) -> Path:
    h = hashlib.sha256()
    for name in [source] + SHARED_HEADERS:
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(ARCH + BASE_FLAGS + EXTRA_FLAGS.get(source, []))
             .encode())
    return BUILD_DIR / f"{Path(source).stem}-{h.hexdigest()[:16]}.so"


def build_all(verbose: bool = False,
              logs: dict | None = None) -> dict[str, Path]:
    """Compile every source not yet built, all in parallel.

    Returns {source: library path}; `logs` collects nvcc's output per
    source built (with `verbose`, ptxas's registers and spills).  Raises
    with nvcc's output on failure."""
    sources = sorted(p.name for p in CSRC.glob("*.cu"))
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    targets = {s: _target(s) for s in sources}
    procs = {}
    for src, out in targets.items():
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = ([nvcc_path()] + ARCH + BASE_FLAGS + EXTRA_FLAGS.get(src, [])
               + (["-Xptxas", "-v"] if verbose else [])
               + ["-I", str(CSRC), "-o", str(tmp), str(CSRC / src)])
        procs[src] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      tmp, out)
    errors = []
    for src, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc {src} failed ({proc.returncode}):\n{log}")
            continue
        if verbose and log:
            print(f"[nvcc {src}]\n{log}")
        if logs is not None:
            logs[src] = log
        os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return targets


def library(source: str) -> ctypes.CDLL:
    with _lock:
        if source not in _libs:
            # First use builds every source at once (parallel nvcc) so a
            # run pays one build wall time, not one per kernel.
            paths = build_all()
            for src, path in paths.items():
                if src not in _libs:
                    _libs[src] = ctypes.CDLL(str(path))
        return _libs[source]


class Kernel:
    """One C entry point of one `csrc/` source, with its launch count.

    passes: the Kernels (other C kernels) this entry may launch besides
    its own, in the bit order of its `launched` report."""

    def __init__(self, name: str, source: str, symbol: str, argtypes: list,
                 passes: tuple["Kernel", ...] = ()):
        self.name = name
        self.source = source
        self.symbol = symbol
        self.argtypes = argtypes
        self.passes = passes
        self.launches = 0
        self._fn = None

    def _bind(self):
        if self._fn is None:
            fn = getattr(library(self.source), self.symbol)
            # trailing: the `launched` report, then the CUDA stream
            fn.argtypes = self.argtypes + [ctypes.POINTER(I), P]
            fn.restype = I
            self._fn = fn
        return self._fn

    def launch(self, *args) -> None:
        fn = self._bind()
        launched = I(0)
        err = fn(*args, ctypes.byref(launched), _stream())
        if err != 0:
            raise RuntimeError(f"CUDA kernel {self.name} failed to launch: "
                               f"cudaError {err}")
        bits = launched.value
        if bits >> (1 + len(self.passes)):
            raise RuntimeError(f"{self.symbol} reported launches {bits:#x} "
                               "beyond its declared passes")
        for i, k in enumerate((self,) + self.passes):
            k.launches += (bits >> i) & 1


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


def check(t: torch.Tensor, name: str, dtype: torch.dtype,
          shape: tuple | None = None) -> None:
    """Raise unless `t` is a contiguous CUDA tensor of `dtype` (and `shape`)."""
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")


def time_ms(fn, iters: int = 20, warmup: int = 2) -> float:
    """Device time of one call of `fn`: `iters` calls captured in a CUDA
    graph, replayed three times between CUDA events, so host-side Python
    between launches is not counted.  A call that cannot be captured
    raises."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
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
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (3 * iters)


def all_kernels() -> list[Kernel]:
    """Every kernel of the port, in the order of the TPU kernel table."""
    from gemma_tpu_torch.ops import (decode_attention, flash_attention,
                                     matmul, nuq_diag, sampling)

    return [*matmul.MATMUL.values(), matmul.PRENORM, matmul.POSTNORM_ADD,
            *matmul.GATED.values(), *matmul.TOP1.values(),
            *matmul.TOPK.values(), matmul.TOPK_MERGE, sampling.DRAW_TOPK,
            decode_attention.DECODE_ATTENTION_I8,
            decode_attention.DECODE_ATTENTION_BF16,
            decode_attention.DECODE_ATTENTION_F32,
            flash_attention.FLASH_ATTENTION_I8,
            flash_attention.FLASH_ATTENTION_BF16,
            flash_attention.FLASH_ATTENTION_F32,
            *decode_attention.DECODE_WRITE_ATTEND.values(),
            *decode_attention.KV_WRITE.values(),
            *decode_attention.DECODE_ATTEND.values(),
            *decode_attention.DECODE_SBLOCKED.values(),
            *matmul.MATMUL_STACKED.values(), *matmul.GATED_STACKED.values(),
            *matmul.MATMUL_SM90.values(), *matmul.GATED_SM90.values(),
            *nuq_diag.KERNELS.values()]
