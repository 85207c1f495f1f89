"""The CUDA bindings of the port, checked without a card.

Every C entry of gemma_tpu_torch/csrc is declared to ctypes with the
parameters of its C signature (a mismatch would pass garbage on the card),
and `Kernel.launch` counts exactly the launches an entry reports."""

import re

import pytest
import torch

from gemma_tpu_torch.ops import _cuda

torch.set_num_threads(1)

_ENTRY = re.compile(r'extern "C" int (\w+)\((.*?)\)\s*\{', re.S)


def _c_entries() -> dict[str, list[str]]:
    out = {}
    for src in _cuda.CSRC.glob("*.cu"):
        for name, params in _ENTRY.findall(src.read_text()):
            out[name] = [" ".join(p.split()) for p in params.split(",")]
    return out


def _ctype(param: str):
    if "*" in param:
        return _cuda.P
    return {"int": _cuda.I, "float": _cuda.F}[param.split()[0]]


@pytest.mark.parametrize("kernel", _cuda.all_kernels(), ids=lambda k: k.name)
def test_argtypes_match_c_signature(kernel):
    params = _c_entries()[kernel.symbol]
    assert params[-2:] == ["int* launched", "cudaStream_t st"]
    assert [_ctype(p) for p in params[:-2]] == kernel.argtypes


def _fake_kernel(monkeypatch, report: int, err: int = 0):
    pre = _cuda.Kernel("pre", "x.cu", "pre", [])
    post = _cuda.Kernel("post", "x.cu", "post", [])
    main = _cuda.Kernel("main", "x.cu", "main", [_cuda.I],
                        passes=(pre, post))

    def fn(*args):
        args[-2]._obj.value = report  # the entry's `launched` report
        return err

    main._fn = fn
    monkeypatch.setattr(_cuda, "_stream", lambda: 0)
    return main, pre, post


@pytest.mark.parametrize("report,want", [
    (0b001, (1, 0, 0)),   # GEMM alone
    (0b011, (1, 1, 0)),   # prologue pass + GEMM
    (0b101, (1, 0, 1)),   # GEMM + epilogue pass
    (0b111, (1, 1, 1)),
    (0b000, (0, 0, 0)),   # nothing launched, nothing counted
])
def test_launch_counts_what_the_entry_reports(monkeypatch, report, want):
    main, pre, post = _fake_kernel(monkeypatch, report)
    main.launch(3)
    main.launch(3)
    assert (main.launches, pre.launches, post.launches) == tuple(
        2 * w for w in want)


@pytest.mark.parametrize("report,err,match", [
    (0b1000, 0, "beyond its declared passes"),
    (0b001, 700, "cudaError 700"),
])
def test_launch_raises_on_bad_report(monkeypatch, report, err, match):
    main, pre, post = _fake_kernel(monkeypatch, report, err)
    with pytest.raises(RuntimeError, match=match):
        main.launch(3)
    assert main.launches == pre.launches == post.launches == 0
