"""Profiling zones (counterpart of gemma_tpu/utils/profiler.py; reference
util/zones.h + the hwy profiler usage).

Host-side zone accounting: `zone("Startup.weights")` context managers
accumulate wall time + call counts per named zone (the GCPP_ZONE analog);
`print_results()` prints the per-zone table the reference emits via
PROFILER_PRINT_RESULTS at REPL exit (gemma/run.cc:313).  Kernels run
asynchronously, so a zone measures launch + sync intervals; wrap the
region you block on.  Device traces come from torch.profiler directly
(chip_smoke.py, scripts/).

Zones are process-global and thread-safe, like the reference's static
profiler.  Enable/disable with `enable(False)` (zones become no-ops).
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Iterator

_lock = threading.Lock()
_zones: dict[str, list] = {}  # name -> [total_seconds, calls]
_enabled = True


def enable(on: bool = True) -> None:
    global _enabled
    _enabled = on


def reset() -> None:
    with _lock:
        _zones.clear()


@contextlib.contextmanager
def zone(name: str) -> Iterator[None]:
    """Accumulate wall time under `name` (GCPP_ZONE analog)."""
    if not _enabled:
        yield
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        with _lock:
            entry = _zones.setdefault(name, [0.0, 0])
            entry[0] += dt
            entry[1] += 1


def results() -> dict[str, tuple[float, int]]:
    with _lock:
        return {k: (v[0], v[1]) for k, v in _zones.items()}


def print_results(reset_after: bool = True) -> None:
    """PROFILER_PRINT_RESULTS analog: per-zone totals, sorted by time."""
    rows = sorted(results().items(), key=lambda kv: -kv[1][0])
    if not rows:
        return
    total = sum(t for t, _ in (v for _, v in rows))
    print(f"{'Zone':<32} {'total':>10} {'calls':>8} {'mean':>10} {'%':>6}")
    for name, (t, calls) in rows:
        print(f"{name:<32} {t * 1e3:9.2f}ms {calls:8d} "
              f"{t / calls * 1e3:9.3f}ms {100 * t / total:5.1f}%")
    if reset_after:
        reset()

