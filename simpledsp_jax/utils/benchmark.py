"""Benchmark / profiling harness (SURVEY.md §5 "tracing/profiling" plan).

The reference's closest artifact is Catch2 BENCHMARK micro-timing
(reference: test/testFFT.cpp:241-253, test/testIIR.cpp:482-556); here the
equivalents are `block_until_ready`-bracketed wall timing in two patterns:

* `time_blocked`  — per-call latency (sync every call): what a request/
  response user sees, includes dispatch latency.
* `time_streaming` — pipelined throughput (state chained, sync once): what
  a streaming pipeline sees; device compute hides dispatch latency.

`emit_metric` prints the BASELINE.json-style one-line JSON record, and
`require_gpu` / `device_detail` make every measurement name the card it
ran on and refuse to run anywhere else.
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import time
from typing import Any, Callable, Dict, List, Optional

import jax

__all__ = ["time_blocked", "time_streaming", "emit_metric", "trace",
           "require_gpu", "card_label", "device_detail"]


def require_gpu(count: int = 1) -> List[jax.Device]:
    """The JAX devices, or SystemExit when they are not at least ``count``
    GPUs: a measurement never falls back to another platform."""
    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise SystemExit(f"needs a GPU; JAX found {devices[0].platform} "
                         f"({devices[0].device_kind})")
    if len(devices) < count:
        raise SystemExit(f"needs {count} GPUs, found {len(devices)}")
    return devices


def card_label() -> str:
    """The cards' names and power limits as nvidia-smi reports them: a card
    held below its maximum power runs slower under load."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return "; ".join(line.strip() for line in out.splitlines()
                     if line.strip())


def device_detail() -> Dict[str, Any]:
    """Platform, device kind, device count and card label of this run."""
    d = jax.devices()[0]
    return {"platform": d.platform, "device_kind": d.device_kind,
            "count": len(jax.devices()), "card": card_label()}


def time_blocked(fn: Callable, *args, iters: int = 10,
                 warmup: int = 1) -> float:
    """Mean seconds per call, waiting for every call's result (includes
    per-call dispatch latency — the request/response view)."""
    for _ in range(warmup):
        jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(iters):
        jax.block_until_ready(fn(*args))
    return (time.perf_counter() - t0) / iters


def time_streaming(step: Callable, x, state, iters: int = 16,
                   warmup: int = 1) -> float:
    """Mean seconds per call for a streaming step (y, state') = step(x, state),
    chaining state and waiting once at the end — dispatch latency hidden,
    the pipeline view."""
    out, s = step(x, state)
    for _ in range(warmup - 1):
        out, s = step(x, s)
    jax.block_until_ready((out, s))
    s = state
    t0 = time.perf_counter()
    for _ in range(iters):
        out, s = step(x, s)
    jax.block_until_ready((out, s))
    return (time.perf_counter() - t0) / iters


def emit_metric(metric: str, value: float, unit: str,
                baseline: Optional[float] = None,
                detail: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Print (and return) the one-line JSON record the driver collects."""
    rec: Dict[str, Any] = {"metric": metric, "value": round(value, 2),
                           "unit": unit}
    if baseline:
        rec["vs_baseline"] = round(value / baseline, 2)
    if detail:
        rec["detail"] = detail
    print(json.dumps(rec))
    return rec


@contextlib.contextmanager
def trace(dirname: str):
    """jax.profiler trace context; view with TensorBoard or xprof."""
    jax.profiler.start_trace(dirname)
    try:
        yield dirname
    finally:
        jax.profiler.stop_trace()
