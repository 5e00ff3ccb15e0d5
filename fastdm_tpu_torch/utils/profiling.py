"""Profiling helpers (port of fastdm_tpu/utils/profiling.py).

`time_record` and `benchmark_kernel` time on the host clock around a
device-synced call: on a CUDA device they synchronize before the call (so
the time holds no earlier queued work) and after it. `trace(log_dir)` is a
torch.profiler region recording the CPU and, on the card, CUDA activity;
it exports a Chrome trace into log_dir. The JAX module's
enable_compilation_cache has no counterpart: it sets XLA's compilation
cache, and the port's kernels are built once by nvcc into
fastdm_tpu_torch/_build/ and reused from there.
"""

from __future__ import annotations

import contextlib
import functools
import os
import time
from typing import Callable, Dict, List

import torch

do_time_prof = False  # module flag, as the reference's
time_records: Dict[str, List[float]] = {}


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def time_record(name: str | None = None) -> Callable:
    """Decorator: the device-synced wall time of each call, appended to
    `time_records[name]` while `do_time_prof` is set."""

    def deco(fn: Callable) -> Callable:
        key = name or fn.__qualname__

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if not do_time_prof:
                return fn(*args, **kwargs)
            _sync()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            _sync()
            time_records.setdefault(key, []).append(time.perf_counter() - t0)
            return out

        return wrapper

    return deco


def benchmark_kernel(fn: Callable, *args, warmup: int = 3, reps: int = 20) -> float:
    """Best-of-reps latency in seconds, device-synced."""
    for _ in range(warmup):
        fn(*args)
    best = float("inf")
    for _ in range(reps):
        _sync()
        t0 = time.perf_counter()
        fn(*args)
        _sync()
        best = min(best, time.perf_counter() - t0)
    return best


def kernel_output_assert_close(a, b, atol=1.8e-2, rtol=1.6e-2) -> None:
    """Elementwise closeness in float32, with the JAX module's tolerances."""
    a = torch.as_tensor(a).detach().float().cpu()
    b = torch.as_tensor(b).detach().float().cpu()
    torch.testing.assert_close(a, b, atol=atol, rtol=rtol)


@contextlib.contextmanager
def trace(log_dir: str = "fastdm_trace"):
    """A torch.profiler region (CPU, plus CUDA when a GPU is visible); on
    exit the Chrome trace is written to log_dir/trace.json, and the
    profiler is left on the yielded object for key_averages()."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        try:
            yield prof
        finally:
            _sync()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
