"""Profiling and timing utilities (counterpart of
`sr_for_cfd_tpu/utils/timing.py`).

`trace_annotation` names a region in `torch.profiler` traces,
`profile_trace` captures one into a directory, `device_time` times a call
with CUDA events when it works on the card (PyTorch returns before the
device finishes, so a host clock would time the enqueue) and with the host
clock after a synchronize otherwise, and `StepTimer` accumulates host
wall time per phase.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict

import torch


@contextlib.contextmanager
def trace_annotation(name: str):
    """Named region for torch.profiler traces (a no-op cost when no trace
    is being captured)."""
    with torch.profiler.record_function(name):
        yield


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """Capture a profiler trace of the enclosed block into `log_dir` (a
    Chrome trace JSON that TensorBoard's profiler plugin and
    chrome://tracing read); the card's kernels too where there is one."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir)):
        yield


def _on_card(tree) -> bool:
    """True when a tensor in `tree` (nested tuples, lists, dicts) lies on a
    CUDA device."""
    if isinstance(tree, torch.Tensor):
        return tree.is_cuda
    if isinstance(tree, dict):
        return any(_on_card(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return any(_on_card(v) for v in tree)
    return False


def device_time(fn, *args, reps: int = 3, **kw) -> float:
    """Best-of-`reps` seconds of `fn(*args, **kw)`, measured to the end of
    its work: CUDA events when its arguments or its outputs lie on the
    card, else the host clock after a synchronize."""
    best = float("inf")
    cuda = torch.cuda.is_available() and torch.cuda.is_initialized()
    for _ in range(reps):
        if cuda:
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        if cuda:
            end.record()
            torch.cuda.synchronize()
        host = time.perf_counter() - t0
        on_card = cuda and (_on_card(args) or _on_card(kw) or _on_card(out))
        best = min(best, start.elapsed_time(end) / 1e3 if on_card else host)
    return best


class StepTimer:
    """Accumulates per-phase wall times (host-visible granularity: one
    entry per chunked device call)."""

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] = self.totals.get(name, 0.0) + time.perf_counter() - t0
            self.counts[name] = self.counts.get(name, 0) + 1

    def summary(self) -> str:
        lines = []
        for name, total in sorted(self.totals.items(), key=lambda x: -x[1]):
            n = self.counts[name]
            lines.append(f"{name}: {total:.3f}s total, {total / n * 1000:.2f}ms"
                         f" avg over {n}")
        return "\n".join(lines)
