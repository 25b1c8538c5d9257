"""Tracing and profiling utilities.

The counterpart of frechet_audio_distance_exported_tpu/utils/profiling.py:

- ``StageTimer``: wall time per named stage, with a report (copied);
- ``trace``: a torch.profiler trace of the CPU and the card, gated by an
  argument or FAD_TPU_TRACE (jax.profiler.trace there);
- ``annotate``: a named range in that trace (jax.profiler.TraceAnnotation
  there).
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, Iterator, Optional

import torch


class StageTimer:
    """Accumulates wall time per named stage; thread-compatible enough for the
    decode pool (each `with` is independent)."""

    def __init__(self) -> None:
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def report(self) -> str:
        lines = ["[FAD-TORCH] stage timings:"]
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            lines.append(
                f"  {name:<24} {self.totals[name]*1000:9.1f} ms  ({self.counts[name]} calls)"
            )
        return "\n".join(lines)


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None) -> Iterator[None]:
    """torch.profiler over the CPU and, where there is one, the card. Enabled
    when ``log_dir`` is given or FAD_TPU_TRACE names a directory, else a
    no-op. On exit a Chrome trace (chrome://tracing, Perfetto) is written
    there as trace_rank<r>_<pid>.json: one file per rank of a process group
    (rank 0 without one)."""
    log_dir = log_dir or os.environ.get("FAD_TPU_TRACE")
    if not log_dir:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    dist = torch.distributed
    rank = dist.get_rank() if dist.is_available() and dist.is_initialized() else 0
    with torch.profiler.profile(activities=activities) as prof:
        yield
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, f"trace_rank{rank}_{os.getpid()}.json"))


def annotate(name: str):
    """A named range in the profiler's timeline (torch.profiler.record_function)."""
    return torch.profiler.record_function(name)
