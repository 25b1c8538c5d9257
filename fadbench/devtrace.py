"""The traced window: torch.profiler over the card, and a thread that
samples what the host's main thread is running.

The profiler records the card's activity alone (kernels, copies, sets) and
none of the host's operators, and the sampler wakes every 20 ms, so that
the trace slows the host-bound window as little as it can. The profiler's
clock is tied to the host's by one marker kernel launched on an idle card:
its start stands for the host instant of its launch (a few microseconds
late).

The device's busy time is the union of every CUDA kernel, copy and set
interval inside the window (the arithmetic of port_measure.device_profile);
the rest of the window is idle. Each idle gap is named by the host frames
sampled inside it (or the one nearest its middle): the innermost frame of
the program under test (frechet_audio_distance_exported_tpu_torch) on the
main thread's stack.
"""

from __future__ import annotations

import bisect
import sys
import threading
import time
from collections import defaultdict
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Tuple

import torch

MARKER = "spin_kernel"  # torch.cuda._sleep's kernel
SAMPLE_S = 0.02
PACKAGE = "frechet_audio_distance_exported_tpu_torch"


def union_length(spans: List[Tuple[float, float]]) -> float:
    busy, reach = 0.0, float("-inf")
    for start, end in sorted(spans):
        if end > reach:
            busy += end - max(start, reach)
            reach = end
    return busy


def gaps(spans: List[Tuple[float, float]], lo: float, hi: float) -> List[Tuple[float, float]]:
    """The parts of [lo, hi] that no span covers."""
    out, reach = [], lo
    for start, end in sorted(spans):
        if start > reach:
            out.append((reach, min(start, hi)))
        reach = max(reach, end)
        if reach >= hi:
            break
    if reach < hi:
        out.append((reach, hi))
    return [(a, b) for a, b in out if b > a]


def frame_label(frame) -> str:
    """The innermost frame of the program under test, as 'module.py:function'
    (its path below the package); the innermost frame of any file where the
    stack holds none."""
    inner = frame
    while frame is not None:
        path = Path(frame.f_code.co_filename)
        if PACKAGE in path.parts:
            rel = path.parts[path.parts.index(PACKAGE) + 1 :]
            return f"{'/'.join(rel)}:{frame.f_code.co_name}"
        frame = frame.f_back
    return f"{Path(inner.f_code.co_filename).name}:{inner.f_code.co_name}" if inner else "idle"


@dataclass
class Trace:
    window_s: float
    busy_s: float
    kernel_s: Dict[str, float]
    idle_by_frame: Dict[str, float]

    def kernel_time(self, names) -> float:
        """Seconds of device time of every kernel whose name holds one of ``names``."""
        return sum(s for k, s in self.kernel_s.items() if any(n in k for n in names))

    def breakdown(self, top: int = 10, name_chars: int = 160) -> dict:
        def head(d):
            rows = sorted(d.items(), key=lambda kv: -kv[1])[:top]
            return [[k[:name_chars], v] for k, v in rows]

        return {"device_ops": head(self.kernel_s), "idle_gaps": head(self.idle_by_frame)}


@dataclass
class Tracer:
    """start() at the window's start, stop(t0, t1) with the window's host times.
    Without ``sample_host`` it records the card alone, for an end-to-end
    metric read from the device trace in a run that is not traced."""

    sample_host: bool = True
    samples: List[Tuple[float, str]] = field(default_factory=list)

    def start(self) -> None:
        self._prof, self._mark = None, 0.0
        if torch.cuda.is_available():
            from torch.profiler import ProfilerActivity, profile

            self._prof = profile(activities=[ProfilerActivity.CUDA])
            self._prof.__enter__()
            torch.cuda.synchronize()
            self._mark = time.perf_counter()
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
        self._stop = threading.Event()
        self._thread = None
        if self.sample_host:
            main = threading.main_thread().ident
            self._thread = threading.Thread(target=self._sample, args=(main,), daemon=True)
            self._thread.start()

    def _sample(self, main: int) -> None:
        while not self._stop.is_set():
            frame = sys._current_frames().get(main)
            self.samples.append((time.perf_counter(), frame_label(frame)))
            del frame
            time.sleep(SAMPLE_S)

    def stop(self, t0: float, t1: float) -> Trace:
        self._stop.set()
        if self._thread is not None:
            self._thread.join()
        events, base = [], 0.0
        if self._prof is not None:
            torch.cuda.synchronize()
            self._prof.__exit__(None, None, None)
            events = [e for e in self._prof.profiler.kineto_results.events()
                      if e.device_type() == torch.autograd.DeviceType.CUDA]
            mark = [e for e in events if MARKER in e.name()]
            if not mark:
                raise RuntimeError("the profiler lost the marker kernel")
            # Host instant t sits at marker_ns + (t - self._mark) in the trace's clock.
            base = min(e.start_ns() for e in mark) - self._mark * 1e9
        lo, hi = t0 * 1e9 + base, t1 * 1e9 + base
        spans, per_kernel = [], defaultdict(float)
        for e in events:
            start, end = max(e.start_ns(), lo), min(e.start_ns() + e.duration_ns(), hi)
            if end > start:
                spans.append((start, end))
                per_kernel[e.name()] += (end - start) / 1e9
        times = [t * 1e9 + base for t, _ in self.samples]
        idle = defaultdict(float)
        for a, b in gaps(spans, lo, hi):
            # A gap's time goes in equal parts to the frames sampled inside
            # it, or whole to the sample nearest its middle.
            i, k = bisect.bisect_left(times, a), bisect.bisect_right(times, b)
            inside = [self.samples[j][1] for j in range(i, k)]
            if not inside:
                mid = (a + b) / 2
                near = [j for j in (i - 1, i) if 0 <= j < len(times)]
                inside = [self.samples[min(near, key=lambda j: abs(times[j] - mid))][1]
                          if near else "unsampled"]
            for label in inside:
                idle[label] += (b - a) / 1e9 / len(inside)
        return Trace(
            window_s=t1 - t0,
            busy_s=union_length(spans) / 1e9,
            kernel_s=dict(per_kernel),
            idle_by_frame=dict(idle),
        )
