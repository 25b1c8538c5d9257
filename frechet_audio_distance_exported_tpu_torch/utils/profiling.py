"""Tracing and profiling utilities.

The counterpart of frechet_audio_distance_exported_tpu/utils/profiling.py:

- ``StageTimer``: wall time per named stage, with a report (copied); each
  stage is also a span;
- ``span``, ``start``, ``stop``: the port's span recorder (below), which the
  JAX package does not have;
- ``trace``: a torch.profiler trace of the CPU and the card, gated by an
  argument or FAD_TPU_TRACE (jax.profiler.trace there);
- ``annotate``: a named range in that trace (jax.profiler.TraceAnnotation
  there).

The span recorder. ``start()`` begins recording and ``stop()`` ends it and
hands over the spans recorded in between. While it records, each
``with span(name):`` keeps a ``Span``: its name, its start and end on the
``time.perf_counter_ns()`` clock, the thread that ran it, its own id, the id
of the span that caused it (the innermost span open on the thread where
``span()`` was called, or the ``parent`` passed) and the id of the root span
of its tree (``call``: in score() the ``score`` span, so that every span of
one call carries the call's id), and the integer ``counts`` attached where
the work happened. ``time.perf_counter_ns()`` is the clock of
``time.perf_counter()``, the clock that a device trace is tied to by a marker
kernel (the trace's instant of the host instant t is marker_ns + t - mark):
a span's interval maps onto the device trace by the same offset. While
``trace()`` is active each span is also an ``annotate(name)`` range, so the
Chrome trace shows the spans beside the kernels.

When nothing records, ``span()`` tests one module variable and returns a
shared context that does nothing: it makes no span and reads no clock.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import threading
import time
from collections import defaultdict
from typing import Dict, Iterator, List, Optional

import torch


class Span:
    """One recorded interval of work (see the module docstring). Entered
    once, as a context manager; after ``stop()`` a plain record."""

    __slots__ = ("name", "id", "parent", "call", "thread", "start_ns", "end_ns", "counts",
                 "_rec", "_range")

    def __init__(self, name: str, id: int, parent: Optional[int] = None,
                 call: Optional[int] = None, thread: int = 0, start_ns: int = 0,
                 end_ns: int = 0, counts: Optional[Dict[str, int]] = None, _rec=None):
        self.name = name
        self.id = id
        self.parent = parent
        self.call = id if call is None else call
        self.thread = thread
        self.start_ns = start_ns
        self.end_ns = end_ns
        self.counts = counts or {}
        self._rec = _rec
        self._range = None

    @property
    def duration_ns(self) -> int:
        return self.end_ns - self.start_ns

    def __enter__(self) -> "Span":
        rec = self._rec
        self.thread = threading.get_ident()
        rec.stack().append(self)
        if rec.annotate:
            self._range = annotate(self.name)
            self._range.__enter__()
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, typ, value, tb) -> None:
        self.end_ns = time.perf_counter_ns()
        rec = self._rec
        if self._range is not None:
            self._range.__exit__(typ, value, tb)
            self._range = None
        rec.stack().pop()
        spans = rec.spans
        if spans is not None:
            spans.append(self)

    def __repr__(self) -> str:
        return (f"Span({self.name!r}, id={self.id}, parent={self.parent}, call={self.call}, "
                f"{self.duration_ns} ns, {self.counts})")


class _NoSpan:
    """What span() returns when nothing records."""

    __slots__ = ()

    def __enter__(self) -> None:
        return None

    def __exit__(self, typ, value, tb) -> None:
        return None


_NO_SPAN = _NoSpan()


class _Recorder:
    def __init__(self) -> None:
        self.spans: Optional[List[Span]] = []
        self.annotate = False
        self._ids = itertools.count(1)
        self._local = threading.local()

    def stack(self) -> List[Span]:
        try:
            return self._local.stack
        except AttributeError:
            self._local.stack = []
            return self._local.stack

    def open(self, name: str, parent, counts: Dict[str, int]) -> Span:
        if not isinstance(parent, Span):
            stack = self.stack()
            parent = stack[-1] if stack else None
        sid = next(self._ids)
        if parent is None:
            return Span(name, sid, counts=counts, _rec=self)
        return Span(name, sid, parent.id, parent.call, counts=counts, _rec=self)


_recorder: Optional[_Recorder] = None


def span(name: str, parent=None, **counts: int):
    """A context that records the span ``name`` while the recorder runs, or
    the shared no-op context when it does not. ``parent``: the span that
    caused this one where that is not the innermost span open on this thread
    (work handed to another thread); ``counts``: integers attached to the
    span (files, bytes)."""
    rec = _recorder
    if rec is None:
        return _NO_SPAN
    return rec.open(name, parent, counts)


def start() -> None:
    """Begin recording spans (in memory, every thread)."""
    global _recorder
    if _recorder is not None:
        raise RuntimeError("spans are already being recorded")
    _recorder = _Recorder()


def stop() -> List[Span]:
    """End recording; the spans that ended since start(), in the order they
    ended. A span still open is not among them."""
    global _recorder
    rec, _recorder = _recorder, None
    if rec is None:
        raise RuntimeError("spans are not being recorded")
    spans, rec.spans = rec.spans, None
    return spans


def self_ns(spans: List[Span]) -> Dict[int, int]:
    """Each span's self time by id: its duration minus the part of its
    interval that its children (in ``spans``) cover."""
    children = defaultdict(list)
    for s in spans:
        if s.parent is not None:
            children[s.parent].append(s)
    out = {}
    for s in spans:
        covered, reach = 0, s.start_ns
        for c in sorted(children[s.id], key=lambda c: c.start_ns):
            lo, hi = max(c.start_ns, reach), min(c.end_ns, s.end_ns)
            if hi > lo:
                covered += hi - lo
                reach = hi
        out[s.id] = s.duration_ns - covered
    return out


class StageTimer:
    """Accumulates wall time per named stage; thread-compatible enough for the
    decode pool (each `with` is independent)."""

    def __init__(self) -> None:
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str, span_name: Optional[str] = None) -> Iterator[None]:
        """Times the stage ``name``; while spans are recorded it is also the
        span ``span_name`` (``name`` where not given)."""
        t0 = time.perf_counter()
        try:
            with span(span_name or name):
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
    (rank 0 without one). Spans entered inside it are ranges of the trace;
    it records them itself where start() has not been called."""
    log_dir = log_dir or os.environ.get("FAD_TPU_TRACE")
    if not log_dir:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    dist = torch.distributed
    rank = dist.get_rank() if dist.is_available() and dist.is_initialized() else 0
    own = _recorder is None
    if own:
        start()
    rec = _recorder
    rec.annotate = True
    try:
        with torch.profiler.profile(activities=activities) as prof:
            yield
    finally:
        rec.annotate = False
        if own and _recorder is rec:
            stop()
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, f"trace_rank{rank}_{os.getpid()}.json"))


def annotate(name: str):
    """A named range in the profiler's timeline (torch.profiler.record_function)."""
    return torch.profiler.record_function(name)
