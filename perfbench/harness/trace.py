"""What a traced run records: stage marks on CUDA events, host spans, and
one ``torch.profiler`` stretch of the window (the card's activity).

All of it lives in memory and is read once the window has closed. The
benchmark records it from its own files, around the calls into each layer:
the program's ``mark(stage)`` callbacks (``Trainer.step``, ``Predictor``)
and the harness's spans around the loader, the transform and the host
finalize.
"""
from __future__ import annotations

import bisect
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import torch


class Marks:
    """The ``mark(stage)`` callback of the program's entry points, on CUDA
    events: ``begin()`` before a step or batch, then each stage's mark;
    ``between_ms`` reads the device ms between two marks of every step."""

    def __init__(self):
        self.steps: List[List[Tuple[str, torch.cuda.Event]]] = []

    def _event(self) -> torch.cuda.Event:
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    def begin(self) -> None:
        self.steps.append([("begin", self._event())])

    def __call__(self, stage: str) -> None:
        self.steps[-1].append((stage, self._event()))

    def between_ms(self, first: str, last: str) -> List[float]:
        """Per step, the device ms from mark ``first`` to mark ``last``."""
        torch.cuda.synchronize()
        out = []
        for step in self.steps:
            at = dict(step)
            if first in at and last in at:
                out.append(at[first].elapsed_time(at[last]))
        return out


class Spans:
    """Host spans by name, in ms, on the host's clock."""

    def __init__(self):
        self.ms: Dict[str, List[float]] = defaultdict(list)

    def span(self, name: str):
        spans = self

        class _Span:
            def __enter__(self):
                self.t = time.perf_counter()

            def __exit__(self, *exc):
                spans.ms[name].append((time.perf_counter() - self.t) * 1e3)

        return _Span()


class Profile:
    """One ``torch.profiler`` stretch of the window: ``start()``, ``stop()``
    (each after a device synchronise), and once the window has closed
    ``summary()``. It traces the card's activity only (kernels, copies and
    the CUDA runtime calls that launched them): tracing every host operation
    as well slowed a training step by a third and starved the card."""

    def __init__(self):
        self.prof = None
        self.t0 = self.t1 = 0.0
        self.stopped = False

    @property
    def active(self) -> bool:
        return self.prof is not None and not self.stopped

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.__enter__()
        self.t0 = time.perf_counter()

    def stop(self) -> None:
        torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        self.prof.__exit__(None, None, None)
        self.stopped = True

    def summary(self) -> Optional[dict]:
        return summarise(self.prof, self.t1 - self.t0) if self.stopped else None


def _union(spans: List[Tuple[float, float]]) -> Tuple[float, List[Tuple[float, float]]]:
    """(total length, the gaps between) of the union of (start, end) spans."""
    spans = sorted(spans)
    busy, gaps = 0.0, []
    lo, hi = spans[0]
    for s, e in spans[1:]:
        if s > hi:
            busy += hi - lo
            gaps.append((hi, s))
            lo, hi = s, e
        else:
            hi = max(hi, e)
    return busy + hi - lo, gaps


def summarise(prof, window_s: float, top: int = 10) -> dict:
    """The stretch's device busy seconds (the union of every device
    operation's interval), its length, the device seconds and call counts by
    operation name, the top operations, and the idle gaps on the device by
    the CUDA runtime call the host was in across each gap ("host work
    between CUDA calls" where it was in none), summed by name."""
    from torch.autograd import DeviceType

    events = prof.events()
    dev = [(e.time_range.start, e.time_range.end, e.name) for e in events if e.device_type == DeviceType.CUDA]
    if not dev:
        raise RuntimeError("the profiler saw no device activity")
    busy_us, gaps = _union([(s, e) for s, e, _ in dev])
    by_name: Dict[str, List[float]] = defaultdict(lambda: [0.0, 0])
    for s, e, name in dev:
        by_name[name][0] += (e - s) / 1e6
        by_name[name][1] += 1
    host = sorted((e.time_range.start, e.time_range.end, e.name) for e in events
                  if e.device_type == DeviceType.CPU)
    starts = [s for s, _, _ in host]
    idle: Dict[str, float] = defaultdict(float)
    for g0, g1 in gaps:
        mid, name = 0.5 * (g0 + g1), "host work between CUDA calls"
        # the innermost (latest-starting) host event across the gap's middle
        for s, e, n in reversed(host[max(0, bisect.bisect_right(starts, mid) - 256): bisect.bisect_right(starts, mid)]):
            if e >= mid:
                name = n
                break
        idle[name] += (g1 - g0) / 1e6
    ops = sorted(((n, v[0]) for n, v in by_name.items()), key=lambda kv: -kv[1])
    return {
        "busy_s": busy_us / 1e6,
        "window_s": window_s,
        "kernels": {n: {"seconds": v[0], "calls": v[1]} for n, v in by_name.items()},
        "device_ops": [[n[:120], s] for n, s in ops[:top]],
        "idle_gaps": [[n[:120], s] for n, s in sorted(idle.items(), key=lambda kv: -kv[1])[:top]],
    }


def kernel_seconds(result: dict, name: str) -> Tuple[float, int]:
    """Device seconds and calls of the kernels whose name holds ``name`` as
    a whole word (``roi_align_fwd_kernel`` is not ``..._adaptive_kernel``)."""
    import re

    pattern = re.compile(rf"(?<![A-Za-z0-9_]){re.escape(name)}(?![A-Za-z0-9_])")
    secs, calls = 0.0, 0
    for n, v in result["kernels"].items():
        if pattern.search(n):
            secs += v["seconds"]
            calls += v["calls"]
    return secs, calls
