"""Spans and counters inside the port, on the host's clock; off by default.

Off, ``span(name, **attrs)`` returns one shared no-op context manager and
``count(name, n)`` returns at once: one check of a module-level reference
per call, no span object, no CUDA event, no host sync. ``enable()`` starts a
``Tracer``; from then on every span records its name, its thread, its start
and end (``time.perf_counter_ns``), its parent (the innermost span open on
its thread) and its request id, and counters are summed by name, all in
memory until ``snapshot()``. ``disable()`` turns it off again.

Request ids: ``request(key)`` sets the id that later spans of the calling
thread carry. ``DetectionTransform`` sets the image id of the record it
reads (so on a loader thread, or along a frame served on one thread, every
span carries its image's id) and ``device_prefetch`` sets the index of the
batch it hands its consumer (so the eval loop's and the training loop's
spans carry their batch's index).

Stages: ``stage(name, mark)`` ends a training step's stage. Inside an
open span (``train.step``) it records the span ``stage.<name>`` from the
thread's previous stage boundary, or from that span's start when that is
later, to now; then it calls ``mark(name)`` when ``mark`` is given: the
``mark`` callbacks of ``Trainer.step`` are called exactly as before.

Clocks: spans keep ``perf_counter_ns``; ``torch.profiler``'s events are on
the Unix clock (``time.time_ns``). ``enable()`` reads one pair of the two
clocks (``anchor``), so ``unix_ns(snapshot, t)`` places a span's time on the
profiler's timeline. ``device_gaps(prof)`` gives the idle gaps of a
profiled stretch on that clock with the thread that launched the work
ending each, ``idle_by_span`` files them under that thread's program spans
(or the main thread's), and ``add_to_chrome_trace`` writes the spans into
a trace the profiler exported.

Span names, dotted by layer (where each is recorded):

* ``data.read``, ``data.transform`` (``DetectionTransform``, per image, on
  the thread that runs it), ``data.collate`` (``collate``, per batch),
  ``data.h2d`` (``device_prefetch``'s pin and copy enqueue, on its thread),
  ``data.wait`` (``device_prefetch``'s consumer waiting for a batch);
* ``predict`` (``Predictor.__call__``, the copy to the device included),
  ``train.step`` (``Trainer.step``) and its stages ``stage.backbone``,
  ``stage.rpn``, ``stage.sampling``, ``stage.roi_align``, ``stage.heads``,
  ``stage.backward``, ``stage.optimizer``; inside ``predict``'s eager
  calls, a trunk's own stages ``stage.backbone.res2`` .. ``.res5`` (Swin);
* ``eval.wait`` (``HostCopy.numpy``'s wait for the copies),
  ``eval.consume`` (per batch, with its ``image_ids``: the cascade or
  finalize and the evaluator's ``process``), ``eval.evaluate`` (the
  evaluator's ``evaluate``, per pass).

Counters: ``data.images`` (images transformed); ``data.resize.native``,
``data.resize.pil`` (``data/transforms.py``, one per image resized with
``interp="pil"``: in native code or in PIL); ``predict.eager``,
``predict.graph.capture``, ``predict.graph.replay`` (``Predictor.__call__``,
one of the three per call: run eagerly, captured as CUDA graphs, replayed);
``swin.tokens``, ``swin.window_tokens`` (``models/swin.py``, per stage of
an eager or capturing call: the tokens entering its attention blocks, and
those padded to window multiples); ``kernel.roi_align_fwd``,
``kernel.roi_align_fwd.adaptive``, ``kernel.roi_align_window``,
``kernel.roi_align_bwd``, ``kernel.roi_align_bwd.adaptive``,
``kernel.roi_align_bwd_bf16``, ``kernel.nms_keep`` (one a call, both
passes), ``kernel.iou_match`` (two a call) and ``kernel.frozen_bn`` (the
ResNet trunk's FrozenBN, residual and ReLU: 49 an R50 forward): the CUDA
kernels' launches by their wrappers in ``ops/`` (a graph replay calls no
wrapper).
"""
from __future__ import annotations

import heapq
import itertools
import json
import re
import threading
import time
from collections import defaultdict
from typing import Any, Dict, List, Optional, Sequence, Tuple

_tracer: Optional["Tracer"] = None


class _NoSpan:
    """The context manager of every span while tracing is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NO_SPAN = _NoSpan()


def enable() -> "Tracer":
    """Start recording into a new ``Tracer`` (the previous one, if any, is
    dropped) and return it."""
    global _tracer
    _tracer = Tracer()
    return _tracer


def disable() -> None:
    global _tracer
    _tracer = None


def span(name: str, **attrs):
    """A context manager around one piece of work: the shared no-op while
    tracing is off, else a span recorded when it exits."""
    t = _tracer
    if t is None:
        return NO_SPAN
    return Span(t, name, attrs)


def clock(name: str, **attrs) -> "Span":
    """A span that reads the clock whether tracing is on or not, for a
    caller that keeps the time itself (``Span.ms`` once it has exited); it
    is recorded only while tracing is on."""
    return Span(_tracer, name, attrs)


def count(name: str, n: int = 1) -> None:
    t = _tracer
    if t is not None:
        t.count(name, n)


def request(key: Any) -> None:
    """Set the request id that the calling thread's later spans carry."""
    t = _tracer
    if t is not None:
        t.thread().request = key


def stage(name: str, mark=None) -> None:
    """End the model stage ``name``: record ``stage.<name>`` while tracing
    is on, then call ``mark(name)`` when ``mark`` is given."""
    t = _tracer
    if t is not None:
        t.stage(name)
    if mark:
        mark(name)


def snapshot() -> Optional[Dict[str, Any]]:
    """What the running tracer holds (``Tracer.snapshot``), None when off."""
    t = _tracer
    return None if t is None else t.snapshot()


class _Thread:
    """One thread's open spans, request id and last stage boundary."""

    __slots__ = ("tid", "stack", "request", "boundary")

    def __init__(self):
        self.tid = threading.get_native_id()
        self.stack: List["Span"] = []
        self.request: Any = None
        self.boundary = 0


class Span:
    """One recorded piece of work; ``start``/``end`` in perf_counter ns."""

    __slots__ = ("tracer", "name", "attrs", "start", "end", "id", "parent", "request", "state")

    def __init__(self, tracer: Optional["Tracer"], name: str, attrs: Dict[str, Any]):
        self.tracer, self.name, self.attrs = tracer, name, attrs
        self.start = self.end = 0

    @property
    def ms(self) -> float:
        return (self.end - self.start) / 1e6

    def __enter__(self):
        t = self.tracer
        if t is not None:
            st = self.state = t.thread()
            self.id = next(t.ids)
            self.parent = st.stack[-1].id if st.stack else None
            self.request = st.request
            st.stack.append(self)
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.end = time.perf_counter_ns()
        t = self.tracer
        if t is not None:
            stack = self.state.stack
            if stack and stack[-1] is self:
                stack.pop()
            t.records.append((self.id, self.name, self.state.tid, self.start, self.end, self.parent, self.request,
                              self.attrs))
        return False


class Tracer:
    """The spans and counters recorded since ``enable()``."""

    def __init__(self):
        self.perf_ns, self.unix_ns = time.perf_counter_ns(), time.time_ns()
        self.ids = itertools.count()
        self.records: List[tuple] = []
        self.counters: Dict[str, int] = defaultdict(int)
        self.lock = threading.Lock()
        self.local = threading.local()

    def thread(self) -> _Thread:
        st = getattr(self.local, "st", None)
        if st is None:
            st = self.local.st = _Thread()
        return st

    def count(self, name: str, n: int) -> None:
        with self.lock:
            self.counters[name] += n

    def stage(self, name: str) -> None:
        st = self.thread()
        now, last = time.perf_counter_ns(), st.boundary
        st.boundary = now
        if st.stack:  # a stage is recorded inside the span of its entry point only
            parent = st.stack[-1]
            self.records.append((next(self.ids), f"stage.{name}", st.tid, max(last, parent.start), now, parent.id,
                                 st.request, {}))

    def snapshot(self) -> Dict[str, Any]:
        """``spans``: one dict per span that has ended (``id``, ``name``,
        ``thread``, ``start_ns``, ``end_ns``, ``parent``, ``request``,
        ``self_ns`` (its length less the part its child spans cover) and
        its attributes); ``counters``; ``anchor``: the (``perf_ns``,
        ``unix_ns``) pair read at ``enable()``."""
        records = list(self.records)
        with self.lock:
            counters = dict(self.counters)
        children: Dict[int, List[Tuple[int, int]]] = defaultdict(list)
        for r in records:
            if r[5] is not None:
                children[r[5]].append((r[3], r[4]))
        spans = []
        for sid, name, tid, start, end, parent, req, attrs in records:
            covered = _covered(children.get(sid, ()), start, end)
            spans.append({"id": sid, "name": name, "thread": tid, "start_ns": start, "end_ns": end,
                          "parent": parent, "request": req, "self_ns": end - start - covered, **attrs})
        return {"spans": spans, "counters": counters, "anchor": {"perf_ns": self.perf_ns, "unix_ns": self.unix_ns}}


def _covered(intervals: Sequence[Tuple[int, int]], lo: int, hi: int) -> int:
    """Length of the union of ``intervals`` clipped to [lo, hi]."""
    total, reach = 0, lo
    for s, e in sorted(intervals):
        s, e = max(s, reach), min(e, hi)
        if e > s:
            total += e - s
            reach = e
    return total


# a CUDA runtime (cudaLaunchKernel, cudaMemcpyAsync, ...) or driver (cuLaunchKernel, ...) call
_LAUNCH_CALL = re.compile(r"cu(da)?[A-Z]")


def unix_ns(snap: Dict[str, Any], perf_ns: int) -> int:
    """A span time of ``snap`` on the Unix clock of ``torch.profiler``."""
    a = snap["anchor"]
    return perf_ns - a["perf_ns"] + a["unix_ns"]


def device_gaps(prof) -> List[Tuple[int, int, Optional[int]]]:
    """The (start, end) Unix-clock ns of every stretch of a finished
    ``torch.profiler.profile`` (CUDA activity) in which no kernel, copy or
    memset ran, between its first device operation and its last, with the
    native id of the thread whose CUDA runtime or driver call launched the
    operation that ends the stretch (None if the profile lacks that call).

    The profiler gives a calling thread's native id where it traced that
    thread's host operations, else the low 32 bits of its pthread id, which
    a live Python thread's ``ident`` turns back into its native id."""
    from torch.autograd import DeviceType

    native = {t.ident & 0xFFFFFFFF: t.native_id for t in threading.enumerate()}
    launcher: Dict[int, int] = {}
    ops = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            if not e.is_user_annotation():  # a host range drawn on the device's row, not work
                ops.append((e.start_ns(), e.end_ns(), e.correlation_id()))
        elif _LAUNCH_CALL.match(e.name()):
            tid = e.device_resource_id()
            launcher[e.correlation_id()] = native.get(tid & 0xFFFFFFFF, tid)
    ops.sort()
    gaps = []
    if ops:
        reach = ops[0][1]
        for s, e, corr in ops[1:]:
            if s > reach:
                gaps.append((reach, s, launcher.get(corr)))
            reach = max(reach, e)
    return gaps


def idle_by_span(gaps: Sequence[Tuple[int, int, Optional[int]]], snap: Dict[str, Any],
                 main: Optional[int] = None) -> Dict[str, float]:
    """Device-idle seconds by the innermost program span open across each
    gap's middle on the thread that launched the work ending the gap or,
    where that thread has none open, on the main thread (``main``, the
    process's main thread unless given): the autograd engine runs a CUDA
    backward on a thread of its own, with no spans, for the thread waiting
    in ``backward()``. "none" where neither has a span open there. ``gaps``
    from ``device_gaps``; spans on other threads (a loader's) are not
    considered."""
    if main is None:
        main = threading.main_thread().native_id
    spans: Dict[int, List[Tuple[int, int, str]]] = defaultdict(list)
    for s in snap["spans"]:
        spans[s["thread"]].append((unix_ns(snap, s["start_ns"]), unix_ns(snap, s["end_ns"]), s["name"]))
    for v in spans.values():
        v.sort()
    # per thread: the next span to open and a heap of (-start, end, name), the latest start on top
    cursor: Dict[int, int] = defaultdict(int)
    open_: Dict[int, List[Tuple[int, int, str]]] = defaultdict(list)

    def innermost(tid: Optional[int], mid: int) -> Optional[str]:
        mine, heap, i = spans.get(tid, ()), open_[tid], cursor[tid]
        while i < len(mine) and mine[i][0] <= mid:
            heapq.heappush(heap, (-mine[i][0], mine[i][1], mine[i][2]))
            i += 1
        cursor[tid] = i
        while heap and heap[0][1] < mid:
            heapq.heappop(heap)  # ended before this middle, so before every later one
        return heap[0][2] if heap else None

    out: Dict[str, float] = defaultdict(float)
    for g0, g1, tid in sorted(gaps, key=lambda g: g[0] + g[1]):
        mid = (g0 + g1) // 2
        name = innermost(tid, mid) or innermost(main, mid) or "none"
        out[name] += (g1 - g0) / 1e9
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def add_to_chrome_trace(path: str, snap: Dict[str, Any]) -> None:
    """Add the spans of ``snap`` to the Chrome trace a profiler exported to
    ``path``, on the profiler's timeline and its threads' rows (native
    thread ids), under the category "program", and the counters as one
    counter event at the last span's end."""
    with open(path) as f:
        trace = json.load(f)
    base = int(trace.get("baseTimeNanoseconds", 0))
    pid = next((e["pid"] for e in trace["traceEvents"] if e.get("cat") == "cpu_op"), 0)
    events = trace["traceEvents"]
    last = 0
    for s in snap["spans"]:
        start, end = unix_ns(snap, s["start_ns"]), unix_ns(snap, s["end_ns"])
        last = max(last, end)
        args = {k: v for k, v in s.items() if k not in ("name", "thread", "start_ns", "end_ns")}
        events.append({"ph": "X", "cat": "program", "name": s["name"], "pid": pid, "tid": s["thread"],
                       "ts": (start - base) / 1e3, "dur": (end - start) / 1e3, "args": args})
    if snap["counters"]:
        events.append({"ph": "C", "cat": "program", "name": "program counters", "pid": pid,
                       "ts": (last - base) / 1e3, "args": snap["counters"]})
    with open(path, "w") as f:
        json.dump(trace, f, default=str)
