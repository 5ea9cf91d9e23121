"""Spans and counters at the port's layer boundaries.

Tracing is on exactly while a torch profiler records (`torch.profiler.
profile`, `train_base --profile_dir`): there is no flag. Off, `span(name)`
returns one shared no-op context after reading one module bool
(`torch.autograd.profiler._is_profiler_enabled`), and that is its whole cost.
On, a span

1. opens a FUNCTION-scope record-function range, so it sits in the running
   profiler's trace on the profiler's clock, on the timeline of the kernels
   and copies it launched (unlike a `record_function` range, a USER_SCOPE
   one, it is not mirrored onto the device's timeline as an annotation);
2. keeps a record in a bounded in-memory list (`CAPACITY` records, the rest
   counted as dropped): its name, host start and end (`perf_counter_ns`),
   its parent span and a request id (a root span's own, else its parent's:
   the `predict_batch` call number or the train step);
3. with `device=True` in a process that uses CUDA, records a CUDA event
   pair on the current stream, resolved to seconds only by `summary()`.

`count(name, n)` adds to a counter while a profiler records, so that a
ratio of a counter to a span's time covers the same calls. `summary()`
reduces the record per span name. The profiler's own chrome trace is the
export.

The names, by layer: engine (`engine.predict_batch`, `engine.upload`,
`engine.wait`, `engine.calibrate`, counter `engine.upload_bytes`), models
(`models.forward`, `models.stem`, `models.fstar`), the train step
(`train.step`, `train.forward`, `train.backward`, `train.all_reduce`,
`train.optimizer`, `train.batch_wait`) and the server (`serve.batch`). A
name ending in `.wait` marks the host waiting for the card, and nothing
else: the host's own work in a span is its time less that of the `.wait`
spans inside it.
"""

from __future__ import annotations

import threading
import time

import torch
import torch.autograd.profiler as _profiler

CAPACITY = 2 ** 16
_RecordFunctionFast = torch._C._profiler._RecordFunctionFast

# a record: [name, start ns, end ns (0 while open), parent record or None,
#            request id, device seconds or (start event, end event, stream)
#            or None]
_NAME, _T0, _T1, _PARENT, _REQUEST, _DEVICE = range(6)


class _Record:
    """The process's spans and counters (one, `_state`, as the profiler is
    one per process)."""

    def __init__(self):
        self.records = []
        self.dropped = 0
        self.counters = {}


_state = _Record()
_local = threading.local()   # each thread's stack of open spans


class _Off:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("_name", "_device", "_request", "_range", "_rec", "_stack")

    def __init__(self, name, device, request):
        self._name, self._device, self._request = name, device, request

    def __enter__(self):
        self._range = _RecordFunctionFast(self._name)
        self._range.__enter__()
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        parent, request = stack[-1] if stack else (None, None)
        if self._request is not None:
            request = self._request
        rec = None
        if len(_state.records) < CAPACITY:
            events = None
            if self._device and torch.cuda.is_initialized():
                # both events on the stream the span began on, read once
                # (under a profiler a read costs about as much as a record)
                stream = torch.cuda.current_stream()
                events = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True), stream)
                events[0].record(stream)
            rec = [self._name, time.perf_counter_ns(), 0, parent, request,
                   events]
            _state.records.append(rec)
        else:
            _state.dropped += 1
        self._rec, self._stack = rec, stack
        stack.append((rec, request))
        return self

    def __exit__(self, *exc):
        rec = self._rec
        if rec is not None:
            if rec[_DEVICE] is not None:
                _, end, stream = rec[_DEVICE]
                end.record(stream)
            rec[_T1] = time.perf_counter_ns()
        self._stack.pop()
        self._range.__exit__(None, None, None)
        return False


def span(name, device=False, request=None):
    """A context manager marking one stretch of the port's work as `name`
    while a torch profiler records, and nothing otherwise. `device=True`
    also times the work it launches on the current CUDA stream; `request`
    gives a root span its id (its children inherit it)."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _Span(name, device, request)


def count(name, n=1):
    """Adds `n` to the counter `name` while a torch profiler records."""
    if _profiler._is_profiler_enabled:
        _state.counters[name] = _state.counters.get(name, 0) + n


def _device_s(rec):
    """The record's device seconds (its events resolved once, waiting for
    the end event), or None for a host-only span."""
    dev = rec[_DEVICE]
    if isinstance(dev, tuple):
        dev[1].synchronize()
        dev = rec[_DEVICE] = dev[0].elapsed_time(dev[1]) * 1e-3
    return dev


def records():
    """The closed spans in the order they were opened: [(name, start ns,
    end ns, parent index or -1, request id)]."""
    recs = [r for r in list(_state.records) if r[_T1]]
    index = {id(r): i for i, r in enumerate(recs)}
    return [(r[_NAME], r[_T0], r[_T1],
             -1 if r[_PARENT] is None else index.get(id(r[_PARENT]), -1),
             r[_REQUEST]) for r in recs]


def summary():
    """{"spans": {name: {"calls", "host_s", "self_host_s", "device_s"}},
    "counters": {name: total}, "dropped": spans not kept}. `self_host_s`
    is the spans' host time less that of their child spans; `device_s` is
    None for a span that records no device time."""
    recs = [r for r in list(_state.records) if r[_T1]]
    children = {}
    for r in recs:
        if r[_PARENT] is not None:
            key = id(r[_PARENT])
            children[key] = children.get(key, 0) + r[_T1] - r[_T0]
    spans = {}
    for r in recs:
        s = spans.setdefault(r[_NAME], {"calls": 0, "host_s": 0.0,
                                        "self_host_s": 0.0,
                                        "device_s": None})
        ns = r[_T1] - r[_T0]
        s["calls"] += 1
        s["host_s"] += ns * 1e-9
        s["self_host_s"] += (ns - children.get(id(r), 0)) * 1e-9
        dev = _device_s(r)
        if dev is not None:
            s["device_s"] = (s["device_s"] or 0.0) + dev
    return {"spans": spans, "counters": dict(_state.counters),
            "dropped": _state.dropped}


def reset():
    """Forgets every record and counter (a span open meanwhile closes into
    the forgotten record)."""
    global _state
    _state = _Record()
