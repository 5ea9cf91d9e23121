"""The device trace of a steady sub-window: `torch.profiler` over a few
seconds of the cell's own loop, reduced to what the per-layer readers and
the result line need (kernel time by name, busy and idle time, the longest
idle gaps by what the host was doing). Only a CUDA run is traced: on the
CPU there is no device, and no device metric is reported."""

from __future__ import annotations

import time
from dataclasses import dataclass, field

WINDOW = "geobench.window"


@dataclass
class Trace:
    window_s: float                  # the traced window's wall length
    busy_s: float                    # union of device operations in it
    device_s: dict                   # device seconds by operation name
    launches: dict                   # device operations by name
    idle_by_host: dict               # idle seconds by the host's operation
    calls: int                       # the loop's calls inside the window
    extra: dict = field(default_factory=dict)

    def kernel_s(self, *symbols):
        """Device seconds of operations whose name holds any of `symbols`."""
        return sum(s for n, s in self.device_s.items()
                   if any(sym in n for sym in symbols))

    def kernel_launches(self, *symbols):
        return sum(c for n, c in self.launches.items()
                   if any(sym in n for sym in symbols))

    def breakdown(self):
        top = sorted(self.device_s.items(), key=lambda kv: -kv[1])[:10]
        gaps = sorted(self.idle_by_host.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[n, s] for n, s in top],
                "idle_gaps": [[n, s] for n, s in gaps]}


def short_name(name, width=120):
    """A device operation's name without the C++ noise, at most `width`
    characters: the kernel's symbols stay in it."""
    name = name.replace("(anonymous namespace)::", "").replace("at::native::", "")
    if name.startswith("void "):
        name = name[5:]
    return name[:width]


def _union(intervals):
    """(total length, merged intervals) of a set of intervals."""
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return sum(b - a for a, b in merged), merged


def _innermost(host, points):
    """For each of the ascending `points`, the name of the shortest host
    operation (start, end, name) that covers it: a sweep with a heap of
    the operations begun, shortest first."""
    import heapq

    host = sorted(host)
    active, names, i = [], [], 0
    for t in points:
        while i < len(host) and host[i][0] <= t:
            a, b, name = host[i]
            heapq.heappush(active, (b - a, b, name))
            i += 1
        while active and active[0][1] < t:
            heapq.heappop(active)
        names.append(active[0][2] if active else "host outside any operation")
    return names


def reduce_events(events, calls, wall_s):
    """A `Trace` from a profiler's events (times in microseconds)."""
    from torch.autograd import DeviceType

    window = [e for e in events if e.name == WINDOW]
    if not window:
        raise RuntimeError("the traced window's annotation is missing")
    w0, w1 = window[0].time_range.start, window[0].time_range.end
    device, host = [], []
    device_s, launches = {}, {}
    outside = 0
    for e in events:
        a, b = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA:
            # the window's own annotation is mirrored on the device's time
            # line: it is no operation
            if e.name == WINDOW:
                continue
            if b <= w0 or a >= w1:
                outside += 1
                continue
            device.append((max(a, w0), min(b, w1)))
            name = short_name(e.name)
            device_s[name] = device_s.get(name, 0.0) + (b - a) * 1e-6
            launches[name] = launches.get(name, 0) + 1
        elif e.name != WINDOW:
            host.append((a, b, e.name))
    busy_us, merged = _union(device)
    idle = {}
    gaps, t = [], w0
    for a, b in merged:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if w1 > t:
        gaps.append((t, w1))
    for (a, b), name in zip(gaps, _innermost(host, [(a + b) / 2
                                                   for a, b in gaps])):
        idle[name] = idle.get(name, 0.0) + (b - a) * 1e-6
    return Trace(window_s=wall_s, busy_s=busy_us * 1e-6, device_s=device_s,
                 launches=launches, idle_by_host=idle, calls=calls,
                 extra={"device_ops_outside_window": outside})


def trace_loop(step, seconds, sync):
    """Runs `step()` under the profiler until `seconds` have passed (at
    least two calls), `sync()` before the window closes; returns the
    `Trace`. The device's operations are recorded whichever thread of the
    process launched them; the host's, only this thread's."""
    from torch.profiler import ProfilerActivity, profile, record_function

    calls = 0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) \
            as prof:
        with record_function(WINDOW):
            sync()
            t0 = time.perf_counter()
            while calls < 2 or time.perf_counter() - t0 < seconds:
                step()
                calls += 1
            sync()
            wall = time.perf_counter() - t0
    return reduce_events(prof.events(), calls, wall)
