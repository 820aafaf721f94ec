"""The traced window: ``torch.profiler`` around a driver's steady
sub-window, reduced to what the per-layer metrics read.

``capture(fn)`` runs ``fn`` under the profiler inside a ``recbench.window``
span, exports the Chrome trace to the run's temporary directory, reads it
back and deletes it.  ``reduce(events)`` takes the window from that span and
returns the device's busy seconds (the union of kernel, copy and fill
intervals, so work on two streams at once counts once), every kernel's name
and seconds, and the breakdown the result line carries: the device
operations that took most time, and the longest idle gaps by what the main
thread was doing (its innermost ``recbench.*`` span and host operation).
"""

from __future__ import annotations

import heapq
import json
import os
import tempfile
from collections import defaultdict
from typing import Any, Callable, Dict, List

WINDOW = "recbench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")


def capture(fn: Callable[[], Any]) -> Dict[str, Any]:
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW):
            fn()
    fd, path = tempfile.mkstemp(prefix="recbench-trace-", suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    return reduce(events)


def _union(intervals: List[tuple]) -> List[tuple]:
    out: List[list] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [tuple(x) for x in out]


def reduce(events: List[Dict[str, Any]]) -> Dict[str, Any]:
    spans = [e for e in events if e.get("cat") == "user_annotation" and e.get("name") == WINDOW]
    if not spans:
        raise ValueError("the trace has no recbench.window span")
    win = spans[0]
    t0, t1 = float(win["ts"]), float(win["ts"]) + float(win["dur"])
    device, kernels, by_name = [], [], defaultdict(float)
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
            continue
        a, b = max(float(e["ts"]), t0), min(float(e["ts"]) + float(e["dur"]), t1)
        if b <= a:
            continue
        device.append((a, b))
        by_name[e["name"][:120]] += (b - a) * 1e-6
        if e["cat"] == "kernel":
            kernels.append((e["name"], (b - a) * 1e-6))
    busy = _union(device)
    gaps, last = [], t0
    for a, b in busy:
        if a > last:
            gaps.append((last, a))
        last = b
    if t1 > last:
        gaps.append((last, t1))
    host = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"], e["cat"])
                  for e in events
                  if e.get("ph") == "X" and e.get("cat") in HOST_CATS
                  and e.get("tid") == win.get("tid") and e is not win)
    idle = defaultdict(float)
    active: List[tuple] = []  # heap of (end, start, name, cat)
    i = 0
    for a, b in sorted(gaps, key=lambda g: (g[0] + g[1]) / 2):
        mid = (a + b) / 2
        while i < len(host) and host[i][0] <= mid:
            s, e, name, cat = host[i]
            heapq.heappush(active, (e, s, name, cat))
            i += 1
        while active and active[0][0] < mid:
            heapq.heappop(active)
        span = max((x for x in active if x[3] == "user_annotation"), key=lambda x: x[1],
                   default=None)
        op = max((x for x in active if x[3] != "user_annotation"), key=lambda x: x[1],
                 default=None)
        label = (span[2] if span else "no span") + " / " + (op[2] if op else "python")
        idle[label] += (b - a) * 1e-6
    top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]
    return {
        "window_s": (t1 - t0) * 1e-6,
        "busy_s": sum(b - a for a, b in busy) * 1e-6,
        "kernels": kernels,
        "breakdown": {"device_ops": top(by_name), "idle_gaps": top(idle)},
    }


def seconds_of(reduced: Dict[str, Any], match: Callable[[str], bool]) -> float:
    return sum(s for name, s in reduced["kernels"] if match(name))


def count_of(reduced: Dict[str, Any], match: Callable[[str], bool]) -> int:
    return sum(1 for name, _ in reduced["kernels"] if match(name))
