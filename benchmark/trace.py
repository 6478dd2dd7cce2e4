"""Reading a ``torch.profiler`` trace of a few steady cycles or rollouts:
the device's busy time (the union of its operations' intervals), the
traced window, kernels by name, idle gaps by what the host was doing, and
the kernels inside each ``bench.<span>`` range.

The profiler's raw events are read directly (their parsed form takes some
70 us an event to build, minutes for a training cycle's million).
"""

from __future__ import annotations

import bisect
from collections import defaultdict

from torch.profiler import ProfilerActivity, profile, record_function

WINDOW = "bench.window"
LOOKBACK = 4000   # host events searched back for one covering a gap


def record(fn, calls: int, spans):
    """Run ``fn`` ``calls`` times under the profiler, with the spans'
    profiler ranges on; returns the raw events."""
    spans.labels = True
    try:
        spans.sync()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            with record_function(WINDOW):
                for _ in range(calls):
                    fn()
                spans.sync()
    finally:
        spans.labels = False
    return prof.profiler.kineto_results.events()


def _union(intervals):
    """Merged (start, end) intervals, sorted."""
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def summarize(raw, top: int = 10) -> dict:
    """``busy_s``, ``window_s``, ``kernels`` (count), ``device_ops``
    (the heaviest kernels by name, seconds), ``idle_gaps`` (the longest
    gaps, each named by the span and the innermost host operation running
    through it), and per span its ``kernels`` count and ``nccl_s``."""
    device, host, spans = [], [], []
    w0 = w1 = None
    for e in raw:
        name, start = e.name(), e.start_ns()
        end = start + e.duration_ns()
        if e.device_type().name == "CUDA":
            if not e.is_user_annotation() and not name.startswith("bench."):
                device.append((start, end, name))
        elif name == WINDOW:
            w0, w1 = start, end
        elif name.startswith("bench."):
            spans.append((start, end, name[6:]))
        elif not name.startswith("Activity "):
            host.append((start, end, name))
    device = sorted(d for d in device if w0 <= d[0] <= w1)
    kernels = [d for d in device
               if not d[2].startswith(("Memcpy", "Memset"))]
    merged = _union([(s, min(e, w1)) for s, e, _ in device])
    busy = sum(e - s for s, e in merged)
    by_name = defaultdict(int)
    for s, e, name in kernels:
        by_name[name] += e - s
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    edges = [w0] + [x for iv in merged for x in iv] + [w1]
    gaps = sorted(((edges[i + 1] - edges[i], edges[i])
                   for i in range(0, len(edges), 2)
                   if edges[i + 1] > edges[i]), reverse=True)[:top]
    host.sort()
    host_starts = [h[0] for h in host]

    def doing(t):
        span = next((n for s, e, n in spans if s <= t < e), "between")
        i = bisect.bisect_right(host_starts, t)
        covering = [h for h in host[max(0, i - LOOKBACK):i] if h[1] > t]
        op = (min(covering, key=lambda h: h[1] - h[0])[2] if covering
              else "host")
        return f"{span}:{op}"

    starts = [k[0] for k in kernels]
    per_span = {}
    for s, e, name in spans:
        inside = kernels[bisect.bisect_left(starts, s):
                         bisect.bisect_left(starts, e)]
        d = per_span.setdefault(name, {"kernels": 0, "nccl_s": 0.0})
        d["kernels"] += len(inside)
        d["nccl_s"] += sum(ke - ks for ks, ke, kn in inside
                           if "nccl" in kn.lower()) / 1e9
    return {
        "busy_s": busy / 1e9,
        "window_s": (w1 - w0) / 1e9,
        "kernels": len(kernels),
        "device_ops": [[n, ns / 1e9] for n, ns in ops],
        "idle_gaps": [[doing(t + g // 2), g / 1e9] for g, t in gaps],
        "spans": per_span,
    }
