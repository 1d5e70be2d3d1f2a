"""The device trace of a traced run's window, and what is read from it.

`torch.profiler` (CUPTI) records the window; its Chrome trace goes to a
file under the temporary directory, is read back and deleted.  From it:

  * busy_s: the union of the device's kernel, copy and fill intervals
    inside the window (the `bench.window` range), window_s its length;
  * device_ops: device seconds by operation name, the ten largest;
  * idle_gaps: the window's idle device time, each gap named by the
    innermost profiler range the host was in at the gap's middle (the
    benchmark's `bench.*` spans and the program's own `fused.*`), summed
    by that name, the ten largest.
"""

from __future__ import annotations

import json
import os
import tempfile
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW = "bench.window"
NAME_CHARS = 96


class DeviceTrace:
    def __init__(self):
        from torch.profiler import ProfilerActivity, profile
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])

    def start(self):
        self.prof.start()

    def stop(self) -> dict:
        import warnings

        import torch
        torch.cuda.synchronize()
        with warnings.catch_warnings():      # its note on events across cycles
            warnings.simplefilter("ignore", UserWarning)
            self.prof.stop()
        fd, path = tempfile.mkstemp(prefix="bench_trace_", suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as fh:
                events = json.load(fh)["traceEvents"]
        finally:
            os.unlink(path)
        self.prof = None
        return summarize(events)


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def _short(name: str) -> str:
    return name if len(name) <= NAME_CHARS else name[:NAME_CHARS - 3] + "..."


def summarize(events) -> dict:
    """Chrome-trace events (microseconds) -> busy_s, window_s, device_ops,
    idle_gaps.  Raises where the trace has no window range or no device
    activity inside it."""
    window = [e for e in events if e.get("ph") == "X" and e.get("name") == WINDOW
              and e.get("cat") == "user_annotation"]
    if not window:
        raise RuntimeError("the device trace has no bench.window range")
    w0 = float(window[0]["ts"])
    w1 = w0 + float(window[0]["dur"])
    dev, by_name = [], defaultdict(float)
    host = []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat")
        s = float(e["ts"])
        t = s + float(e.get("dur", 0.0))
        if cat in DEVICE_CATS:
            s, t = max(s, w0), min(t, w1)
            if t > s:
                dev.append((s, t))
                by_name[_short(e["name"])] += (t - s) * 1e-6
        elif cat == "user_annotation" and e["name"] != WINDOW:
            host.append((s, t, e["name"]))
    busy = _merge(dev)
    busy_us = sum(t - s for s, t in busy)
    if busy_us <= 0:
        raise RuntimeError("the device trace shows no device activity in the window")
    gaps, prev = [], w0
    for s, t in busy:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, t)
    if w1 > prev:
        gaps.append((prev, w1))
    idle = defaultdict(float)
    for (g0, g1), label in zip(gaps, _labels([(g0 + g1) / 2 for g0, g1 in gaps], host)):
        idle[label] += (g1 - g0) * 1e-6
    return {
        "busy_s": busy_us * 1e-6,
        "window_s": (w1 - w0) * 1e-6,
        "device_ops": sorted(([k, v] for k, v in by_name.items()),
                             key=lambda kv: -kv[1])[:10],
        "idle_gaps": sorted(([k, v] for k, v in idle.items()),
                            key=lambda kv: -kv[1])[:10],
    }


def _labels(points, host):
    """For each time (ascending), the innermost host range holding it, or
    "host, outside any span"."""
    host = sorted(host, key=lambda h: (h[0], -h[1]))
    out, stack, i = [], [], 0
    for x in points:
        while i < len(host) and host[i][0] <= x:
            stack.append(host[i])
            i += 1
        inner = None
        for h in reversed(stack):
            if h[0] <= x < h[1]:
                inner = h
                break
        stack = [h for h in stack if h[1] > x]
        out.append(inner[2] if inner else "host, outside any span")
    return out
