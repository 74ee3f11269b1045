"""Reading the device timeline of a traced window.

``torch.profiler`` (CPU and CUDA activity) records the window; its Chrome
trace is written to a temporary file, read back here and deleted. What is
kept: every device interval (kernels, copies, sets) clipped to the window,
with the host thread and time of its launch (joined by the trace's
correlation ids); the host's operators and the benchmark's own spans
(``lfmbench.*``, ``record_function``), for naming idle gaps and for
attributing a kernel to the operator that launched it. Times are seconds
from the window's start.
"""

from __future__ import annotations

import bisect
import json
import os
import re
import tempfile
from dataclasses import dataclass, field

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
WINDOW_SPAN = "lfmbench.window"


@dataclass
class Timeline:
    window_s: float
    device: list = field(default_factory=list)  # (start, end, name, cat)
    host: list = field(default_factory=list)  # (start, end, name, tid)
    launch: list = field(default_factory=list)  # per device item: (tid, time) or None

    def kernel_seconds(self, pattern: str, exclude: str | None = None) -> float:
        """Device seconds of the kernels whose name matches ``pattern``
        (a regular expression, searched) and not ``exclude``."""
        inc = re.compile(pattern)
        exc = re.compile(exclude) if exclude else None
        return sum(e - s for s, e, name, cat in self.device
                   if cat == "kernel" and inc.search(name) and not (exc and exc.search(name)))

    def launched_under(self, op_pattern: str, exclude: str | None = None) -> float:
        """Device seconds of the kernels launched inside a host operator
        whose name matches ``op_pattern`` (on the launching thread), less
        those whose own name matches ``exclude``."""
        ops = re.compile(op_pattern)
        exc = re.compile(exclude) if exclude else None
        spans: dict = {}
        for s, e, name, tid in self.host:
            if ops.search(name):
                spans.setdefault(tid, []).append((s, e))
        merged = {tid: _merge(v) for tid, v in spans.items()}
        starts = {tid: [a for a, _ in v] for tid, v in merged.items()}
        total = 0.0
        for (s, e, name, cat), at in zip(self.device, self.launch):
            if cat != "kernel" or at is None or at[0] not in merged or (exc and exc.search(name)):
                continue
            i = bisect.bisect_right(starts[at[0]], at[1]) - 1
            if i >= 0 and at[1] <= merged[at[0]][i][1]:
                total += e - s
        return total

    def kernel_count(self) -> int:
        return sum(1 for *_, cat in self.device if cat == "kernel")

    def busy_s(self) -> float:
        return union_seconds([(s, e) for s, e, *_ in self.device])


def _merge(intervals):
    """The union of ``(start, end)`` intervals as sorted disjoint intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def union_seconds(intervals) -> float:
    """Length of the union of ``(start, end)`` intervals."""
    return sum(e - s for s, e in _merge(intervals))


def idle_gaps(intervals, start: float, end: float):
    """The ``(start, end)`` stretches of [start, end] that no interval covers."""
    gaps, cursor = [], start
    for s, e in sorted(intervals):
        if s > cursor:
            gaps.append((cursor, min(s, end)))
        cursor = max(cursor, e)
        if cursor >= end:
            break
    if cursor < end:
        gaps.append((cursor, end))
    return [g for g in gaps if g[1] > g[0]]


def from_events(events) -> Timeline:
    """A :class:`Timeline` from Chrome-trace events (``ts``/``dur`` in us)."""
    spans = [e for e in events if e.get("name") == WINDOW_SPAN and e.get("ph") == "X"
             and e.get("cat") == "user_annotation"]
    if not spans:
        raise ValueError(f"the trace holds no {WINDOW_SPAN!r} span")
    w0 = float(spans[0]["ts"])
    w1 = w0 + float(spans[0]["dur"])
    tl = Timeline(window_s=(w1 - w0) * 1e-6)
    launches, pending = {}, []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat")
        s = float(e["ts"])
        en = s + float(e.get("dur", 0.0))
        if cat in ("cuda_runtime", "cuda_driver"):
            corr = (e.get("args") or {}).get("correlation")
            if corr is not None:
                launches[corr] = (e.get("tid"), (s - w0) * 1e-6)
        s, en = max(s, w0), min(en, w1)
        if en <= s:
            continue
        item = ((s - w0) * 1e-6, (en - w0) * 1e-6, str(e.get("name", "")))
        if cat in DEVICE_CATS:
            tl.device.append(item + (cat,))
            pending.append((e.get("args") or {}).get("correlation"))
        elif cat in HOST_CATS and item[2] != WINDOW_SPAN:
            tl.host.append(item + (e.get("tid"),))
    tl.launch = [launches.get(c) for c in pending]
    return tl


def from_profiler(prof, directory: str | None = None) -> Timeline:
    """Export ``prof``'s Chrome trace to a temporary file, read it, delete it."""
    fd, path = tempfile.mkstemp(suffix=".json", dir=directory)
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    return from_events(events)


def short_name(name: str, width: int = 96) -> str:
    """A kernel's name without ``void `` and its argument list, cut to ``width``."""
    name = re.sub(r"^void ", "", name).replace("(anonymous namespace)::", "")
    depth, out = 0, []
    for ch in name:
        if ch == "(" and depth == 0 and out:
            break
        depth += ch == "<"
        depth -= ch == ">"
        out.append(ch)
    return "".join(out)[:width]


def breakdown(tl: Timeline, top: int = 10):
    """The device operations that took most time, and the longest idle
    gaps named by what the host was doing at their middle: the innermost
    host operator there, inside the benchmark's innermost span."""
    by_name: dict = {}
    for s, e, name, cat in tl.device:
        key = short_name(name)
        by_name[key] = by_name.get(key, 0.0) + (e - s)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    gaps = sorted(idle_gaps([(s, e) for s, e, *_ in tl.device], 0.0, tl.window_s),
                  key=lambda g: g[0] - g[1])[:top]
    named = []
    for g0, g1 in gaps:
        mid = 0.5 * (g0 + g1)
        around = [(e - s, name) for s, e, name, _ in tl.host if s <= mid <= e]
        spans = sorted(a for a in around if a[1].startswith("lfmbench."))
        ops_at = sorted(a for a in around if not a[1].startswith("lfmbench."))
        label = " / ".join(x[0][1] for x in (spans, ops_at) if x) or "python"
        named.append([label, g1 - g0])
    return {"device_ops": [[k, v] for k, v in ops], "idle_gaps": named}
