"""The traced run: ``torch.profiler`` over the window, CUDA activity
only, read from its raw event list.

What is read: every device operation (kernels, memory copies and sets)
with its start and end. The host's operations are not recorded: that
costs the reduction about a third more host time an observation on an
H100's host. The benchmark's own spans around the window and around
each call into the entry are taken on the host's wall clock
(``time.time_ns``), the clock the profiler's events are stamped in, and
name the device's idle gaps. Shapes and stacks are not recorded.
"""

from __future__ import annotations

import bisect
import contextlib
import time
from collections import defaultdict
from dataclasses import dataclass, field

def union_length(intervals) -> float:
    """Length of the union of ``(start, end)`` intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        elif e > cur_e:
            cur_e = e
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def idle_gaps(intervals, start: float, end: float):
    """The ``(start, end)`` stretches of ``[start, end]`` that no
    interval covers, in order."""
    gaps, t = [], start
    for s, e in sorted(intervals):
        if s > t:
            gaps.append((t, min(s, end)))
        t = max(t, e)
        if t >= end:
            break
    if t < end:
        gaps.append((t, end))
    return [(s, e) for s, e in gaps if e > s]


def _top_level(spans):
    """The outermost of ``(start, end, name)`` spans, sorted and
    disjoint."""
    out, cur_end = [], None
    for s, e, n in sorted(spans, key=lambda x: (x[0], -x[1])):
        if cur_end is None or s >= cur_end:
            out.append((s, e, n))
            cur_end = e
    return out


def _find(spans, starts, t):
    i = bisect.bisect_right(starts, t) - 1
    if i >= 0 and spans[i][0] <= t < spans[i][1]:
        return spans[i][2]
    return None


@dataclass
class Analysis:
    """The window's device activity, in seconds."""

    window_s: float
    busy_s: float
    #: device operations in the window: name -> [count, seconds]
    device_ops: dict = field(default_factory=dict)
    #: idle time by the span around it: label -> [count, seconds]
    idle_by_span: dict = field(default_factory=dict)
    #: seconds from the window's opening to the first device operation,
    #: and from the last one's end to its closing (the clocks' agreement)
    lead_s: float = 0.0
    tail_s: float = 0.0

    @property
    def idle_share(self) -> float:
        return 1.0 - self.busy_s / self.window_s

    def kernel_seconds(self, names) -> tuple[int, float]:
        """``(count, seconds)`` of the device operations whose name holds
        any of ``names``."""
        n, s = 0, 0.0
        for op, (c, t) in self.device_ops.items():
            if any(k in op for k in names):
                n += c
                s += t
        return n, s

    def n_device_ops(self) -> int:
        return sum(c for c, _ in self.device_ops.values())

    def breakdown(self, top: int = 10) -> dict:
        ops = sorted(self.device_ops.items(), key=lambda kv: -kv[1][1])
        gaps = sorted(self.idle_by_span.items(), key=lambda kv: -kv[1][1])
        return {"device_ops": [[k[:160], v[1]] for k, v in ops[:top]],
                "idle_gaps": [[f"{k[:150]} (x{v[0]})", v[1]]
                              for k, v in gaps[:top]]}


def analyse(device, spans) -> Analysis:
    """Read the device operations ``(name, start_ns, end_ns)`` against
    the benchmark's spans ``(name, start_ns, end_ns)``, one of them
    ``window``: busy time is the union of the operations inside the
    window, the idle gaps the rest, each named by the span of a unit of
    work around its middle (``between units`` outside every one)."""
    win = [s for s in spans if s[0] == "window"]
    if not win:
        raise RuntimeError("no window span")
    _, w0, w1 = win[0]
    dev = [(max(s, w0), min(e, w1), n) for n, s, e in device
           if e > w0 and s < w1]
    if not dev:
        raise RuntimeError("no device operation inside the window")
    ops = defaultdict(lambda: [0, 0.0])
    for s, e, n in dev:
        ops[n][0] += 1
        ops[n][1] += (e - s) * 1e-9
    iv = [(s, e) for s, e, _ in dev]
    units = _top_level([(s, e, n) for n, s, e in spans if n != "window"])
    u_starts = [s for s, _, _ in units]
    idle = defaultdict(lambda: [0, 0.0])
    for s, e in idle_gaps(iv, w0, w1):
        label = _find(units, u_starts, (s + e) / 2) or "between units"
        idle[label][0] += 1
        idle[label][1] += (e - s) * 1e-9
    lead = (min((s for s, _, _ in dev), default=w1) - w0) * 1e-9
    tail = (w1 - max((e for _, e, _ in dev), default=w0)) * 1e-9
    return Analysis((w1 - w0) * 1e-9, union_length(iv) * 1e-9, dict(ops),
                    dict(idle), lead, tail)


class Tracer:
    """``torch.profiler`` (CUDA activity) over the window, and the
    benchmark's spans on the same clock."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile
        self._prof = profile(activities=[ProfilerActivity.CUDA],
                             record_shapes=False, with_stack=False)
        self.spans: list = []

    def __enter__(self):
        self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        self._prof.__exit__(*exc)

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.time_ns()
        try:
            yield
        finally:
            self.spans.append((name, t0, time.time_ns()))

    def analysis(self) -> Analysis:
        from torch.autograd import DeviceType
        device = []
        for e in self._prof.profiler.kineto_results.events():
            if e.device_type() == DeviceType.CPU or e.is_user_annotation():
                continue
            s = e.start_ns()
            device.append((e.name(), s, s + e.duration_ns()))
        return analyse(device, self.spans)
