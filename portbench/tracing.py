"""The traced run: torch.profiler over the window, and the Kineto trace read
back into device operations attributed to the benchmark's host spans.

A copy of the port's ``utils/profiling.py`` reader, kept here so that the
yardstick does not move with the program: the GPU timelines are the pids
Kineto labels ``GPU <index>``; a device operation is a complete event of
category ``kernel``, ``gpu_memcpy`` or ``gpu_memset`` there.  On an H100 a
trace can lose its first records, so a trace opens with
:data:`LEAD_KERNELS` empty launches (``torch.cuda._sleep(0)``, whose
``spin_kernel`` the reader skips) and :data:`LEAD_S` seconds on a drained
queue, and stays on :data:`TAIL_S` seconds after the last call.

Each device operation is attributed to the benchmark span (a
``record_function`` range named ``pb.*``) that was open on the host when
the operation was launched: the launch is the runtime or driver call with
the operation's ``correlation`` id.  The trace file is written under the
run's ``TMPDIR`` and removed once read.
"""

from __future__ import annotations

import bisect
import contextlib
import json
import os
import re
import shutil
import tempfile
import time
from dataclasses import dataclass, field

LEAD_KERNELS = 20
LEAD_S = 0.05
TAIL_S = 0.01
LEAD_NAME = 'spin_kernel'
DEVICE_CATS = ('kernel', 'gpu_memcpy', 'gpu_memset')
LAUNCH_CATS = ('cuda_runtime', 'cuda_driver')
SPAN_PREFIX = 'pb.'
_QUALIFIERS = re.compile(r'(?:void )?(?:(?:\w+|\(anonymous namespace\))::)*')


def short_name(name: str) -> str:
    """A device operation's name without return type, namespaces, template
    arguments and signature."""
    name = _QUALIFIERS.sub('', name, count=1)
    return re.split(r'[<(]', name, maxsplit=1)[0].strip() or name


@dataclass
class Span:
    name: str
    ts: float           # microseconds, the trace's clock
    end: float
    call: int | None    # index of the enclosing pb.call span


@dataclass
class Op:
    name: str
    ts: float
    dur: float
    span: Span | None


@dataclass
class TraceView:
    """What the metric readers take from a trace: the device operations
    with their spans, the spans, and the window (first call's start to the
    last wait's end), all in microseconds."""
    ops: list[Op]
    spans: list[Span]
    window: tuple[float, float]
    _starts: list = field(default_factory=list, repr=False)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6

    def busy(self) -> list[tuple[float, float]]:
        """The union of the device operations' intervals inside the
        window."""
        lo, hi = self.window
        out: list[list[float]] = []
        for op in sorted(self.ops, key=lambda o: o.ts):
            a, b = max(op.ts, lo), min(op.ts + op.dur, hi)
            if b <= a:
                continue
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return [(a, b) for a, b in out]

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy()) / 1e6

    def call_ops(self, span_name: str | None = None) -> list[Op]:
        """Operations launched inside a call span, or inside its sub-span
        ``span_name``."""
        return [op for op in self.ops if op.span is not None
                and op.span.call is not None
                and (span_name is None or op.span.name == span_name)]

    def span_at(self, ts: float) -> Span | None:
        if len(self._starts) != len(self.spans):
            self._starts = [s.ts for s in self.spans]
        return _innermost(self.spans, self._starts, ts)


def _innermost(spans, starts, ts, look_back=16):
    i = bisect.bisect_right(starts, ts) - 1
    best = None
    for s in spans[max(0, i - look_back):i + 1][::-1]:
        if s.ts <= ts <= s.end and (best is None
                                    or s.end - s.ts < best.end - best.ts):
            best = s
    return best


@contextlib.contextmanager
def profiled(result: dict):
    """Profile the block; on exit read the trace into ``result['view']``
    (a :class:`TraceView`)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    where = tempfile.mkdtemp(prefix='portbench_trace_')
    path = os.path.join(where, 'trace.json')
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(LEAD_KERNELS):
                torch.cuda._sleep(0)
            torch.cuda.synchronize()
            time.sleep(LEAD_S)
            yield
            torch.cuda.synchronize()
            time.sleep(TAIL_S)
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get('traceEvents', [])
        result['view'] = read_events(events)
    finally:
        shutil.rmtree(where, ignore_errors=True)


def _device_pids(events) -> set:
    return {e.get('pid') for e in events
            if e.get('ph') == 'M'
            and e.get('name') in ('process_name', 'process_labels')
            and str((e.get('args') or {}).get(
                'name', (e.get('args') or {}).get('labels', '')))
            .startswith('GPU')}


def read_events(events: list[dict]) -> TraceView:
    """A Kineto trace's events -> :class:`TraceView`."""
    pids = _device_pids(events)
    launch, spans, raw_ops = {}, [], []
    for e in events:
        if e.get('ph') != 'X':
            continue
        cat, args = e.get('cat'), e.get('args') or {}
        if cat in DEVICE_CATS and e.get('pid') in pids:
            if not short_name(e.get('name', '')).startswith(LEAD_NAME):
                raw_ops.append(e)
        elif cat in LAUNCH_CATS and 'correlation' in args:
            launch[args['correlation']] = float(e['ts'])
        elif (cat == 'user_annotation'
              and e.get('name', '').startswith(SPAN_PREFIX)):
            ts = float(e['ts'])
            spans.append(Span(e['name'], ts, ts + float(e.get('dur', 0)),
                              None))
    spans.sort(key=lambda s: s.ts)
    calls = [s for s in spans if s.name == 'pb.call']
    for i, s in enumerate(calls):
        s.call = i
    starts = [s.ts for s in spans]
    call_starts = [s.ts for s in calls]
    for s in spans:
        if s.call is None and s.name != 'pb.wait':
            host = _innermost(calls, call_starts, s.ts)
            s.call = host.call if host is not None else None
    ops = []
    for e in raw_ops:
        at = launch.get((e.get('args') or {}).get('correlation'))
        span = _innermost(spans, starts, at) if at is not None else None
        ops.append(Op(short_name(e.get('name', '')), float(e['ts']),
                      float(e.get('dur', 0)), span))
    waits = [s for s in spans if s.name == 'pb.wait']
    lo = calls[0].ts if calls else 0.0
    hi = waits[-1].end if waits else (calls[-1].end if calls else 0.0)
    return TraceView(ops, spans, (lo, hi))


def host_segments(view: TraceView) -> list[tuple[float, float, str]]:
    """The window cut by what the host was doing: each piece labelled with
    the innermost benchmark span open over it, or ``between calls``."""
    lo, hi = view.window
    cuts = sorted({lo, hi, *(t for s in view.spans for t in (s.ts, s.end)
                             if lo < t < hi)})
    out = []
    for a, b in zip(cuts, cuts[1:]):
        span = view.span_at((a + b) / 2)
        out.append((a, b, span.name if span else 'between calls'))
    return out


def breakdown(view: TraceView, top: int = 10) -> dict:
    """The device operations that took most time, by the span open at
    their launch and their name, and the device's idle time split by what
    the host was doing over it -> the result line's ``breakdown``."""
    by_op: dict[str, float] = {}
    for op in view.ops:
        key = f"{op.span.name if op.span else 'no span'}/{op.name}"
        by_op[key] = by_op.get(key, 0.0) + op.dur / 1e6
    lo, hi = view.window
    edges = [lo] + [x for ab in view.busy() for x in ab] + [hi]
    idle = [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]
    gaps: dict[str, list] = {}
    j = 0
    for a, b, name in host_segments(view):
        while j < len(idle) and idle[j][1] <= a:
            j += 1
        k = j
        while k < len(idle) and idle[k][0] < b:
            piece = (min(b, idle[k][1]) - max(a, idle[k][0])) / 1e6
            g = gaps.setdefault(name, [0, 0.0, 0.0])
            g[0] += 1
            g[1] += piece
            g[2] = max(g[2], piece)
            k += 1
    ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:top]
    idle_out = sorted(((f"{k} ({n} pieces, longest {m * 1e6:.1f} us)", s)
                       for k, (n, s, m) in gaps.items()),
                      key=lambda kv: -kv[1])[:top]
    return {'device_ops': [[k, v] for k, v in ops],
            'idle_gaps': [[k, v] for k, v in idle_out]}
