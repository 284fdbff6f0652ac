"""Profiling hooks on ``torch.profiler``: trace a synthesis call, read its
device time, and the program's own spans.

The port of ``waveforms_tpu.utils.profiling`` with its four names:
:func:`trace` writes a Chrome trace (TensorBoard's PyTorch profiler plugin
reads it) of everything inside it, :func:`annotate` names a region in it,
:func:`device_event_times` reads the card's kernel durations back out of
it, and :func:`measure_device` times one function's kernels on the card.
:func:`device_events` is the reader under all of them.

:func:`annotate` is also the program's span: the call paths open
``wf.*`` spans where their host work happens (``wf.play.prepare``,
``wf.launch.<kernel>``, ``wf.sequence.*``, ``wf.chain.*``).  A span costs
one flag check while no profiler records; under one it is a
``record_function`` range in the trace, on the clock of the card's
records, and an entry of the in-process :func:`span_record` on
``time.perf_counter``.  :func:`idle_by_span` cuts a trace's device-idle
time by the innermost span open on the host, :func:`spans_between` reads
a stretch of the record, and :func:`launched_under` finds the kernels
launched inside a host range.

Device time here is the card's own record of each kernel (CUPTI, through
Kineto), not a host clock: a process without a CUDA device has no such
record, and :func:`measure_device` raises there.
"""

from __future__ import annotations

import bisect
import contextlib
import fnmatch
import glob
import gzip
import heapq
import json
import math
import os
import re
import shutil
import socket
import statistics
import tempfile
import threading
import time
from array import array
from typing import NamedTuple

from torch.autograd import profiler as _autograd_profiler
from torch.profiler import record_function

__all__ = ['trace', 'annotate', 'span_record', 'spans_between',
           'device_events', 'device_event_times', 'launched_under',
           'idle_by_span', 'measure_device',
           'kernel_name', 'KERNELS', 'COPIES', 'ATTEMPTS', 'SPAN_CAPACITY']

# Kineto's categories of the events on a GPU's timeline
KERNELS = ('kernel',)
COPIES = ('gpu_memcpy', 'gpu_memset')
# A trace can miss kernels (``tools/trace_capture.py`` counts them): on an
# NVIDIA H100 80GB HBM3, in a process that had run a while on the card or
# after other processes had used it, the first records of a trace -- up to
# all of them -- often went unrecorded, and the card's timestamps stood up
# to ~1 ms off the host's.  A trace therefore opens with LEAD_KERNELS empty
# launches (``torch.cuda._sleep(0)``'s spin kernel, which the readers skip)
# and LEAD_S seconds on a drained queue, and stays on TAIL_S seconds past
# the drained queue at its end; measure_device traces again, up to
# ATTEMPTS times, where a trace holds none of the kernels it looks for.
LEAD_KERNELS = 20
LEAD_S = 0.05
TAIL_S = 0.01
ATTEMPTS = 3
LEAD_NAME = 'spin_kernel'
#: spans the in-process record holds; past it the oldest are overwritten
SPAN_CAPACITY = 2 ** 18
_QUALIFIERS = re.compile(r'(?:void )?(?:(?:\w+|\(anonymous namespace\))::)*')


@contextlib.contextmanager
def trace(log_dir: str):
    """Context manager: profile everything inside to *log_dir*.

    ``torch.profiler.profile`` with the CPU activity, and the CUDA activity
    where the process has a card; there it opens with :data:`LEAD_KERNELS`
    empty launches and :data:`LEAD_S` seconds, and on exit waits for the
    card's queue to drain and :data:`TAIL_S` more (a trace's first and last
    kernels can lose their records otherwise), and writes the Chrome trace JSON into
    *log_dir* under the name ``torch.profiler.tensorboard_trace_handler``
    gives it, ``<host>_<pid>.<ns>.pt.trace.json``.

    >>> with trace('wf-trace'):                      # doctest: +SKIP
    ...     out = synthesize(channels, 0, 1e-3, 2e9)
    """
    import torch
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        if cuda:
            for _ in range(LEAD_KERNELS):
                torch.cuda._sleep(0)
            torch.cuda.synchronize()
            time.sleep(LEAD_S)
        yield
        if cuda:
            torch.cuda.synchronize()
            time.sleep(TAIL_S)
    prof.export_chrome_trace(os.path.join(
        log_dir, f'{socket.gethostname()}_{os.getpid()}.{time.time_ns()}'
        '.pt.trace.json'))


class Spans(NamedTuple):
    """The spans of :func:`span_record`, oldest first, one entry a span in
    each tuple: ``names``, ``starts`` and ``ends`` (``time.perf_counter``
    seconds); ``dropped`` counts the oldest spans overwritten."""
    names: tuple
    starts: tuple
    ends: tuple
    dropped: int


class SpanRecord:
    """A ring of ``capacity`` spans in plain arrays (a name's index, start,
    end), nothing the garbage collector walks.  A slot is taken when its
    span opens, so the record keeps the spans in the order they opened;
    one still open has no end yet (NaN)."""

    def __init__(self, capacity: int = SPAN_CAPACITY):
        self.capacity = capacity
        self._ids = array('i', [0]) * capacity
        self._starts = array('d', [0.0]) * capacity
        self._ends = array('d', [float('nan')]) * capacity
        self._names: list[str] = []
        self._index: dict[str, int] = {}
        self._n = 0
        self._lock = threading.Lock()

    def open(self, name: str, t0: float) -> int:
        """Take the next slot for span ``name`` opened at ``t0`` -> its
        serial number."""
        with self._lock:
            i = self._index.get(name)
            if i is None:
                i = self._index[name] = len(self._names)
                self._names.append(name)
            n = self._n
            self._n = n + 1
            slot = n % self.capacity
            self._ids[slot] = i
            self._starts[slot] = t0
            self._ends[slot] = float('nan')
        return n

    def close(self, n: int, t1: float):
        """End span ``n`` at ``t1``, unless its slot was overwritten."""
        with self._lock:
            if self._n - n <= self.capacity:
                self._ends[n % self.capacity] = t1

    def view(self) -> Spans:
        """The closed spans, oldest first."""
        with self._lock:
            first = max(0, self._n - self.capacity)
            slots = [k % self.capacity for k in range(first, self._n)]
            slots = [k for k in slots if not math.isnan(self._ends[k])]
            return Spans(tuple(self._names[self._ids[k]] for k in slots),
                         tuple(self._starts[k] for k in slots),
                         tuple(self._ends[k] for k in slots), first)


_RECORD = SpanRecord()


class _Off:
    """The span while no profiler records: nothing."""
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, exc_type, exc, tb):
        return None


_OFF = _Off()


class _Span:
    """The span under a profiler: the host's clock read on either side of
    a ``record_function`` range, so the record's span holds the trace's
    range and the range's own cost."""
    __slots__ = ('name', '_range', '_record', '_n')

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self._record = _RECORD
        self._n = self._record.open(self.name, time.perf_counter())
        self._range = record_function(self.name)
        self._range.__enter__()
        return None

    def __exit__(self, exc_type, exc, tb):
        self._range.__exit__(exc_type, exc, tb)
        self._record.close(self._n, time.perf_counter())
        return None


def annotate(name: str):
    """Context manager: the span ``name``, a region visible in the profiler
    timeline (``torch.profiler.record_function``: a ``user_annotation``
    range on the host's timeline), and an entry of :func:`span_record`.

    On the card's timeline Kineto shows each kernel under the innermost
    range open at its launch, which for the program's kernels is their own
    ``wf.launch.*`` span: a region of your own around a call is not drawn
    over its kernels there.  :func:`launched_under` finds a region's
    kernels through their launches.

    Only while a profiler records (:func:`trace`, or any
    ``torch.profiler.profile``): otherwise ``annotate`` checks that one
    flag and does nothing else -- no range, no clock reading -- so the call
    paths keep their spans in place.  The program's spans are named
    ``wf.*``.
    """
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Span(name)


def span_record() -> Spans:
    """The spans :func:`annotate` recorded in this process under a
    profiler, oldest first (the last :data:`SPAN_CAPACITY`; ``dropped``
    counts those before them), on ``time.perf_counter``'s clock."""
    return _RECORD.view()


def spans_between(t0: float, t1: float, match, marks=()):
    """The durations (seconds) of the recorded spans whose names ``match``
    accepts and that open inside ``[t0, t1]``, and how many of ``marks``
    the record covers.

    ``marks`` are ``perf_counter`` readings in order, such as the start of
    each call in that stretch.  Where the record dropped its oldest spans,
    only the marks from the first at or after its oldest span count, and
    only the spans from that mark on: a mean a mark then holds whole
    marks.  -> (durations, covered marks); ([], 0) where none is covered.
    """
    rec = span_record()
    first = 0
    if rec.dropped and len(marks):
        first = bisect.bisect_left(marks, rec.starts[0]) \
            if rec.starts else len(marks)
        if first >= len(marks):
            return [], 0
        t0 = max(t0, marks[first])
    durs = [e - s for n, s, e in zip(rec.names, rec.starts, rec.ends)
            if t0 <= s <= t1 and match(n)]
    return durs, len(marks) - first


def _device_pids(events) -> set:
    """The pids of the GPU timelines: Kineto labels each GPU's process
    ``GPU <index>`` (``process_labels``), the host's ``CPU``."""
    return {e.get('pid') for e in events
            if e.get('ph') == 'M'
            and e.get('name') in ('process_name', 'process_labels')
            and str((e.get('args') or {}).get(
                'name', (e.get('args') or {}).get('labels', '')))
            .startswith('GPU')}


def device_events(log_dir: str, cats=KERNELS) -> list[dict]:
    """The complete events (``'ph': 'X'``) of a category in *cats* on a GPU
    timeline, from every trace :func:`trace` wrote under *log_dir*, in the
    order they started: Kineto's dicts, ``'name'``, ``'cat'``, ``'ts'`` and
    ``'dur'`` (microseconds) among their keys.  *cats* is :data:`KERNELS`
    by default; :data:`COPIES` adds the memory copies and fills.  Host
    spans -- operators, runtime calls, annotations -- are on the host's
    timeline and never among them, nor are the lead's launches (kernels
    named :data:`LEAD_NAME`, ``torch.cuda._sleep``'s)."""
    out: list[dict] = []
    for events in _traces(log_dir):
        out.extend(_device_ops(events, cats))
    return sorted(out, key=lambda e: e['ts'])


def _traces(log_dir: str):
    """Each trace's events under *log_dir*, one list a file."""
    for path in sorted(glob.glob(os.path.join(log_dir,
                                              '*.pt.trace.json*'))):
        opener = gzip.open if path.endswith('.gz') else open
        with opener(path, 'rt') as f:
            yield json.load(f).get('traceEvents', [])


def _device_ops(events, cats) -> list[dict]:
    """One trace's complete events of *cats* on a GPU timeline, without
    the lead's launches."""
    pids = _device_pids(events)
    return [e for e in events
            if e.get('ph') == 'X' and e.get('cat') in cats
            and e.get('pid') in pids and not kernel_name(
                e.get('name', '')).startswith(LEAD_NAME)]


def launched_under(log_dir: str, pattern: str, cats=KERNELS) -> list[dict]:
    """The device events of *cats* in the traces under *log_dir* whose
    launch lies inside a host range (a :func:`annotate` or
    ``record_function`` range) whose name matches *pattern*
    (``fnmatch``: ``'wf.*'`` for every span of the program), in order of
    start.

    A launch is the runtime or driver call that carries the event's
    correlation id; a graph's kernels share their replay's.  This is how
    a region's kernels are found now that each kernel of the program sits
    under its own ``wf.launch.*`` range on the card's timeline."""
    out: list[dict] = []
    for events in _traces(log_dir):
        ranges = [(float(e['ts']), float(e['ts']) + float(e.get('dur', 0)))
                  for e in events
                  if e.get('ph') == 'X' and e.get('cat') == 'user_annotation'
                  and fnmatch.fnmatchcase(str(e.get('name', '')), pattern)]
        if not ranges:
            continue
        launch = {e['args']['correlation']: float(e['ts']) for e in events
                  if e.get('ph') == 'X'
                  and e.get('cat') in ('cuda_runtime', 'cuda_driver')
                  and 'correlation' in (e.get('args') or {})}
        for e in _device_ops(events, cats):
            at = launch.get((e.get('args') or {}).get('correlation'))
            if at is not None and any(a <= at <= b for a, b in ranges):
                out.append(e)
    return sorted(out, key=lambda e: e['ts'])


class Idle(NamedTuple):
    """Device-idle time under one span: its ``seconds``, its ``longest``
    single piece (seconds) and its count of ``pieces``."""
    seconds: float
    longest: float
    pieces: int


def _innermost_segments(spans, lo, hi):
    """[lo, hi] cut at every span's ends -> [(a, b, name)], each piece
    labelled with the innermost span open over it (the latest opened, the
    shorter of two opened together), None where none is."""
    edges = sorted([(a, 1, i) for i, (a, _, _) in enumerate(spans)]
                   + [(b, 0, i) for i, (_, b, _) in enumerate(spans)])
    open_, closed, out, t = [], set(), [], lo
    for at, kind, i in edges:
        at = min(max(at, lo), hi)
        if at > t:
            while open_ and open_[0][2] in closed:
                heapq.heappop(open_)
            out.append((t, at, spans[open_[0][2]][2] if open_ else None))
            t = at
        if kind:
            heapq.heappush(open_, (-spans[i][0], spans[i][1], i))
        else:
            closed.add(i)
    if hi > t:
        out.append((t, hi, None))
    return out


def idle_by_span(log_dir: str, prefix: str = 'wf.') -> dict:
    """The card's idle time in the traces :func:`trace` wrote under
    *log_dir*, cut by the innermost host span whose name starts with
    *prefix* (a :func:`annotate` range, Kineto's ``user_annotation``) open
    over it -> {span name: :class:`Idle`}; None is the idle time under no
    such span.

    A trace's window runs from the first such span's start to the last
    one's end; the card is idle where no kernel, copy or fill of a GPU
    timeline runs (the lead's launches left out).  A piece is a stretch of
    idle time under one span: the time a kernel's launch waited on the
    host, put down to the host work that span names, on the trace's own
    clock."""
    out: dict = {}
    for events in _traces(log_dir):
        spans = [(float(e['ts']), float(e['ts']) + float(e.get('dur', 0)),
                  e['name']) for e in events
                 if e.get('ph') == 'X' and e.get('cat') == 'user_annotation'
                 and str(e.get('name', '')).startswith(prefix)]
        if not spans:
            continue
        lo = min(a for a, _, _ in spans)
        hi = max(b for _, b, _ in spans)
        busy: list[list[float]] = []
        for e in sorted(_device_ops(events, KERNELS + COPIES),
                        key=lambda e: e['ts']):
            a = float(e['ts'])
            b = a + float(e.get('dur', 0))
            if busy and a <= busy[-1][1]:
                busy[-1][1] = max(busy[-1][1], b)
            else:
                busy.append([a, b])
        edges = [lo] + [min(max(t, lo), hi) for ab in busy for t in ab] + [hi]
        idle = [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]
        pieces: list[list] = []         # [start, end, name]
        j = 0
        for a, b, name in _innermost_segments(spans, lo, hi):
            while j < len(idle) and idle[j][1] <= a:
                j += 1
            k = j
            while k < len(idle) and idle[k][0] < b:
                x, y = max(a, idle[k][0]), min(b, idle[k][1])
                if pieces and pieces[-1][2] == name and pieces[-1][1] == x:
                    pieces[-1][1] = y       # one piece across a cut
                else:
                    pieces.append([x, y, name])
                k += 1
        for x, y, name in pieces:
            had = out.get(name, Idle(0.0, 0.0, 0))
            out[name] = Idle(had.seconds + (y - x) / 1e6,
                             max(had.longest, (y - x) / 1e6), had.pieces + 1)
    return out


def kernel_name(name: str) -> str:
    """A kernel event's name as :func:`device_event_times` matches a prefix
    against it: the demangled C++ name that the trace gives without the
    return type and the namespaces in front of the function's name
    (``'void wfsynth::synth_dense_kernel<false, 4, false>(wfsynth::Desc,
    ...)'`` -> ``'synth_dense_kernel<false, 4, false>(wfsynth::Desc,
    ...)'``)."""
    return _QUALIFIERS.sub('', name, count=1)


def device_event_times(log_dir: str, name_prefix: str) -> list[float]:
    """Durations (seconds) of the card's kernels whose names start with
    *name_prefix*, from the Chrome traces a :func:`trace` capture wrote
    under *log_dir*.

    Only kernel events on a GPU timeline count (Kineto's ``"cat":
    "kernel"`` on a GPU's pid), as the JAX version keeps only a TPU's
    timeline: host-side launch and operator spans are excluded.  A name is
    matched by :func:`kernel_name`: the kernel's own name, template
    arguments and signature after it, so ``'synth_dense_kernel'`` selects
    the dense kernel K1 and not ``synth_dense_hi_kernel`` (K3), and
    ``'iir_'`` every kernel of S1.
    """
    return [e['dur'] / 1e6 for e in device_events(log_dir)
            if kernel_name(e.get('name', '')).startswith(name_prefix)]


def measure_device(fn, name_prefix: str, reps: int = 3,
                   log_dir: str | None = None) -> float:
    """Median device-side duration (seconds) of the kernels that ``fn()``
    launches whose names start with *name_prefix* (as
    :func:`device_event_times` matches them), over *reps* calls traced
    together.

    Each matching kernel is one sample: a call that launches it twice
    gives two.  A trace that loses a kernel's record (:func:`trace`'s lead
    and tail guard its edges) loses one sample, and the median of the
    others stands; a trace that holds no matching event is taken again, up
    to :data:`ATTEMPTS` traces of *reps* calls.  Warm ``fn`` up first where
    its first call builds the kernels.  The trace goes to *log_dir*,
    emptied before each attempt, or to a temporary directory removed
    afterwards.  Raises ``RuntimeError`` if no trace holds a matching
    device event -- always in a process without a CUDA device: there is
    no host clock to fall back to.
    """
    import torch

    own = log_dir is None
    where = tempfile.mkdtemp(prefix='wftpu_torch_measure_') if own else str(
        log_dir)
    times: list[float] = []
    try:
        for _ in range(ATTEMPTS if torch.cuda.is_available() else 1):
            shutil.rmtree(where, ignore_errors=True)
            with trace(where):
                for _ in range(reps):
                    fn()
            times = device_event_times(where, name_prefix)
            if times:
                break
    finally:
        if own:
            shutil.rmtree(where, ignore_errors=True)
    if not times:
        raise RuntimeError(
            f"no device events matching '{name_prefix}' in {where}")
    return statistics.median(times)
