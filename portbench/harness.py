"""One run of one cell: set-up, the timed window, the traced metrics, and
the comparison with the plain reference.

The loop is closed with one client: a call is issued, the host records a
CUDA event behind it and waits on that event, and only then issues the
next.  A call's latency is the card's time from an event recorded just
before the call (on an idle queue, so the card reaches it at once) to the
event behind it: the host's launch path, the card's work and every gap
between them, at the card's clock.  The window's rate takes every sample
of every call completed in it over the window's seconds on the host's
clock, from the first call's issue to the last call's completion.

Outputs are kept for the comparison by reservoir sampling, drawn from the
seed: ``keep_calls`` of the window's calls, each equally likely (or every
call, ``"all"``).  Set-up warms up with as many outputs alive as the
window holds, so no allocation reaches the driver inside the window.
"""

from __future__ import annotations

import contextlib
import gc
import statistics
import sys
import time
from array import array
from dataclasses import dataclass, field

import draws

FORBIDDEN = ('jax', 'jaxlib', 'flax', 'waveforms_tpu')
#: a compared number for an output of the wrong shape
MISMATCH = 1e30


@dataclass
class Window:
    """The window's calls, one entry a call in each array (plain arrays of
    doubles: nothing the garbage collector walks): ``issue`` and ``ret``
    (the call returned, before the wait) in host seconds (perf_counter);
    ``ms`` from issue to ready on the card's clock (the host's on the
    CPU).  ``t0`` is the first issue, ``t1`` the last call's wait's end."""
    issue: array = field(default_factory=lambda: array('d'))
    ret: array = field(default_factory=lambda: array('d'))
    ms: array = field(default_factory=lambda: array('d'))
    kept: list = field(default_factory=list)
    t0: float = 0.0
    t1: float = 0.0

    @property
    def calls(self) -> int:
        return len(self.ms)

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0


class Spans:
    """``span(name)``: a ``record_function`` range in traced runs, nothing
    otherwise."""

    def __init__(self, on: bool):
        self.on = on

    def __call__(self, name: str):
        if not self.on:
            return contextlib.nullcontext()
        from torch.profiler import record_function
        return record_function(name)


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX
    package's, compared whole."""
    return sorted(m for m in list(sys.modules)
                  if m.split('.')[0] in FORBIDDEN)


def run_window(call, seconds: float, seed: int, keep, span: Spans,
               cuda: bool) -> Window:
    """Issue calls for ``seconds`` seconds in a closed loop."""
    import torch

    pick = draws.rng(seed, 'reservoir')
    win = Window()
    if cuda:
        start = torch.cuda.Event(enable_timing=True)
        ready = torch.cuda.Event(enable_timing=True)
    win.t0 = time.perf_counter()
    deadline = win.t0 + seconds
    i = 0
    while True:
        t_issue = time.perf_counter()
        if i and t_issue >= deadline:
            break
        if cuda:
            start.record()
        with span('pb.call'):
            out = call.issue(i, span)
        t_ret = time.perf_counter()
        with span('pb.wait'):
            if cuda:
                ready.record()
                ready.synchronize()
        t_done = time.perf_counter()
        win.issue.append(t_issue)
        win.ret.append(t_ret)
        win.ms.append(start.elapsed_time(ready) if cuda
                      else (t_done - t_issue) * 1e3)
        item = call.keep(i, out)
        if keep == 'all' or len(win.kept) < keep:
            win.kept.append(item)
        else:
            j = int(pick.integers(0, i + 1))
            if j < keep:
                win.kept[j] = item
        del out, item
        i += 1
    win.t1 = t_done
    return win


def p95(values) -> float:
    """The 95th percentile (``statistics.quantiles``, exclusive method);
    a single value is its own."""
    values = list(values)
    return statistics.quantiles(values, n=20)[-1] if len(values) > 1 \
        else values[0]


def end_to_end(win: Window, call, setup_s: float) -> dict:
    """Every end-to-end metric the harness knows; a cell reports those
    that ``BENCHMARK.json`` gives it."""
    samples = call.samples_per_call * win.calls
    return {
        'gsps': (samples / win.seconds / 1e9, 'GS/s'),
        'call_p95_ms': (p95(win.ms), 'ms'),
        'setup_s': (setup_s, 's'),
    }


@dataclass
class Context:
    """What a per-layer metric's ``read(ctx)`` gets."""
    view: object
    window: Window
    call: object
    cfg: dict
    mix: dict


def run_cell(cell: str, cfg: dict, mix: dict, driver, limits: dict,
             seed: int, seconds: float, trace: bool, device: str,
             t_start: float, per_layer=(), end_to_end_names=None) -> dict:
    """One run -> the result line's fields (``checks`` last)."""
    import torch

    cuda = device != 'cpu'
    call = driver.Call(cfg, mix, seed, device)
    keep = mix.get('keep_calls', 1)
    call.warmup(1 if keep == 'all' else keep + 1)
    span = Spans(trace)
    traced: dict = {}
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    # set-up's objects out of the collector's reach: a collection inside
    # the window then walks only what the window made
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - t_start
    if trace:
        import tracing
        with tracing.profiled(traced):
            win = run_window(call, seconds, seed, keep, span, cuda)
    else:
        win = run_window(call, seconds, seed, keep, span, cuda)
    memory_peak = torch.cuda.max_memory_allocated() if cuda else 0
    result: dict = {'correct': False, 'attempted': win.calls,
                    'failed': 0, 'metrics': {}}
    if trace:
        view = traced['view']
        ctx = Context(view, win, call, cfg, mix)
        for m in per_layer:
            value = m['reader'].read(ctx)
            if value is not None:
                result['metrics'][m['name']] = {'value': value,
                                                'unit': m['unit']}
        import tracing
        result['breakdown'] = tracing.breakdown(view)
        busy_s, window_s = view.busy_s(), view.window_s
    else:
        for name, (value, unit) in end_to_end(win, call, setup_s).items():
            if end_to_end_names is None or name in end_to_end_names:
                result['metrics'][name] = {'value': value, 'unit': unit}
    call.free()
    gaps = call.check(win.kept)
    checks, failed = {}, 0
    for per_call in gaps:
        bad = False
        for name, value in per_call.items():
            limit = limits[name]['limit']
            worst = checks.setdefault(name, {'value': value,
                                             'limit': limit})
            worst['value'] = max(worst['value'], value)
            bad |= not value <= limit
        failed += bad
    result['failed'] = failed
    result['correct'] = bool(gaps) and failed == 0 and all(
        name in checks for name in limits)
    device_info = {'platform': 'gpu' if cuda else 'cpu',
                   'kind': torch.cuda.get_device_name() if cuda else 'cpu',
                   'count': 1, 'memory_peak_bytes': memory_peak}
    if trace:
        device_info.update(busy_s=busy_s, window_s=window_s)
    result['device'] = device_info
    result['checks'] = checks
    return result
