"""Where a benchmark cell's host time and the card's idle time go, by the
program's ``wf.*`` spans, and what a span and a launch cost.

    python3 tools/span_split.py --workload station_rb.chain --seconds 10 \\
        --seed 7 --record span_split.jsonl
    python3 tools/span_split.py --cost --workload chip64.sweep \\
        --record span_cost.jsonl

From the root of a checkout, on a machine with an NVIDIA GPU.

With ``--workload`` alone: one traced run of the cell through the
benchmark's own ``portbench/harness.run_cell`` (what ``portbench/run.py
--trace 1`` runs), then one JSON line: the cell's per-layer metrics as
that run reads them; ``covered``, the share of the calls' host time (issue
to return) inside an outermost ``wf.*`` span; for each span name its host
milliseconds a call, its count a call, its 95th percentile and its
longest (from ``utils.profiling.span_record()``); and the card's idle time
cut by the innermost ``wf.*`` span open over it
(``utils.profiling.idle_by_span`` on the run's own trace: seconds, the
longest piece and the count of pieces; the key ``null`` is idle time under
no span).

With ``--cost``: the host's nanoseconds a span costs with no profiler
recording (``annotate`` over an empty body against the empty loop, median
of 5 runs of 10**6 spans) and its microseconds under ``utils.profiling.
trace`` (10**4 spans).  With ``--workload`` too: the host microseconds of
the cell's kernel launches (each kernel wrapper's ctypes call, timed
around it) over ``--calls`` calls with no profiler, the same under
``utils.profiling.trace``, and the traced ``wf.launch.*`` spans over the
same calls -- how much of a traced launch span is the profiler.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path[:0] = [os.path.join(ROOT, 'portbench'), ROOT]
for _var in ('OMP_NUM_THREADS', 'MKL_NUM_THREADS', 'OPENBLAS_NUM_THREADS'):
    os.environ.setdefault(_var, '1')


def _loop(n, body):
    t0 = time.perf_counter()
    for _ in range(n):
        body()
    return time.perf_counter() - t0


def _cell(workload: str):
    import spec
    bench = spec.benchmark()
    wl = spec.workload(bench, workload)
    return (bench, wl, spec.config(bench, wl['config']),
            spec.traffic(wl['traffic']))


def _split(ctx) -> dict:
    """The window's calls split by the recorded spans."""
    from waveforms_tpu_torch.utils import profiling
    win = ctx.window
    rec = profiling.span_record()
    spans = [(n, s, e) for n, s, e in zip(rec.names, rec.starts, rec.ends)
             if win.t0 <= s <= win.t1 and n.startswith('wf.')]
    by_name: dict = {}
    for n, s, e in spans:
        by_name.setdefault(n, []).append(e - s)
    outer, end = 0.0, float('-inf')          # outermost spans' union
    for _, s, e in sorted(spans, key=lambda x: x[1]):
        outer += max(0.0, e - max(s, end))
        end = max(end, e)
    host = sum(r - i for r, i in zip(win.ret, win.issue))
    calls = win.calls

    def p95(d):
        return statistics.quantiles(d, n=20, method='inclusive')[-1] \
            if len(d) > 1 else d[0]
    return {
        'calls': calls, 'dropped': rec.dropped,
        'api_host_ms': host * 1e3 / calls,
        'covered': outer / host if host else None,
        'spans': {n: {'ms_a_call': sum(d) * 1e3 / calls,
                      'a_call': len(d) / calls, 'p95_ms': p95(d) * 1e3,
                      'longest_ms': max(d) * 1e3}
                  for n, d in sorted(by_name.items(),
                                     key=lambda kv: -sum(kv[1]))}}


def split(workload: str, seconds: float, seed: int) -> dict:
    """One traced run of the cell through the harness, split by span."""
    import torch

    import harness
    import spec
    import tracing
    from waveforms_tpu_torch.utils import profiling

    bench, wl, cfg, mix = _cell(workload)
    kept: dict = {}
    read_events = tracing.read_events

    def keeping(events):                # the run's trace, for idle_by_span
        kept['events'] = events
        return read_events(events)
    tracing.read_events = keeping
    split_of: dict = {}

    class Split:
        @staticmethod
        def read(ctx):
            split_of.update(_split(ctx))
    per_layer = [dict(m, reader=spec.metric_reader(m['name']))
                 for m in spec.metrics_of(bench, wl['name'], 'per_layer')]
    try:
        result = harness.run_cell(
            wl['name'], cfg, mix, spec.call_driver(mix),
            spec.limits(wl['name']), seed, seconds, True, 'cuda',
            time.perf_counter(),
            per_layer=per_layer + [{'name': 'split', 'unit': '',
                                    'reader': Split}])
    finally:
        tracing.read_events = read_events
    with tempfile.TemporaryDirectory(prefix='wf_span_split_') as where:
        with open(os.path.join(where, 'run.pt.trace.json'), 'w') as f:
            json.dump({'traceEvents': kept.get('events', [])}, f)
        idle = profiling.idle_by_span(where)
    return {
        'workload': workload, 'seed': seed, 'correct': result['correct'],
        'metrics': {k: v['value'] for k, v in result['metrics'].items()},
        **split_of,
        'busy_s': result['device']['busy_s'],
        'window_s': result['device']['window_s'],
        'idle_by_span': {str(n): i._asdict() for n, i in sorted(
            idle.items(), key=lambda kv: -kv[1].seconds)},
        'device': torch.cuda.get_device_name(),
    }


def launch_cost(workload: str, calls: int, seed: int) -> dict:
    """The cell's launches' host microseconds, untraced and traced."""
    import torch

    import harness
    import spec
    from waveforms_tpu_torch import kernels
    from waveforms_tpu_torch.utils import profiling

    _, _, cfg, mix = _cell(workload)
    call = spec.call_driver(mix).Call(cfg, mix, seed, 'cuda')
    call.warmup(2)
    torch.cuda.synchronize()
    took: list[float] = []

    def timed(launch):
        def run(*args):
            t0 = time.perf_counter()
            launch(*args)
            took.append(time.perf_counter() - t0)
        return run
    wrapped = []
    for k in vars(kernels).values():
        for attr in ('_launch', '_launch_shots'):
            if isinstance(k, kernels._Kernel) and hasattr(k, attr):
                wrapped.append((k, attr, getattr(k, attr)))
                setattr(k, attr, timed(getattr(k, attr)))
    off = harness.Spans(False)

    def loop():
        for i in range(calls):
            call.issue(i, off)
            torch.cuda.synchronize()
    try:
        loop()
        untraced, took[:] = list(took), []
        with tempfile.TemporaryDirectory(prefix='wf_launch_') as where:
            with profiling.trace(where):
                t0 = time.perf_counter()
                loop()
        traced = list(took)
    finally:
        for k, attr, launch in wrapped:
            setattr(k, attr, launch)
        call.free()
    spans, _ = profiling.spans_between(
        t0, time.perf_counter(), lambda n: n.startswith('wf.launch.'))

    def us(d):
        return {'mean_us': statistics.fmean(d) * 1e6,
                'median_us': statistics.median(d) * 1e6, 'n': len(d)}
    return {'workload': workload,
            'launch_untraced': us(untraced) if untraced else None,
            'launch_traced': us(traced) if traced else None,
            'span_traced': us(spans) if spans else None}


def cost(workload: str | None, calls: int, seed: int) -> dict:
    """A span's host cost off (ns) and on under a trace (us)."""
    import torch

    from waveforms_tpu_torch.utils import profiling

    def span():
        with profiling.annotate('wf.cost'):
            pass

    def empty():
        pass

    n = 10 ** 6
    off = [(_loop(n, span) - _loop(n, empty)) / n * 1e9 for _ in range(5)]
    with tempfile.TemporaryDirectory(prefix='wf_span_cost_') as where:
        with profiling.trace(where):
            m = 10 ** 4
            on = (_loop(m, span) - _loop(m, empty)) / m * 1e6
    out = {'off_ns': statistics.median(off), 'off_ns_runs': off,
           'on_us': on, 'torch': torch.__version__,
           'device': torch.cuda.get_device_name()}
    if workload:
        out['launch'] = launch_cost(workload, calls, seed)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('--workload')
    p.add_argument('--seconds', type=float, default=10.0)
    p.add_argument('--seed', type=int, default=7)
    p.add_argument('--cost', action='store_true')
    p.add_argument('--calls', type=int, default=200)
    p.add_argument('--record')
    args = p.parse_args(argv)
    if not args.cost and not args.workload:
        p.error('give --workload or --cost')
    out = cost(args.workload, args.calls, args.seed) if args.cost else \
        split(args.workload, args.seconds, args.seed)
    line = json.dumps(out)
    print(line, flush=True)
    if args.record:
        os.makedirs(os.path.dirname(args.record) or '.', exist_ok=True)
        with open(args.record, 'a') as f:
            f.write(line + '\n')
    return 0


if __name__ == '__main__':
    sys.exit(main())
