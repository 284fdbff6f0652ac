"""Run one cell of the benchmark of ``waveforms_tpu_torch`` once.

    python3 portbench/run.py --workload chip64.sweep --seed 7 \\
        --seconds 20 --trace 0

From the root of a checkout.  Builds the cell's table from ``--seed``,
warms up, runs the closed-loop window for ``--seconds``, checks what the
window produced against the plain reference, and prints one JSON line as
the last line of standard output: with ``--trace 0`` the cell's end-to-end
metrics, with ``--trace 1`` its per-layer metrics read from a
``torch.profiler`` trace of the window.  The numbers compared with the
reference are printed beside their limits as the last lines of standard
error and under ``checks``, the line's last key.  Exits non-zero with no
result where the card or the cell's count of cards is missing, or where a
module of JAX or of the JAX package is loaded once the window has closed.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]
os.environ.setdefault('USE_FLAX', '0')
# one host thread a pool: the cells' host work is serial, and idle pools'
# threads only take cores from the loop on a shared host
for _var in ('OMP_NUM_THREADS', 'MKL_NUM_THREADS', 'OPENBLAS_NUM_THREADS'):
    os.environ.setdefault(_var, '1')

import harness  # noqa: E402
import spec  # noqa: E402


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('--workload', required=True)
    p.add_argument('--seed', type=int, required=True)
    p.add_argument('--seconds', type=float, required=True)
    p.add_argument('--trace', type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    bench = spec.benchmark()
    wl = spec.workload(bench, args.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < wl['chips']:
        print(f"{args.workload} needs {wl['chips']} CUDA device(s); torch "
              f"sees {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    cfg, mix = spec.config(bench, wl['config']), spec.traffic(wl['traffic'])
    per_layer = [dict(m, reader=spec.metric_reader(m['name']))
                 for m in spec.metrics_of(bench, wl['name'], 'per_layer')]
    e2e = [m['name'] for m in spec.metrics_of(bench, wl['name'],
                                              'end_to_end')]
    result = harness.run_cell(
        wl['name'], cfg, mix, spec.call_driver(mix), spec.limits(wl['name']),
        args.seed, args.seconds, bool(args.trace), 'cuda', T_START,
        per_layer=per_layer, end_to_end_names=e2e)
    found = harness.forbidden_modules()
    if found:
        print(f"modules of JAX or the JAX package loaded: {found}",
              file=sys.stderr)
        return 3
    for name, c in result['checks'].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    if 'call_p95_ms' in result['metrics']:
        print(f"call_p95_ms over {result['attempted']} calls")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
