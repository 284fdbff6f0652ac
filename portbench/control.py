"""The readings that a cell's correctness limits are set from: the
program's compared numbers and the lower-precision control's, seed by
seed, at the cell's own size and load, all seeds in one process.

    python3 portbench/control.py --workload chip64.sweep \\
        --seeds 11 12 13 --seconds 3

For each seed: the cell's set-up, a short closed-loop window of the
program with its outputs kept as a run keeps them, and their compared
numbers; then the control in the program's place -- each call driver's
``control`` (the program's own lower-precision path, or the reference
computed one precision lower) -- compared the same way.  One JSON line a
seed, then a summary line with the largest program reading and the
smallest control reading of each number.  The benchmark's own runs never
run the control.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

import harness  # noqa: E402
import spec  # noqa: E402


def readings(cfg, mix, driver, seed, seconds, device):
    """(program's, control's) worst compared numbers for one seed."""
    call = driver.Call(cfg, mix, seed, device)
    keep = mix.get('keep_calls', 1)
    out = []
    for control in (False, True):
        call.control = control
        call.warmup(1 if keep == 'all' else keep + 1)
        win = harness.run_window(call, seconds, seed, keep,
                                 harness.Spans(False), device != 'cpu')
        worst: dict = {}
        for per_call in call.check(win.kept):
            for name, value in per_call.items():
                worst[name] = max(worst.get(name, value), value)
        out.append(worst)
        del win
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('--workload', required=True)
    p.add_argument('--seeds', type=int, nargs='+', required=True)
    p.add_argument('--seconds', type=float, default=3.0)
    p.add_argument('--device', default='cuda')
    args = p.parse_args(argv)
    bench = spec.benchmark()
    wl = spec.workload(bench, args.workload)
    cfg, mix = spec.config(bench, wl['config']), spec.traffic(wl['traffic'])
    driver = spec.call_driver(mix)
    program, control = {}, {}
    for seed in args.seeds:
        prog, ctrl = readings(cfg, mix, driver, seed,
                              args.seconds, args.device)
        print(json.dumps({'seed': seed, 'program': prog, 'control': ctrl}),
              flush=True)
        for name, v in prog.items():
            program[name] = max(program.get(name, v), v)
        for name, v in ctrl.items():
            control[name] = min(control.get(name, v), v)
    print(json.dumps({'workload': wl['name'], 'seeds': args.seeds,
                      'program_max': program, 'control_min': control}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
