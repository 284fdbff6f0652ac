"""Count fresh processes whose first CPU transcendental comes out wrong.

    python -m waveforms_tpu_torch.cpu_first_call [--processes N]
        [--parallel P] [--modes cold,warm,plain,plain_cold]

Each child process runs one mode:

- ``cold``: ``torch.sin``, ``torch.exp`` and ``torch.log`` once on 23,700
  float32 elements (the size of the DRAG factor evaluation of
  ``tests/test_torch_stack.py``'s overlap_drag case), each against numpy in
  float64;
- ``warm``: the same after ``ops.reference.warm_cpu_math()``, as the plain
  versions call it before their first CPU evaluation;
- ``plain``: the stack route's plain version on overlap_drag (40
  overlapping DRAGs over 1.1 us at 2 GS/s), its first evaluation in the
  process against its second;
- ``plain_cold``: ``plain`` with the warm-up skipped.

Prints one JSON line: per mode, the processes run, those with a result off
by more than 1e-6 of its peak, the worst relative error and the most
elements off in one process.
"""

import argparse
import json
import os
import subprocess
import sys

import torch

CHILD = r"""
import json, sys
import numpy as np
import torch
from waveforms_tpu_torch.ops import reference
mode = sys.argv[1]
if mode == 'warm':
    reference.warm_cpu_math()
if mode == 'plain_cold':          # the warm-up counts as done: skipped
    reference._cpu_math_warm_threads = torch.get_num_threads()
pairs = []
if mode in ('cold', 'warm'):
    x = torch.from_numpy(np.linspace(0.05, 3.1, 23700).astype(np.float32))
    for fn, ref in ((torch.sin, np.sin), (torch.exp, np.exp),
                    (torch.log, np.log)):
        pairs.append((fn(x).numpy(), ref(x.numpy().astype(np.float64))))
else:
    import waveforms_tpu_torch as wt
    from waveforms_tpu_torch.ops.lowering import lower_schedule
    from waveforms_tpu_torch.ops.stack_synth import (build_stack_plan,
                                                     synthesize_stack)
    rng = np.random.default_rng(7)
    overlap = wt.zero()
    for _ in range(40):
        overlap += wt.drag(100e6, 300e-9, plateau=200e-9, delta=2e6,
                           block_freq=None, phase=rng.uniform(0, 6),
                           t0=0.0) >> rng.uniform(0, 0.6e-6)
    low = lower_schedule([overlap], 0.0, 1.1e-6, 2e9)
    plan = build_stack_plan(low)
    first = synthesize_stack(low, plan, device='cpu')
    second = synthesize_stack(low, plan, device='cpu')
    pairs.append((first.numpy(), second.numpy().astype(np.float64)))
worst, n_off = 0.0, 0
for got, want in pairs:
    err = np.abs(got - want) / max(np.abs(want).max(), 1e-30)
    worst = max(worst, float(err.max()))
    n_off = max(n_off, int((err > 1e-6).sum()))
print(json.dumps({'err': worst, 'n_off': n_off}))
"""

MODES = ('cold', 'warm', 'plain', 'plain_cold')


def run_children(modes, parallel=8) -> dict:
    """Run one fresh child process per entry of ``modes``, ``parallel`` at
    a time; return the per-mode counts."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    stats = {m: {'processes': 0, 'off': 0, 'worst_err': 0.0, 'most_off': 0}
             for m in dict.fromkeys(modes)}
    for i in range(0, len(modes), parallel):
        batch = modes[i:i + parallel]
        procs = [subprocess.Popen([sys.executable, '-c', CHILD, m], cwd=repo,
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True)
                 for m in batch]
        for m, p in zip(batch, procs):
            out, err = p.communicate(timeout=300)
            if p.returncode != 0:
                raise RuntimeError(f"child ({m}) exited {p.returncode}: "
                                   f"{err[-2000:]}")
            r = json.loads(out.strip().splitlines()[-1])
            s = stats[m]
            s['processes'] += 1
            s['off'] += r['err'] > 1e-6
            s['worst_err'] = max(s['worst_err'], r['err'])
            s['most_off'] = max(s['most_off'], r['n_off'])
    return stats


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--processes', type=int, default=200,
                    help='child processes per mode')
    ap.add_argument('--parallel', type=int, default=8)
    ap.add_argument('--modes', default='cold,warm',
                    help=f"comma-separated, of {', '.join(MODES)}")
    args = ap.parse_args()
    modes = args.modes.split(',')
    if not set(modes) <= set(MODES):
        ap.error(f"--modes: choose from {', '.join(MODES)}")
    print(json.dumps({'torch': torch.__version__,
                      'threads': torch.get_num_threads()}), flush=True)
    print(json.dumps(run_children(modes * args.processes, args.parallel)))


if __name__ == '__main__':
    main()
