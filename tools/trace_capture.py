#!/usr/bin/env python3
"""How many of its kernels a torch.profiler trace records on this card,
with ``waveforms_tpu_torch.utils.profiling.trace``'s lead and without it.

    python3 tools/trace_capture.py [--traces N] [--record PATH]

Each trace holds three elementwise kernels on a 1M-float tensor; N traces
a state and variant (default 20).  The states are the process fresh,
after chip_smoke.py's ``iir_routes`` phase (~20 s of CUDA-event timing on
the card), and after ``multiproc_smoke``'s two worker processes have used
the card (small size), then 5 s later; the variants are ``trace`` as it
is (LEAD_KERNELS empty launches and LEAD_S seconds before the body) and
with the lead off.  Prints one JSON line per state and variant -- the
count of traces by the number of kernels they recorded -- then the
card's nvidia-smi line; exits 1 if a trace with the lead lost a kernel.
"""

import argparse
import collections
import json
import os
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)


def captured(prof, ops, n):
    """{kernels recorded: traces} over n traces of ``ops``."""
    out = collections.Counter()
    for _ in range(n):
        with tempfile.TemporaryDirectory() as log_dir:
            with prof.trace(log_dir):
                for op in ops:
                    op()
            out[len(prof.device_events(log_dir))] += 1
    return dict(out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--traces', type=int, default=20)
    ap.add_argument('--record', help="write the records to this JSON file")
    args = ap.parse_args(argv)
    import torch

    import chip_smoke
    from waveforms_tpu_torch import kernels
    from waveforms_tpu_torch.parallel import multiproc_smoke
    from waveforms_tpu_torch.probes import nvidia_smi
    from waveforms_tpu_torch.utils import profiling as prof
    if not torch.cuda.is_available():
        print("trace_capture: no CUDA device visible", file=sys.stderr)
        return 2
    kernels.load_library()
    x = torch.ones(1 << 20, device='cuda')
    ops = [lambda: x * 2, lambda: x.sqrt(), lambda: x.exp()]
    lead = (prof.LEAD_KERNELS, prof.LEAD_S)
    records, ok = [], True

    def state(name):
        nonlocal ok
        for variant in ('lead', 'no_lead'):
            prof.LEAD_KERNELS, prof.LEAD_S = lead if variant == 'lead' else (
                0, 0.0)
            rec = {'state': name, 'variant': variant, 'kernels': len(ops),
                   'traces_by_kernels_recorded': captured(prof, ops,
                                                          args.traces)}
            prof.LEAD_KERNELS, prof.LEAD_S = lead
            if variant == 'lead':
                ok &= set(rec['traces_by_kernels_recorded']) == {len(ops)}
            records.append(rec)
            print(json.dumps(rec), flush=True)
    state('fresh')
    fail = []
    chip_smoke.iir_routes(fail)
    state('after iir_routes')
    multiproc_smoke.run('gloo', device='cuda', size='small', timeout=300.0)
    state('after multiproc_smoke')
    time.sleep(5.0)
    state('after multiproc_smoke + 5 s')
    smi = nvidia_smi()
    print(smi, flush=True)
    if args.record:
        os.makedirs(os.path.dirname(os.path.abspath(args.record)),
                    exist_ok=True)
        with open(args.record, 'w') as f:
            json.dump({'device': smi, 'records': records}, f, indent=1)
    return 0 if ok else 1


if __name__ == '__main__':
    sys.exit(main())
