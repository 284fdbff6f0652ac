#!/usr/bin/env python3
"""Accuracy of the IIR kernel S1's blocked scan, by chunk, on the CPU: the
plain model of its arithmetic (``reference_iir.df2t_blocked``), which the
kernel equals bit for bit (tests/test_torch_cuda.py, chip_smoke.py).

    python3 tools/iir_chunk_accuracy.py [--chunks 512 1024 2048 4096]
                                        [--seed 5] [--ratios]

Prints one JSON line per chunk for the clustered filter over the
pulse-train row of 2^20 samples (``ops/iir_cases.py``; float64, zero
state; ``--seed`` draws the pulses, 5 tests/test_torch_iir_blocked.py's):
the
model's distance to scipy's lfilter in
np.longdouble (80-bit on x86) and to scipy's float64 lfilter, of the
row's peak, scipy's own distance to the long double, the largest entry of
the carry's matrix Phi = A^chunk, and the model's seconds.  With
``--ratios``, one line per S1 case of the card tests at the build's
chunk: the model's distance to the long-double answer over the
sequential recurrence's (``reference_iir.df2t``), over each row's outputs
and final state -- the largest row by row, and that of the rows' largest
distances (chip_smoke.rows_err), which the tests bound by 2.
"""

import argparse
import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))


def _long_double(b, a, x, zi=None):
    import numpy as np
    import scipy.signal as sps
    ld = np.longdouble
    if zi is None:
        return sps.lfilter(b.astype(ld), a.astype(ld), x.astype(ld))
    y, zf = sps.lfilter(b.astype(ld), a.astype(ld), x.astype(ld),
                        zi=zi.astype(ld))
    return np.concatenate([y, zf])


def by_chunk(chunks, seed):
    import numpy as np
    import scipy.signal as sps
    import torch

    from waveforms_tpu_torch.ops import iir_cases, reference_iir
    coef = iir_cases.coefficients(*iir_cases.filters()['clustered'])
    b, a = coef[:4].numpy(), coef[4:].numpy()
    x = iir_cases.pulse_train(1 << 20, seed)
    truth = _long_double(b, a, x)
    ref = sps.lfilter(b, a, x)
    peak = float(np.abs(truth).max())
    print(json.dumps({'scipy_vs_long_double':
                      float(np.abs(ref - truth).max()) / peak}), flush=True)
    for L in chunks:
        t0 = time.perf_counter()
        y = torch.empty(1, len(x), dtype=torch.float64)
        reference_iir.df2t_blocked(torch.tensor(x)[None], coef,
                                   torch.zeros(1, 3, dtype=torch.float64), y,
                                   torch.empty(1, 3, dtype=torch.float64), L)
        y = y[0].numpy()
        print(json.dumps({
            'chunk': L, 'seconds': time.perf_counter() - t0,
            'vs_long_double': float(np.abs(y - truth).max()) / peak,
            'vs_scipy': float(np.abs(y - ref).max()) / peak,
            'phi_max': float(reference_iir.carry_matrix(coef, L)[0].abs()
                             .max())}), flush=True)


def ratios():
    import numpy as np
    import torch
    from scipy.signal import butter

    from waveforms_tpu_torch.ops import iir_cases, reference_iir
    L = reference_iir.CHUNK
    filters = iir_cases.filters()
    cases = {f'{name}_19x3001': (19, 3001, 8, f)
             for name, f in filters.items()}
    cases.update({'whole_chunks': (37, 65 * L, 81,
                                   filters['near_unit_double_pole']),
                  'state_16': (4, 2 * L + 100, 81, butter(16, 0.3))})
    for name, (rows, n, seed, (b, a)) in cases.items():
        for dtype in (torch.float64, torch.float32):
            coef = iir_cases.coefficients(b, a, dtype)
            d = len(a) - 1
            rng = np.random.default_rng(seed)
            x = torch.tensor(rng.standard_normal((rows, n)), dtype=dtype)
            zi = torch.tensor(rng.standard_normal((rows, d)) * 0.01,
                              dtype=dtype)
            out = {}
            for key, fn in (('blocked', reference_iir.df2t_blocked),
                            ('sequential', reference_iir.df2t)):
                y, zf = torch.empty_like(x), torch.empty_like(zi)
                fn(x, coef, zi, y, zf)
                out[key] = torch.cat([y, zf], 1).double().numpy()
            c = coef.double().numpy()
            per_row, dist = [], {'blocked': 0.0, 'sequential': 0.0}
            for r in range(rows):
                if not np.isfinite(out['sequential'][r]).all():
                    continue
                t = _long_double(c[:d + 1], c[d + 1:],
                                 x[r].double().numpy(),
                                 zi[r].double().numpy())
                peak = float(np.abs(t).max())
                e = {k: float(np.abs(v[r] - t).max()) / peak
                     for k, v in out.items()}
                per_row.append(e['blocked'] / e['sequential'])
                dist = {k: max(dist[k], e[k]) for k in dist}
            print(json.dumps({
                'case': name, 'dtype': str(dtype)[6:], 'rows': len(per_row),
                'largest_row_ratio': max(per_row, default=None),
                'rows_err_ratio': dist['blocked'] / dist['sequential']
                if per_row else None}), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--chunks', type=int, nargs='+',
                    default=[512, 1024, 2048, 4096])
    ap.add_argument('--seed', type=int, default=5)
    ap.add_argument('--ratios', action='store_true')
    args = ap.parse_args()
    by_chunk(args.chunks, args.seed)
    if args.ratios:
        ratios()
    return 0


if __name__ == '__main__':
    sys.exit(main())
