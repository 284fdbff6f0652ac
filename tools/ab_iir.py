#!/usr/bin/env python3
"""A/B of the PyTorch/CUDA port's IIR recurrence kernel S1 on one GPU: this
checkout's S1 against those of other checkouts, in one process.

    python3 tools/ab_iir.py TREE [TREE ...] [--record PATH]

TREE is a directory holding another checkout's ``waveforms_tpu_torch``
package: the parent commit's, say, unpacked under ``build/`` with

    git archive <commit> waveforms_tpu_torch | tar -x -C build/parent

or a scratch copy of this one with another chunk (``IIR_L``) or layout.
Its package is imported under another name and builds its kernels from
its own sources into its own ``build/``; each side runs S1 through its
own counted wrapper ``kernels.iir_df2t(x, coef, zi, y, zf)`` on the same
inputs, so the builds' C interfaces need not agree.

The cells are chip_smoke.py's S1 cells: the flagship's clustered stage
(the flagship's f32 plane from ``synthesize``, in f64, 128 x 2,000,000,
from a zero state) and S1 on the Z-settle pair over the same rows (which
``lfilter`` routes to the doubling scan), both timed in turns (the others,
this, this, the others backwards; AB_ROUNDS rounds; each side's median and
interquartile range; each CUDA kernel's launches and device time a call
from torch.profiler's trace, chip_smoke.traced_kernels), and (8, 20,000)
random rows of butter(5, 0.15), the near-unit double pole and the
clustered filter.  Each side's first chunk (this build's) is held to the
sequential ``df2t`` bit for bit, and its distance (chip_smoke.rows_err)
to scipy's float64 lfilter and to its np.longdouble answer taken on
chip_smoke.py's 4 seeded flagship rows and on all 8 random rows; this
build's outputs are also held to the plain model of its arithmetic,
``reference_iir.df2t_blocked``, over the first chip_smoke.S1_COLS
columns (every column and the final state of the random rows).

Prints one JSON line per cell, then the card's nvidia-smi line and last
``{"ok": ..., "failures": [...]}``; the build lines give the S1 kernels'
ptxas resources, this build's at d = 3 and d = 16.  Exits 1 when a build
fails, this checkout's S1 spills at d <= 5, or it misses its contract (the
bit-equalities; a long-double distance at most chip_smoke.TOL_S1_LD times
the sequential recurrence's, scipy's on the flagship rows, or
TOL_S1_FLOOR; chip_smoke.TOL_DIRECT_FORM of scipy on the flagship rows);
2 without a CUDA device.
"""

import argparse
import importlib
import importlib.util
import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / 'tools'))

import chip_smoke  # noqa: E402  (the filters, the timer, the record)
from ab_dense import build_other, in_turns  # noqa: E402
from chip_smoke import log, rows_err, s1_resources  # noqa: E402

SPILL_FREE_D = 5       # this build's S1 must not spill at d <= 5


def other_kernels(tree, name):
    """Checkout ``tree``'s ``waveforms_tpu_torch`` imported as the package
    ``name`` -> its ``kernels`` module, with its library built from the
    tree's sources and loaded."""
    root = Path(tree).resolve() / 'waveforms_tpu_torch'
    spec = importlib.util.spec_from_file_location(
        name, root / '__init__.py', submodule_search_locations=[str(root)])
    sys.modules[name] = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(sys.modules[name])
    mod = importlib.import_module(f'{name}.kernels')
    mod.load_library()
    return mod


def run_ab(trees, fail):
    """Every cell on this build and on ``trees``' -> the cells' records;
    this build's contract misses appended to ``fail``."""
    import numpy as np
    import scipy.signal as sps
    import torch

    import waveforms_tpu_torch as wt
    from waveforms_tpu_torch import kernels
    from waveforms_tpu_torch.distortion import (combine_filters,
                                                exp_decay_filter)
    from waveforms_tpu_torch.ops import iir_cases, reference_iir
    from waveforms_tpu_torch.schedules import FS, build_schedule

    sides = {}
    for i, tree in enumerate(trees):
        sides[tree] = other_kernels(tree, f'_ab_iir_other{i}')
        log({'phase': 'ab_build', 'other': tree, 's1': s1_resources(
            chip_smoke.ptxas_entries(sides[tree].build_log.splitlines()))})
    sides['this'] = kernels
    L = kernels.iir_df2t_chunk()

    def cell(name, x, coef, zi, rows, ref, timed):
        """One cell on every side: checks, distances on ``rows``, and the
        times in turns."""
        cols = min(chip_smoke.S1_COLS, x.shape[1]) if timed else x.shape[1]
        xk = x[:, :cols].contiguous()
        plain = torch.empty_like(xk)
        reference_iir.df2t(xk, coef, zi, plain, torch.empty_like(zi))
        yb, zfb = torch.empty_like(xk), torch.empty_like(zi)
        reference_iir.df2t_blocked(xk, coef, zi, yb, zfb, L)
        host = x[rows].cpu().numpy()
        want = [ref(h) for h in host]
        truth = chip_smoke.long_double(coef, host)
        rec = {'cell': name, 'shape': list(x.shape), 'd': zi.shape[1],
               'chunk': L, 'scipy_vs_long_double': rows_err(want, truth),
               'plain_vs_long_double': rows_err(
                   plain[rows].cpu().numpy(), [t[:cols] for t in truth]),
               'sides': {}}
        y, zf = torch.empty_like(x), torch.empty_like(zi)
        for key, mod in sides.items():
            mod.iir_df2t(x, coef, zi, y, zf)
            torch.cuda.synchronize()
            got = y[rows].cpu().numpy()
            rec['sides'][key] = {
                'first_chunk_equal': bool(torch.equal(
                    y[:, :min(L, cols)], plain[:, :L])),
                'vs_scipy': rows_err(got, want),
                'vs_long_double': rows_err(got, truth),
                'finite': bool(torch.isfinite(y).all())}
        mine = rec['sides']['this']
        mine['model_equal'] = bool(torch.equal(y[:, :cols], yb) and (
            cols < x.shape[1] or torch.equal(zf, zfb)))
        if timed:
            rec.update(in_turns(
                {k: mod.iir_df2t for k, mod in sides.items()}, trees,
                lambda fn: lambda: fn(x, coef, zi, y, zf)))
            rec['kernels'] = {k: chip_smoke.traced_kernels(
                lambda mod=mod: mod.iir_df2t(x, coef, zi, y, zf),
                r'iir_\w+_kernel') for k, mod in sides.items()}
        seq = rec['scipy_vs_long_double'] if timed else rec[
            'plain_vs_long_double']
        ok = (mine['first_chunk_equal'] and mine['model_equal']
              and mine['vs_long_double'] <= max(chip_smoke.TOL_S1_LD * seq,
                                                chip_smoke.TOL_S1_FLOOR))
        if timed:
            ok = ok and mine['vs_scipy'] <= chip_smoke.TOL_DIRECT_FORM
        rec['ok'] = bool(ok)
        if not ok:
            fail.append(f"{name}: this build misses its contract")
        del y, zf, plain, yb
        torch.cuda.empty_cache()
        log(rec)
        return rec

    recs = []
    b_s, a_s = combine_filters([exp_decay_filter(a, t, FS, inv=True)
                                for a, t in zip(*chip_smoke.Z_SETTLE)])
    b_c, a_c = iir_cases.filters()['clustered']
    x = wt.synthesize(build_schedule(), 0.0, 1e-3, FS,
                      device='cuda').double()
    rows = chip_smoke.seeded_rows(x.shape[0], 4, 9)   # signal_flagship's
    for name, (b, a) in (('flagship_clustered', (b_c, a_c)),
                         ('flagship_z_settle', (b_s, a_s))):
        coef, zi = chip_smoke.s1_rows(b, a, x)
        recs.append(cell(name, x, coef, zi, rows,
                         lambda h, b=b, a=a: sps.lfilter(b, a, h), True))
    del x
    torch.cuda.empty_cache()
    rng = np.random.default_rng(12)                   # s1_vs_plain's
    xs = torch.tensor(rng.standard_normal((8, 20_000)), device='cuda')
    for name, (b, a) in iir_cases.filters().items():
        coef, zi = chip_smoke.s1_rows(b, a, xs)
        recs.append(cell(f'random_{name}', xs, coef, zi, list(range(8)),
                         lambda h, b=b, a=a: sps.lfilter(b, a, h), False))
    return recs


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('trees', nargs='*', metavar='TREE',
                    help="another checkout's directory")
    ap.add_argument('--record', help="write every record to this JSON file")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("ab_iir: no CUDA device visible", file=sys.stderr)
        return 2
    from waveforms_tpu_torch import kernels
    from waveforms_tpu_torch.probes import nvidia_smi
    fail = []
    kernels.load_library()
    if kernels.build_log:
        entries = chip_smoke.ptxas_entries(kernels.build_log.splitlines())
    else:                           # a library built earlier: build S1 alone
        entries = build_other(REPO, ('iir_df2t.cu',), (), 'libwfiir_this')[1]
    mine = s1_resources(entries)
    log({'phase': 'build', 's1': {k: {dt: {d: v[d] for d in (3, 16) if d in v}
                                      for dt, v in per.items()}
                                  for k, per in mine.items()}})
    fail += [f"{k} {dt} d={d} spills {v[1]} bytes"
             for k, per in mine.items() for dt, byd in per.items()
             for d, v in byd.items() if d <= SPILL_FREE_D and v[1]]
    if not mine:
        fail.append("no ptxas lines for S1's kernels")
    try:
        run_ab(args.trees, fail)
    except Exception as exc:
        fail.append(f"{type(exc).__name__}: {exc}"[-2000:])
    chip_smoke.write_record(args.record)
    print(nvidia_smi(), flush=True)
    print(json.dumps({'ok': not fail, 'failures': fail}), flush=True)
    return 1 if fail else 0


if __name__ == '__main__':
    sys.exit(main())
