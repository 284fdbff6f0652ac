#!/usr/bin/env python3
"""A/B of the PyTorch/CUDA port's dense kernels K1 and K3 on one GPU: this
checkout's builds against those of other checkouts, in one process.

    python3 tools/ab_dense.py TREE [TREE ...] [--record PATH]

TREE is a directory holding another checkout's
``waveforms_tpu_torch/csrc`` and ``waveforms_tpu_torch/kernels/__init__.py``:
the parent commit's, say, unpacked under ``build/`` with

    git archive <commit> waveforms_tpu_torch/csrc \\
        waveforms_tpu_torch/kernels/__init__.py | tar -x -C build/parent

or a scratch copy of this one with another layout.  Its ``synth_dense.cu``
and ``synth_dense_hi.cu`` are built into one library under ``build/`` and
launched through this checkout's ``kernels.launch_dense`` and
``launch_dense_hi`` at the largest tile its own wrapper passed (its
``DENSE_TILE``), so their C interfaces must be this checkout's.

Every cell runs on both builds with the same descriptors and outputs:
chip_smoke.py's small dense checks (f32 and int16, pair mode, the exotic
chirps, the double tier's float64 and split planes) and a channel set with
clip rails at ``cmin > 0``, each also repeated over enough channels that
the grid reaches ``MIN_DENSE_BLOCKS`` tiles (where K1 runs 8 samples a
thread, under it 4); then the K1 and K3 cells of chip_smoke.py's main paths
(dense f32 and complex, ladder120 as K1, seq_flagship ``play`` and
``play_many``, the seq_station replay palette, dense and ladder120
double).  Outputs are compared bit for bit (sha256 of the bytes; where
they differ, the largest difference).  The main-path cells are also timed
in turns (the others, this, this, the others backwards; AB_ROUNDS rounds),
each side's time the median of its runs with their interquartile range.

Prints one JSON line per cell, then the card's nvidia-smi line and last
``{"ok": ..., "not_identical": [...], "failures": [...]}``.  Exits 1 when a
build fails, this checkout's K1 or K3 spills (when the run builds them),
or a cell is not identical;
2 without a CUDA device.
"""

import argparse
import dataclasses
import hashlib
import json
import re
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402  (the small cases, the timer, the record)
from chip_smoke import log  # noqa: E402

AB_ROUNDS = 5         # rounds of the timing: 10 runs a side
MIN_DENSE_BLOCKS = 1024   # csrc/synth_common.cuh: from here K1 runs
                          # DENSE_N (8) samples a thread


def build_other(tree, srcs, fns, stem):
    """Sources ``srcs`` of checkout ``tree``'s ``waveforms_tpu_torch/csrc``
    built into one library under ``build/`` (one nvcc per source, at once),
    its C functions ``fns`` given this checkout's argument types -> (library,
    ptxas entries of its kernels).  The library is named by ``stem`` and a
    hash of the tree's sources, and reused when it exists."""
    import ctypes

    from waveforms_tpu_torch import kernels
    csrc = Path(tree) / 'waveforms_tpu_torch' / 'csrc'
    tag = hashlib.sha256(b''.join(
        p.read_bytes() for p in sorted(csrc.iterdir()))).hexdigest()[:12]
    out = kernels.BUILD_DIR / f'{stem}_{tag}.so'
    lines = []
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        objs = [str(out.with_suffix(f'.{s}.o')) for s in srcs]
        procs = [subprocess.Popen(
            [kernels._nvcc(), *kernels.NVCC_FLAGS, '-c', '-o', o,
             str(csrc / s)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
            for s, o in zip(srcs, objs)]
        for p in procs:
            lines.append(p.communicate()[0])
            if p.returncode:
                raise RuntimeError(f"nvcc failed on {tree}:\n{lines[-1]}")
        subprocess.run([kernels._nvcc(), *kernels.ARCH_FLAGS, '-shared',
                        '-o', str(out), *objs], check=True)
    lib = ctypes.CDLL(str(out))
    mine = kernels.load_library()
    for fn in fns:
        getattr(lib, fn).argtypes = getattr(mine, fn).argtypes
        getattr(lib, fn).restype = ctypes.c_int
    return lib, chip_smoke.ptxas_entries(
        [ln.strip() for ln in '\n'.join(lines).splitlines()])


def other_library(tree):
    """K1's and K3's sources of checkout ``tree`` built into one library
    and loaded with this checkout's argument types -> (library, its largest
    tile, ptxas entries of its kernels)."""
    lib, entries = build_other(tree, ('synth_dense.cu', 'synth_dense_hi.cu'),
                               ('wf_synth_dense', 'wf_synth_dense_hi'),
                               'libwfdense_other')
    src = Path(tree) / 'waveforms_tpu_torch'
    m = re.search(r'^DENSE_TILE = (\d+)', (
        src / 'kernels' / '__init__.py').read_text(), re.M)
    return lib, int(m.group(1)), entries


def repeat_channels(low, reps):
    """Lowering ``low`` with its channels repeated ``reps`` times."""
    import numpy as np
    return dataclasses.replace(low, **{
        f.name: np.concatenate([v] * reps)
        for f in dataclasses.fields(low)
        if f.name != 'ext' and isinstance(v := getattr(low, f.name),
                                          np.ndarray)})


def wide(low):
    """``low`` with its channels repeated until K1's grid has at least
    MIN_DENSE_BLOCKS tiles."""
    from waveforms_tpu_torch import kernels
    C = low.shape[0]
    tiles = -(-low.n_samples // kernels.dense_tile(low)) * C
    return repeat_channels(low, -(-MIN_DENSE_BLOCKS // tiles))


def masked_cmin():
    """Gaussians under clip rails [0.2, 1.0]: a sample outside every
    segment must stay 0, not cmin."""
    import numpy as np

    from waveforms_tpu_torch import gaussian
    rng = np.random.default_rng(21)
    chans = [0.8 * gaussian(30e-9) >> float(o)
             for o in rng.uniform(1e-7, 3.9e-6, 3)]
    for w in chans:
        w.min, w.max = 0.2, 1.0
    return chans


def sha(ts):
    """sha256 (16 hex digits) of the outputs' bytes, copied to the host a
    piece at a time."""
    import torch
    h = hashlib.sha256()
    for t in ts:
        t = torch.view_as_real(t) if t.is_complex() else t
        for part in t.contiguous().view(torch.uint8).reshape(-1).split(1 << 28):
            h.update(part.cpu().numpy())
    return h.hexdigest()[:16]


def differences(outs, trees):
    """Bit-for-bit comparison of this build's outputs ``outs['this']`` with
    each tree's -> (identical, {tree: the largest absolute difference, the
    number of samples that differ, the largest one relative to the
    channel's peak (floats only)} for each tree that differs).  Outputs of
    more than two dimensions are compared one leading index at a time."""
    import torch

    def pieces(a, b):
        return zip(a, b) if a.dim() > 2 else [(a, b)]

    diff = {}
    for tree in trees:
        if all(torch.equal(a, b) for a, b in zip(outs['this'], outs[tree])):
            continue
        d = {'max_abs': 0.0, 'n': 0, 'max_rel': None}
        for a0, b0 in zip(outs['this'], outs[tree]):
            for a, b in pieces(a0, b0):
                wa, wb = ((x.to(torch.complex128) if x.is_complex()
                           else x.double()) for x in (a, b))
                e = (wa - wb).abs()
                d['max_abs'] = max(d['max_abs'], float(e.max()))
                d['n'] += int((e > 0).sum())
                if a.is_floating_point() or a.is_complex():
                    d['max_rel'] = max(d['max_rel'] or 0.0,
                                       chip_smoke.rel_err_t(a, b))
                del wa, wb, e
        diff[tree] = d
    return not diff, diff


def in_turns(fns, trees, run):
    """Time ``run(fns[key])`` (a call to time) for each build in turns: the
    others, this, this, the others backwards, AB_ROUNDS rounds -> each
    side's median time, its interquartile range and every run (ms)."""
    import numpy as np
    order = (list(trees) + ['this', 'this'] + list(trees)[::-1]) * AB_ROUNDS
    runs = {}
    for key in order:
        runs.setdefault(key, []).append(chip_smoke.cuda_ms(run(fns[key])))
    return {'ms': {k: float(np.median(v)) for k, v in runs.items()},
            'iqr': {k: float(np.subtract(*np.percentile(v, [75, 25])))
                    for k, v in runs.items()},
            'runs': runs}


def run_ab(trees):
    """Every cell on this build and on ``trees``' -> the cells' records."""
    import numpy as np
    import torch

    from waveforms_tpu_torch import kernels
    from waveforms_tpu_torch.ops.hi_synth import HiSchedule
    from waveforms_tpu_torch.ops.lowering import lower_schedule
    from waveforms_tpu_torch.ops.sequencer import Sequencer
    from waveforms_tpu_torch.ops.synth import DeviceSchedule
    from waveforms_tpu_torch.schedules import (FS, STRATA, build_schedule,
                                               station_channels)

    def launcher(lib, largest):
        def launch(dev, out, scale=None, lo=None):
            if isinstance(dev, HiSchedule):
                kernels.launch_dense_hi(dev, out, lo, lib, largest)
            else:
                kernels.launch_dense(dev, out, scale, lib=lib,
                                     largest=largest)
        return launch

    fns = {}
    for tree in trees:
        lib, largest, entries = other_library(tree)
        log({'phase': 'ab_build', 'other': tree, 'dense_tile': largest,
             'entries': entries})
        fns[tree] = launcher(lib, largest)
    fns['this'] = launcher(None, kernels.DENSE_TILE)

    def compare(name, calls, timed):
        """calls: [(dev, dtype, scale, split)], launched as one cell."""
        outs = {}
        for key, fn in fns.items():
            res = []
            for dev, dtype, scale, split in calls:
                out = torch.empty((dev.shape[0], dev.n_samples),
                                  dtype=dtype, device='cuda')
                lo = torch.empty_like(out) if split else None
                fn(dev, out, scale, lo)
                res += [out] + ([lo] if split else [])
            torch.cuda.synchronize()
            outs[key] = res
        same, diff = differences(outs, trees)
        rec = {'cell': name, 'launches': len(calls),
               'tiles': max(-(-d.n_samples // kernels.dense_tile(d))
                            * d.shape[0] for d, *_ in calls),
               'sha': {k: sha(v) for k, v in outs.items()},
               'identical': same}
        if diff:
            rec['diff'] = diff
        if timed:
            bufs = outs['this']

            def run(fn):
                def go():
                    for (dev, _, scale, _), out in zip(calls, bufs):
                        fn(dev, out, scale, None)
                return go
            rec.update(in_turns(fns, trees, run))
        del outs
        torch.cuda.empty_cache()
        log(rec)
        return rec

    recs = []
    i16 = torch.full((4096,), 30000.0, device='cuda')

    def small(name, low, hi=False):
        """A small check's schedule, and the same repeated to a wide
        grid."""
        for tag, lw in ((name, low), (f'{name}_wide', wide(low))):
            if hi:
                dev = HiSchedule(lw, 'cuda')
                calls = [(dev, torch.float64, None, False),
                         (dev, torch.float32, None, True)]
            elif lw.amp_im is not None:
                calls = [(DeviceSchedule(lw, 'cuda'), torch.complex64, None,
                          False)]
            else:
                dev = DeviceSchedule(lw, 'cuda')
                calls = [(dev, torch.float32, None, False),
                         (dev, torch.int16, i16[:dev.shape[0]].contiguous(),
                          False)]
            recs.append(compare(f'small_{tag}', calls, False))

    for name, chans, start, stop, fs, bs, *_ in chip_smoke.small_cases():
        small(name, lower_schedule(chans, start, stop, fs,
                                   bucket_samples=bs))
    small('masked_cmin', lower_schedule(masked_cmin(), 0.0, 4.096e-6, 2e9))
    for name, chans, start, stop, bs in chip_smoke.pair_cases():
        small(name, lower_schedule(chans, start, stop, 2e9, part='complex',
                                   bucket_samples=bs))
    small('expchirp_hypchirp', chip_smoke.exotic_chirp_schedule())
    for name, chans, start, stop, bs, _ in chip_smoke.hi_small_cases():
        small(f'hi_{name}', lower_schedule(chans, start, stop, 2e9,
                                           bucket_samples=bs, keep_f64=True),
              hi=True)
    # the K1 and K3 cells of the main paths
    for stratum in ('dense', 'ladder120'):
        chans, stop = STRATA[stratum][0](), STRATA[stratum][1]
        dev = DeviceSchedule(lower_schedule(chans, 0.0, stop, FS), 'cuda')
        recs.append(compare(f'{stratum}_f32_k1',
                            [(dev, torch.float32, None, False)], True))
        del dev
        if stratum == 'dense':
            dev = DeviceSchedule(lower_schedule(chans, 0.0, stop, FS,
                                                part='complex'), 'cuda')
            recs.append(compare('dense_complex_k1',
                                [(dev, torch.complex64, None, False)], True))
            del dev
        dev = HiSchedule(lower_schedule(chans, 0.0, stop, FS, keep_f64=True),
                         'cuda')
        recs.append(compare(f'{stratum}_double_k3',
                            [(dev, torch.float64, None, False)], True))
        del dev
    seq = Sequencer([lower_schedule(build_schedule(seed=s), 0.0, 1e-3, FS)
                     for s in range(8)], device='cuda')
    rng = np.random.default_rng(4)        # chip_smoke's shot draws
    k = int(rng.integers(0, 8))
    ks = [seq._clamp(x) for x in (int(rng.integers(0, 8)), 99, -1)]
    recs.append(compare('seq_flagship_play', [
        (seq._schedule(k), torch.float32, None, False)], True))
    recs.append(compare('seq_flagship_play_many', [
        (seq._schedule(x), torch.float32, None, False) for x in ks], True))
    del seq
    seq = Sequencer([lower_schedule(ch, 0.0, 1e-4, FS)
                     for ch in station_channels()], device='cuda')
    recs.append(compare('seq_station_palette', [
        (seq._schedule(x), torch.float32, None, False) for x in range(16)],
        True))
    return recs


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('trees', nargs='+', metavar='TREE',
                    help="another checkout's directory")
    ap.add_argument('--record', help="write every record to this JSON file")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("ab_dense: no CUDA device visible", file=sys.stderr)
        return 2
    from waveforms_tpu_torch import kernels
    from waveforms_tpu_torch.probes import nvidia_smi
    fail = []
    kernels.load_library()
    dense = {k: v for k, v in chip_smoke.ptxas_entries(
        kernels.build_log.splitlines()).items() if 'synth_dense' in k}
    log({'phase': 'build', 'dense_kernels': dense})
    fail += [f"{k} spills {v[1]} bytes" for k, v in dense.items() if v[1]]
    bad = []
    try:
        bad = [r['cell'] for r in run_ab(args.trees) if not r['identical']]
    except Exception as exc:
        fail.append(f"{type(exc).__name__}: {exc}"[-2000:])
    fail += [f"{c} not identical" for c in bad]
    chip_smoke.write_record(args.record)
    print(nvidia_smi(), flush=True)
    print(json.dumps({'ok': not fail, 'not_identical': bad,
                      'failures': fail}), flush=True)
    return 1 if fail else 0


if __name__ == '__main__':
    sys.exit(main())
