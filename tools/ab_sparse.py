#!/usr/bin/env python3
"""A/B of the PyTorch/CUDA port's worklist kernel K7 and its probe P1 on one
GPU: this checkout's builds against those of other checkouts, in one
process.

    python3 tools/ab_sparse.py TREE [TREE ...] [--record PATH]

TREE is a directory holding another checkout's
``waveforms_tpu_torch/csrc``: the parent commit's, say, unpacked under
``build/`` with

    git archive <commit> waveforms_tpu_torch/csrc | tar -x -C build/parent

or a scratch copy of this one with another layout (the constants at the
top of ``csrc/synth_item.cuh``).  Its ``synth_sparse.cu`` and ``probes.cu``
are built into one library under ``build/`` (tools/ab_dense.py's
``build_other``) and launched through this checkout's
``kernels.launch_sparse`` and ``launch_probe_sparse_compact``; a tree whose
C functions take other parameters than this checkout's is refused.

Every cell runs on both builds with the same descriptors, worklists and
outputs (K7's outputs start from a background of 7s, so a store outside
the live subtiles shows):

- chip_smoke.py's small cases (``small_cases``, one bucket and several)
  through K7 in f32, int16, bf16 and f16, the exotic chirps in f32 and the
  pair-mode cases (``pair_cases``) as complex64;
- subtiles of Rs 1, 3, 8 and 32 rows on windows that are not a multiple
  of the subtile, in the four real output types and in pair mode;
- worklists padded 4x (``probes.pad_work``);
- an occupancy-1 schedule at Rs 1 whose worklist has 131,072 items (more
  than the 65,535 blocks of a grid's y axis);
- ``Sequencer.play_sparse``'s worklists for chip_smoke.py's small tables,
  shots past both ends of the table included (``SEQ_KS``);
- the main cells: the flagship sparse cell (``engine='cuda-sparse'``'s
  plan), ``seq_flagship`` ``play_sparse``, and the ``probes`` path's P1
  inputs (128 flagship channels over 524.288 us): K7 on the worklist and
  on it padded 4x, and P1 compact, padded and not.

Outputs are compared bit for bit (sha256 of the bytes; where they differ,
the largest difference).  The main cells are also timed in turns (the
others, this, this, the others backwards; AB_ROUNDS rounds), each side's
time the median of its runs with their interquartile range.

Prints one JSON line per cell, then the time of one empty launch under
the same timer (``chip_smoke.launch_floor_ms``, taken after the cells,
on a warm card), the card's nvidia-smi line and last
``{"ok": ..., "not_identical": [...], "failures": [...]}``.  Exits 1 when a
build fails, this checkout's K7 or P1 spills, or a cell is not identical;
2 without a CUDA device.
"""

import argparse
import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / 'tools'))

import ab_dense  # noqa: E402  (the build, the hash, the diff, the turns)
import ab_stack  # noqa: E402  (the C prototypes and their argument types)
import chip_smoke  # noqa: E402  (the small cases, the timer, the record)
from chip_smoke import log  # noqa: E402

SRCS = ('synth_sparse.cu', 'probes.cu')
FNS = ('wf_synth_sparse', 'wf_probe_sparse_compact')
RS_SWEEP = (1, 3, 8, 32)
BACKGROUND = 7


def other_library(tree):
    """K7's and P1's sources of checkout ``tree`` built into one library,
    its C functions given the argument types of its own prototypes ->
    (library, ptxas entries of its kernels)."""
    mine = ab_stack.c_prototypes(REPO, SRCS, FNS)
    theirs = ab_stack.c_prototypes(tree, SRCS, FNS)
    for fn in FNS:
        if [n for _, n in theirs[fn]] != [n for _, n in mine[fn]]:
            raise RuntimeError(f"{tree}: {fn} takes other parameters than "
                               "this checkout's; launch it with its own "
                               "wrapper")
    lib, entries = ab_dense.build_other(tree, SRCS, FNS, 'libwfsparse_other')
    for fn in FNS:
        getattr(lib, fn).argtypes = ab_stack.argtypes(theirs[fn])
    return lib, entries


def side(lib):
    """Launch one call (kind, dev, work, scale, shape) into ``out`` on
    build ``lib`` (None: this checkout's)."""
    from waveforms_tpu_torch import kernels

    def launch(call, out):
        kind, dev, work, scale, _ = call
        if kind == 'k7':
            kernels.launch_sparse(dev, work, out, scale, lib)
        else:
            kernels.launch_probe_sparse_compact(dev, work, out, lib)
    return launch


def run_ab(trees):
    """Every cell on this build and on ``trees``' -> the cells' records."""
    import numpy as np
    import torch

    from waveforms_tpu_torch import probes
    from waveforms_tpu_torch.ops.lowering import lower_schedule
    from waveforms_tpu_torch.ops.sequencer import Sequencer
    from waveforms_tpu_torch.ops.sparse_synth import (SparseWork,
                                                      build_sparse_plan)
    from waveforms_tpu_torch.ops.synth import DeviceSchedule
    from waveforms_tpu_torch.schedules import (FS, STRATA, build_schedule,
                                               build_dense_schedule)

    fns = {}
    for tree in trees:
        lib, entries = other_library(tree)
        log({'phase': 'ab_build', 'other': tree, 'entries': entries})
        fns[tree] = side(lib)
    fns['this'] = side(None)

    def compare(name, calls, timed=False):
        """calls: [(kind, dev, work, scale, shape, dtype)], launched as one
        cell on outputs that start from BACKGROUND."""
        outs = {}
        for key, fn in fns.items():
            res = []
            for *call, dtype in calls:
                out = torch.full(call[4], BACKGROUND, dtype=dtype,
                                 device='cuda')
                fn(call, out)
                res.append(out)
            torch.cuda.synchronize()
            outs[key] = res
        same, diff = ab_dense.differences(outs, trees)
        rec = {'cell': name, 'launches': len(calls),
               'items': max(c[2].work_c.shape[0] for c in calls),
               'Rs': sorted({c[2].Rs for c in calls}),
               'sha': {k: ab_dense.sha(v) for k, v in outs.items()},
               'identical': same}
        if diff:
            rec['diff'] = diff
        if timed:
            bufs = outs['this']

            def run(fn):
                def go():
                    for (*call, _), out in zip(calls, bufs):
                        fn(call, out)
                return go
            rec.update(ab_dense.in_turns(fns, trees, run))
        del outs
        torch.cuda.empty_cache()
        log(rec)
        return rec

    recs = []
    real = (torch.float32, torch.int16, torch.bfloat16, torch.float16)
    i16 = torch.full((4096,), 30000.0, device='cuda')

    def k7_calls(dev, plan, dtypes=real, work=None):
        work = work or SparseWork.upload(plan, 'cuda')
        shape = (dev.shape[0], plan.window_samples)
        return [('k7', dev, work,
                 i16[:dev.shape[0]].contiguous() if dt == torch.int16
                 else None, shape, dt) for dt in dtypes]

    def sparse_cell(name, low, Rs=32, dtypes=real, timed=False):
        dev = DeviceSchedule(low, 'cuda')
        plan = build_sparse_plan(low, Rs=Rs)
        recs.append(compare(name, k7_calls(dev, plan, dtypes), timed))
        return dev, plan

    # chip_smoke.py's small checks
    lows, cases = {}, {}
    for name, chans, start, stop, fs, bs, *_ in chip_smoke.small_cases():
        cases[name] = (chans, start, stop, fs, {})
        lows[name] = lower_schedule(chans, start, stop, fs,
                                    bucket_samples=bs)
        sparse_cell(f'small_{name}', lows[name])
    sparse_cell('small_expchirp_hypchirp', chip_smoke.exotic_chirp_schedule(),
                dtypes=(torch.float32,))
    for name, chans, start, stop, bs in chip_smoke.pair_cases():
        cases[name] = (chans, start, stop, 2e9, {'part': 'complex'})
        sparse_cell(f'small_{name}', lower_schedule(
            chans, start, stop, 2e9, part='complex', bucket_samples=bs),
            dtypes=(torch.complex64,))

    # subtile heights on windows one sample short (3999, 19,999 and 16,383
    # samples: not a multiple of any subtile), in buckets of 4 subtiles
    for Rs in RS_SWEEP:
        for name in ('shapes', 'linearchirp', 'pair_pulses'):
            chans, start, stop, fs, kw = cases[name]
            sparse_cell(f'rs{Rs}_{name}', lower_schedule(
                chans, start, stop - 1 / fs, fs, bucket_samples=Rs * 128 * 4,
                **kw), Rs=Rs, dtypes=(torch.complex64,) if kw else real)

    # padding items
    for name in ('two_buckets', 'shapes'):
        dev = DeviceSchedule(lows[name], 'cuda')
        plan = build_sparse_plan(lows[name])
        padded = probes.pad_work(SparseWork.upload(plan, 'cuda'))
        recs.append(compare(f'pad4_{name}',
                            k7_calls(dev, plan, work=padded)))

    # more items than a grid's y axis holds
    low = lower_schedule(build_dense_schedule(128, 65.536e-6), 0.0,
                         65.536e-6, FS)
    sparse_cell('rs1_131072_items', low, Rs=1,
                dtypes=(torch.float32, torch.int16))

    # play_sparse's worklists, shots past both ends
    for name, chans, stop, kw, _ in chip_smoke.seq_small_tables():
        lows_t = [lower_schedule(ch, 0.0, stop, 2e9, **kw) for ch in chans]
        if kw or lows_t[0].shape[1] > 1:
            continue                 # play_sparse: real one-bucket tables
        seq = Sequencer(lows_t, device='cuda')
        calls = []
        for k in chip_smoke.SEQ_KS:
            dev, work = seq._sparse_args(seq._clamp(k), 32)
            calls.append(('k7', dev, work, None,
                          (seq.shape[0], seq.n_samples), torch.float32))
        recs.append(compare(f'play_sparse_{name}', calls))

    # the main cells, timed
    chans, stop = STRATA['flagship'][0](), STRATA['flagship'][1]
    low = lower_schedule(chans, 0.0, stop, FS)
    sparse_cell('flagship_sparse_f32', low, dtypes=(torch.float32,),
                timed=True)
    sparse_cell('flagship_sparse_i16_bf16', low,
                dtypes=(torch.int16, torch.bfloat16))
    del low
    seq = Sequencer([lower_schedule(build_schedule(seed=s), 0.0, 1e-3, FS)
                     for s in range(8)], device='cuda')
    k = int(np.random.default_rng(4).integers(0, 8))   # chip_smoke's shot
    dev, work = seq._sparse_args(k, 32)
    recs.append(compare('seq_flagship_play_sparse', [
        ('k7', dev, work, None, (seq.shape[0], seq.n_samples),
         torch.float32)], timed=True))
    del seq, dev, work
    sp = probes.sparse_inputs()
    dev, work, padded = sp['dev'], sp['work'], sp['padded']
    shape = (dev.shape[0], sp['plan'].window_samples)
    for tag, w in (('', work), ('_pad4', padded)):
        recs.append(compare(f'probes_k7{tag}', [
            ('k7', dev, w, None, shape, torch.float32)], timed=True))
        recs.append(compare(f'probes_p1_compact{tag}', [
            ('p1', dev, w, None, (w.work_c.shape[0], w.Rs, 128),
             torch.float32)], timed=True))
    return recs


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('trees', nargs='+', metavar='TREE',
                    help="another checkout's directory")
    ap.add_argument('--record', help="write every record to this JSON file")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("ab_sparse: no CUDA device visible", file=sys.stderr)
        return 2
    from waveforms_tpu_torch import kernels
    from waveforms_tpu_torch.probes import nvidia_smi
    fail = []
    kernels.load_library()
    mine = {k: v for k, v in chip_smoke.ptxas_entries(
        kernels.build_log.splitlines()).items()
        if 'synth_sparse' in k or 'probe_sparse_compact' in k}
    log({'phase': 'build', 'sparse_kernels': mine})
    fail += [f"{k} spills {v[1]} bytes" for k, v in mine.items() if v[1]]
    bad = []
    try:
        bad = [r['cell'] for r in run_ab(args.trees) if not r['identical']]
        log({'phase': 'launch_floor', 'ms': chip_smoke.launch_floor_ms()})
    except Exception as exc:
        import traceback
        log({'phase': 'ab', 'error': traceback.format_exc()[-4000:]})
        fail.append(f"{type(exc).__name__}: {exc}"[-2000:])
    fail += [f"{c} not identical" for c in bad]
    chip_smoke.write_record(args.record)
    print(nvidia_smi(), flush=True)
    print(json.dumps({'ok': not fail, 'not_identical': bad,
                      'failures': fail}), flush=True)
    return 1 if fail else 0


if __name__ == '__main__':
    sys.exit(main())
