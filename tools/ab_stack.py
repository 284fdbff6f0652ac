#!/usr/bin/env python3
"""A/B of the PyTorch/CUDA port's pulse-instance kernels K5 and K6 on one
GPU: this checkout's builds against those of other checkouts, in one
process.

    python3 tools/ab_stack.py TREE [TREE ...] [--record PATH]

TREE is a directory holding another checkout's
``waveforms_tpu_torch/csrc``: the parent commit's, say, unpacked under
``build/`` with

    git archive <commit> waveforms_tpu_torch/csrc | tar -x -C build/parent

or a scratch copy of this one with another layout.  Its ``synth_stack.cu``
and ``synth_stack_seq.cu`` are built into one library under ``build/``
(tools/ab_dense.py's ``build_other``) and launched through this checkout's
``kernels.launch_stack`` and ``launch_stack_seq`` with the argument types of
the tree's own C prototypes; a tree whose C functions take other parameters
than this checkout's is refused.

Every cell runs on both builds with the same tables and outputs:

- chip_smoke.py's small stack checks (``stack_cases``: a row touched by
  several instances, chunks past the staging capacity, ``n_samples`` not a
  multiple of 4, empty chunks; and ``every_opcode_schedule``), K5 in f32,
  int16, bf16 and f16; the same with the channels repeated until the grid
  has FILL_BLOCKS thread blocks, where this build's output must also equal
  the small grid's repeated;
- K6 on chip_smoke.py's small stacked tables with shots past both ends of
  the table (``SEQ_KS``), in the four output types, and the same shots
  repeated to FILL_BLOCKS thread blocks;
- the main cells: ladder120 f32 and int16 (K5), ``stackseq_ladder`` f32 and
  int16 and ``stackseq_rb`` (K6), as chip_smoke.py builds them.

Outputs are compared bit for bit (sha256 of the bytes; where they differ,
the largest difference).  Each record carries ``staging``: how many of the
cell's chunks the kernels stage in shared memory and how many they walk in
place.  The main cells are also timed in turns (the others, this, this, the
others backwards; AB_ROUNDS rounds), each side's time the median of its
runs with their interquartile range.

Prints one JSON line per cell, then the card's nvidia-smi line and last
``{"ok": ..., "not_identical": [...], "failures": [...]}``.  Exits 1 when a
build fails, this checkout's K5 or K6 spills, or a cell is not identical;
2 without a CUDA device.
"""

import argparse
import ctypes
import json
import re
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / 'tools'))

import ab_dense  # noqa: E402  (the build, the hash, the diff, the turns)
import chip_smoke  # noqa: E402  (the small cases, the timer, the record)
from chip_smoke import log  # noqa: E402

SRCS = ('synth_stack.cu', 'synth_stack_seq.cu')
FNS = ('wf_synth_stack', 'wf_synth_stack_seq')
FILL_BLOCKS = 132 * 16    # thread blocks of a grid that fills the H100: 16
                          # per SM of its 132
_CTYPES = {'int': ctypes.c_int, 'long long': ctypes.c_longlong}


def c_prototypes(tree, srcs=SRCS, fns=FNS):
    """{C function: [(parameter type, name)]} of the C functions ``fns``
    (default: K5's and K6's) in their sources ``srcs`` of checkout
    ``tree``."""
    out = {}
    for src, fn in zip(srcs, fns):
        text = (Path(tree) / 'waveforms_tpu_torch' / 'csrc' / src).read_text()
        m = re.search(r'\bint ' + fn + r'\(([^)]*)\)', text)
        params = [' '.join(p.split()) for p in m.group(1).split(',')]
        out[fn] = [tuple(p.rsplit(' ', 1)) for p in params]
    return out


def argtypes(params):
    """ctypes argument types of a parameter list: pointers as void*."""
    return [ctypes.c_void_p if '*' in ty else _CTYPES[ty.replace('const ', '')]
            for ty, _ in params]


def other_library(tree):
    """K5's and K6's sources of checkout ``tree`` built into one library,
    its C functions given the argument types of its own prototypes ->
    (library, ptxas entries of its kernels)."""
    mine, theirs = c_prototypes(REPO), c_prototypes(tree)
    for fn in FNS:
        if [n for _, n in theirs[fn]] != [n for _, n in mine[fn]]:
            raise RuntimeError(f"{tree}: {fn} takes other parameters than "
                               "this checkout's; launch it with its own "
                               "wrapper")
    lib, entries = ab_dense.build_other(tree, SRCS, FNS, 'libwfstack_other')
    for fn in FNS:
        getattr(lib, fn).argtypes = argtypes(theirs[fn])
    return lib, entries


def side(lib):
    """Launch one call (kind, tables, ks, scale) into ``out`` on build
    ``lib`` (None: this checkout's)."""
    from waveforms_tpu_torch import kernels

    def launch(call, out):
        kind, t, ks, scale = call
        if kind == 'k5':
            kernels.launch_stack(t, out, scale, lib)
        else:
            kernels.launch_stack_seq(t, ks, out, scale, lib=lib)
    return launch


def shape_of(call):
    kind, t, ks, _ = call
    return ((t.n_channels, t.n_samples) if kind == 'k5'
            else (ks.shape[0], t.n_channels, t.n_samples))


def blocks_of(call):
    """Thread blocks of a call's grid."""
    kind, t, ks, _ = call
    return t.n_channels * t.n_chunks * (1 if kind == 'k5' else ks.shape[0])


def run_ab(trees):
    """Every cell on this build and on ``trees``' -> the cells' records."""
    import numpy as np
    import torch

    from waveforms_tpu_torch.ops import StackSequencer
    from waveforms_tpu_torch.ops.lowering import lower_schedule
    from waveforms_tpu_torch.ops.stack_synth import (build_stack_plan,
                                                     build_stack_tables)
    from waveforms_tpu_torch.schedules import (FS, STRATA,
                                               build_ladder_schedule)

    fns = {}
    for tree in trees:
        lib, entries = other_library(tree)
        log({'phase': 'ab_build', 'other': tree, 'entries': entries})
        fns[tree] = side(lib)
    fns['this'] = side(None)

    def compare(name, calls, timed=False, keep=False):
        """calls: [(kind, tables, ks, scale, dtype)], launched as one cell;
        ``keep``: return this build's outputs too."""
        outs = {}
        for key, fn in fns.items():
            res = []
            for *call, dtype in calls:
                out = torch.empty(shape_of(call), dtype=dtype, device='cuda')
                fn(call, out)
                res.append(out)
            torch.cuda.synchronize()
            outs[key] = res
        same, diff = ab_dense.differences(outs, trees)
        rec = {'cell': name, 'launches': len(calls),
               'blocks': max(blocks_of(c[:4]) for c in calls),
               'staging': chip_smoke.staging(calls[0][1]),
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
        mine = outs['this'] if keep else None
        del outs
        torch.cuda.empty_cache()
        return rec, mine

    recs = []
    dtypes = (torch.float32, torch.int16, torch.bfloat16, torch.float16)

    def stack_calls(t, C, ks=None):
        kind = 'k5' if ks is None else 'k6'
        i16 = torch.full((C,), 30000.0, device='cuda')
        return [(kind, t, ks, i16 if dt == torch.int16 else None, dt)
                for dt in dtypes]

    def small_k5(name, low):
        """K5 on a small lowering, and on its channels repeated to fill the
        card, where this build must equal the small grid repeated."""
        t = build_stack_tables(build_stack_plan(low), low, 'cuda')
        rec, small = compare(f'k5_{name}', stack_calls(t, low.shape[0]),
                             keep=True)
        recs.append(rec)
        log(rec)
        reps = -(-FILL_BLOCKS // (low.shape[0] * t.n_chunks))
        wl = ab_dense.repeat_channels(low, reps)
        wt = build_stack_tables(build_stack_plan(wl), wl, 'cuda')
        rec, wide = compare(f'k5_{name}_wide', stack_calls(wt, wl.shape[0]),
                            keep=True)
        rec['wide_equals_small'] = all(
            torch.equal(w, s.repeat(reps, 1)) for w, s in zip(wide, small))
        rec['identical'] = rec['identical'] and rec['wide_equals_small']
        recs.append(rec)
        log(rec)

    for name, chans, stop, bs in chip_smoke.stack_cases():
        small_k5(name, lower_schedule(chans, 0.0, stop, 2e9,
                                      bucket_samples=bs))
    low = chip_smoke.every_opcode_schedule()
    t = build_stack_tables(build_stack_plan(low), low, 'cpu')
    tnf, nt = t.term_nfac.numpy(), t.inst.numpy()[:, 3]
    nf = (tnf * (np.arange(t.NT) < nt[:, None])).sum(1)
    if set(t.op.numpy()[np.arange(t.TF) < nf[:, None]].tolist()) != set(
            range(17)):
        raise RuntimeError("every_opcode_schedule's tables lack an opcode")
    small_k5('every_opcode', low)

    ks_small = chip_smoke.SEQ_KS
    for name, chans in chip_smoke.stack_seq_small_tables():
        lows = [lower_schedule(ch, 0.0, 8.192e-6, 2e9) for ch in chans]
        seq = StackSequencer(lows, device='cuda')
        t = seq.tables
        ks = torch.tensor(ks_small, dtype=torch.int32, device='cuda')
        rec, small = compare(f'k6_{name}', stack_calls(t, t.n_channels, ks),
                             keep=True)
        recs.append(rec)
        log(rec)
        reps = -(-FILL_BLOCKS // (len(ks_small) * t.n_channels * t.n_chunks))
        rec, wide = compare(f'k6_{name}_wide', stack_calls(
            t, t.n_channels, ks.repeat(reps)), keep=True)
        rec['wide_equals_small'] = all(
            torch.equal(w, s.repeat(reps, 1, 1)) for w, s in zip(wide, small))
        rec['identical'] = rec['identical'] and rec['wide_equals_small']
        recs.append(rec)
        log(rec)
    del small, wide

    # the main cells, timed
    chans = STRATA['ladder120'][0]()
    low = lower_schedule(chans, 0.0, STRATA['ladder120'][1], FS)
    t = build_stack_tables(build_stack_plan(low), low, 'cuda')
    C = t.n_channels
    full = torch.full((C,), 32767.0, device='cuda')
    for dt, scale in ((torch.float32, None), (torch.int16, full)):
        rec, _ = compare(f'ladder120_{str(dt)[6:]}_k5',
                         [('k5', t, None, scale, dt)], timed=True)
        recs.append(rec)
        log(rec)
    del t
    chans = [build_ladder_schedule(120, seed=s) for s in range(5, 9)]
    lows = [lower_schedule(c, 0.0, 524.288e-6, FS, bucket_samples=None)
            for c in chans]
    seq = StackSequencer(lows, [build_stack_plan(x) for x in lows],
                         device='cuda')
    order = np.random.default_rng(16).integers(0, 4, 16)   # chip_smoke's
    ks = torch.as_tensor(order, dtype=torch.int32, device='cuda')
    for dt, scale in ((torch.float32, None), (torch.int16, full)):
        rec, _ = compare(f'stackseq_ladder_{str(dt)[6:]}_k6',
                         [('k6', seq.tables, ks, scale, dt)], timed=True)
        recs.append(rec)
        log(rec)
    del seq
    stop = 5.12e-6
    lows = [lower_schedule(ch, 0.0, stop, FS)
            for ch in chip_smoke._vstacks(16, 30, 99, stop=stop)]
    seq = StackSequencer(lows, device='cuda')
    ks = torch.as_tensor(np.arange(1000) % 16, dtype=torch.int32,
                         device='cuda')
    rec, _ = compare('stackseq_rb_k6', [('k6', seq.tables, ks, None,
                                         torch.float32)], timed=True)
    recs.append(rec)
    log(rec)
    return recs


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('trees', nargs='+', metavar='TREE',
                    help="another checkout's directory")
    ap.add_argument('--record', help="write every record to this JSON file")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("ab_stack: no CUDA device visible", file=sys.stderr)
        return 2
    from waveforms_tpu_torch import kernels
    from waveforms_tpu_torch.probes import nvidia_smi
    fail = []
    kernels.load_library()
    mine = {k: v for k, v in chip_smoke.ptxas_entries(
        kernels.build_log.splitlines()).items() if 'synth_stack' in k}
    log({'phase': 'build', 'stack_kernels': mine})
    fail += [f"{k} spills {v[1]} bytes" for k, v in mine.items() if v[1]]
    bad = []
    try:
        bad = [r['cell'] for r in run_ab(args.trees) if not r['identical']]
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
