#!/usr/bin/env python3
"""A/B of the trace evaluator's kernel T1 on one GPU: this checkout's
``csrc/trace_eval.cu`` against a baseline source, and edits of its launch
shape.

    git show 4cdb121:waveforms_tpu_torch/csrc/trace_eval.cu > build/t1_base.cu
    python3 tools/ab_trace.py --baseline build/t1_base.cu [--record PATH]

(4cdb121 holds the first T1, one block a channel and 2,048 samples, each
sample searching its segment.)  Each build compiles the one source with
the package's nvcc flags (``kernels.NVCC_FLAGS`` and T1's ``-fmad=false``)
into its own library under ``build/ab_trace/<build>/``, all at once, one
nvcc each.  Builds: ``baseline`` (the ``--baseline`` file, called with its
own arguments), ``as_is`` (this source), and edits of it: ``min2`` and
``min4`` (``TRACE_MIN_BLOCKS`` 2 or 4 instead of 3: at most 128 or 64
registers instead of 80), ``group16`` and ``group64`` (at most 16 or 64
channels a block instead of 32), ``fixed32`` (always 32 channels a block,
however few tiles the grid has), ``waves1`` and ``waves4`` (a short
grid's channel groups cut until its blocks fill 1 or 4 waves of the
card instead of 2), ``stores`` (the zero tiles' 16-byte stores as
plain stores, not streaming ones, ``__stcs``), ``cold`` (interp, drag,
mollifier, the gaussian's derivatives and multi-tone DRAG out of line,
so that their registers and spills stay in their own frames) and
``call`` (a live segment's evaluation out of line, a call a sample, in
unrolled loops).  ``--extra NAME=FILE`` adds a whole source of this
interface as a build (an earlier revision of this file, say).
``general`` is no build: the ``as_is`` library called with a real tape's
flag off, T1's general build on the same tape.

Cells, each build timed in turns (every build, then every build backwards;
each time ``probes.cuda_ms``, the median of 11) and its output held bit
for bit (NaN payloads too) to the baseline's: the flagship and the dense
stratum (128 x 2,000,000 f64, the real part), the flagship's complex
output, the flagship over a permuted grid
(``np.random.default_rng(0).permutation``: every tile unsorted), the
dense stratum with its chirp's frequencies scaled down 1000x in the pool
(the phase up to ~940 rad instead of ~9.4e5: what libdevice's sin costs
at the large argument), and short grids: the flagship and the dense
stratum over their first 16,384 samples (128 channels, 8 tiles) and
their first 2 channels over 200,000 samples (a station's shape).  Then
every case of ``ops.trace_cases`` in every output mode, float64 and
float32, and the nine cells above in float32, bit for bit against the
baseline (untimed).

Prints each build's ptxas registers, stack frame and spills for T1's
entries, one JSON line a cell, a line for the cases, and the card's
nvidia-smi line.  Exits 1 if a build fails, an edit does not apply, or any
output differs from the baseline's; 2 without a card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(ROOT, 'waveforms_tpu_torch', 'csrc', 'trace_eval.cu')
SEGMENT = '__device__ __forceinline__ typename Pick<T, REAL>::V segment('
LOOP = """#pragma unroll 1
        for (int i = threadIdx.x; i < n; i += TRACE_THREADS) {"""
STACK_LOOP = """#pragma unroll 1
          for (int k = 0; k < TRACE_SPT; ++k) {"""


def _edit(*pairs):
    """An edit replacing each (old, new) pair given in turn."""
    pairs = list(zip(pairs[::2], pairs[1::2]))

    def apply(src):
        for old, new in pairs:
            if old not in src:
                raise RuntimeError(f"edit {old!r} does not apply")
            src = src.replace(old, new)
        return src
    return apply


# the bases with the most registers and the fewest users, out of line
COLD = [x for name in ('Val<T> b_interp(', 'T b_drag(', 'T b_mollifier(',
                       'T b_d_gaussian(', 'T b_multi(')
        for x in ('__device__ ' + name, '__device__ __noinline__ ' + name)]


VARIANTS = {
    'as_is': lambda s: s,
    'min2': _edit('TRACE_MIN_BLOCKS = 3;', 'TRACE_MIN_BLOCKS = 2;'),
    'min4': _edit('TRACE_MIN_BLOCKS = 3;', 'TRACE_MIN_BLOCKS = 4;'),
    'group16': _edit('TRACE_GROUP = 32;', 'TRACE_GROUP = 16;'),
    'group64': _edit('TRACE_GROUP = 32;', 'TRACE_GROUP = 64;'),
    'fixed32': _edit('const long long g = tiles * n_ch / want;',
                     'const long long g = TRACE_GROUP;'),
    'waves1': _edit('TRACE_WAVES = 2;', 'TRACE_WAVES = 1;'),
    'waves4': _edit('TRACE_WAVES = 2;', 'TRACE_WAVES = 4;'),
    'stores': _edit('__stcs(qv + j, pat);', 'qv[j] = pat;'),
    'cold': _edit(*COLD),
    'call': _edit(SEGMENT, SEGMENT.replace('forceinline', 'noinline'),
                  LOOP, LOOP.replace('#pragma unroll 1\n', ''),
                  STACK_LOOP, STACK_LOOP.replace('unroll 1', 'unroll')),
}


def bits_equal(a, b):
    """Whether two outputs hold the same bits (NaN payloads included)."""
    import torch
    if a.is_complex():
        a, b = torch.view_as_real(a), torch.view_as_real(b)
    it = torch.int64 if a.element_size() == 8 else torch.int32
    return torch.equal(a.view(it), b.view(it))


def build_all(baseline, names, extras):
    """Build every variant, every extra source ({name: path}) and the
    baseline at once -> {build: (ctypes library, chip_smoke.t1_builds of
    its ptxas lines)}; raises if a build fails or an edit does not
    apply."""
    import ctypes

    sys.path.insert(0, ROOT)
    from chip_smoke import ptxas_entries, t1_builds
    from waveforms_tpu_torch import kernels
    src = open(SOURCE).read()
    texts = {'baseline': open(baseline).read()}
    texts.update({n: VARIANTS[n](src) for n in names})
    texts.update({n: open(path).read() for n, path in extras.items()})
    nvcc = kernels._nvcc()
    flags = (*kernels.NVCC_FLAGS, *kernels.SOURCE_FLAGS['trace_eval.cu'])
    procs = {}
    for name, text in texts.items():
        d = os.path.join(ROOT, 'build', 'ab_trace', name)
        os.makedirs(d, exist_ok=True)
        cu, lib = os.path.join(d, 'trace_eval.cu'), os.path.join(d, 'lib.so')
        with open(cu, 'w') as f:
            f.write(text)
        procs[name] = (lib, subprocess.Popen(
            [nvcc, *flags, '-shared', '-o', lib, cu], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    libs = {}
    for name, (path, p) in procs.items():
        out, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"{name} failed to build:\n{out[-4000:]}")
        lib = ctypes.CDLL(path)
        lib.wf_trace_eval.argtypes = ([P, P, P, L, P, P, P, I, I, I]
                                      + ([] if name == 'baseline' else [I])
                                      + [P])
        lib.wf_trace_eval.restype = I
        libs[name] = (lib, t1_builds(ptxas_entries(out.splitlines())))
    return libs


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--baseline', required=True,
                    help="the baseline's trace_eval.cu")
    ap.add_argument('--variants', default=','.join(VARIANTS),
                    help='comma-separated builds besides the baseline')
    ap.add_argument('--extra', action='append', default=[],
                    metavar='NAME=FILE',
                    help='another trace_eval.cu of this interface to build '
                         'and time as NAME')
    ap.add_argument('--record', help='write every line to this JSON file')
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch

    import waveforms_tpu_torch as wt
    from waveforms_tpu_torch.ops import trace_cases, trace_tape
    from waveforms_tpu_torch.probes import cuda_ms, nvidia_smi
    from waveforms_tpu_torch.schedules import FS, STRATA
    if not torch.cuda.is_available():
        print("ab_trace: no CUDA device visible", file=sys.stderr)
        return 2
    names = [n for n in args.variants.split(',') if n]
    records = []

    def emit(rec):
        records.append(rec)
        print(json.dumps(rec), flush=True)

    extras = dict(x.split('=', 1) for x in args.extra)
    libs = build_all(args.baseline, names, extras)
    for name, (_, res) in libs.items():
        emit({'build': name, 'ptxas': res})
    runs = ['baseline'] + names + list(extras) + ['general']

    def launcher(run, tape, grid, mode, out):
        """A launch of ``run``'s library on the tape over ``grid``."""
        lib = libs['as_is' if run == 'general' else run][0]
        prog, pool = tape.tensors('cuda')
        re_, im_ = trace_tape.ext_planes(tape, grid)
        dt = 0 if grid.dtype == torch.float64 else 1
        extra = ([] if run == 'baseline' else
                 [0 if run == 'general' else int(tape.real)])
        stream = torch.cuda.current_stream().cuda_stream

        def launch():
            code = lib.wf_trace_eval(
                prog.data_ptr(), pool.data_ptr(), grid.data_ptr(),
                grid.shape[0], None if re_ is None else re_.data_ptr(),
                None if im_ is None else im_.data_ptr(), out.data_ptr(),
                tape.n_channels, dt, mode, *extra, stream)
            if code:
                raise RuntimeError(f"{run}: CUDA error {code}")
        return launch

    def new_out(tape, grid, mode):
        cdt = (torch.complex128 if grid.dtype == torch.float64
               else torch.complex64)
        return torch.empty((tape.n_channels, grid.shape[0]),
                           dtype=cdt if mode == 2 else grid.dtype,
                           device='cuda')

    def slow_phase(tape):
        """The tape with each linear chirp's frequencies scaled by 1e-3."""
        pool = tape.pool.copy()
        r = trace_tape.Records(tape.prog, tape.pool)
        for i in range((len(r.P) - r.off['uf']) // trace_tape.R_UF):
            code, off, _, _ = r.rec('uf', i)
            if code == 8:           # LINEARCHIRP: phi0, (f1 - f0) / 2T, f0
                pool[off + 2:off + 4] *= 1e-3
        return trace_tape.Tape(tape.prog, pool, tape.complex, tape.ext,
                               tape.real)

    ok = True
    flag = STRATA['flagship'][0]()
    dense = STRATA['dense'][0]()
    t = np.arange(0.0, 1e-3, 1 / FS)
    perm = np.random.default_rng(0).permutation(t)
    tape_of = lambda chans: trace_tape.tape_of(  # noqa: E731
        tuple(trace_tape.channel_key(c) for c in chans))
    dense_tape = tape_of(dense)
    cells = (('flagship', tape_of(flag), t, 0),
             ('dense', dense_tape, t, 0),
             ('flagship_complex', tape_of(flag), t, 2),
             ('flagship_permuted', tape_of(flag), perm, 0),
             ('dense_slow_phase', slow_phase(dense_tape), t, 0),
             ('flagship_16k', tape_of(flag), t[:16384], 0),
             ('dense_16k', dense_tape, t[:16384], 0),
             ('flagship_2ch', tape_of(flag[:2]), t[:200000], 0),
             ('dense_2ch', tape_of(dense[:2]), t[:200000], 0))
    for cell, tape, grid_np, mode in cells:
        grid = torch.from_numpy(grid_np).to('cuda')
        rec = {'cell': cell, 'mode': mode, 'real_tape': tape.real,
               'ms': {}, 'equal': {}}
        first = None
        order = [r for r in runs if r != 'general' or tape.real]
        for run in order + order[::-1]:
            out = new_out(tape, grid, mode)
            rec['ms'].setdefault(run, []).append(
                cuda_ms(launcher(run, tape, grid, mode, out), 11, 0.05))
            torch.cuda.synchronize()
            if first is None:
                first = out
            else:
                rec['equal'][run] = bits_equal(out, first)
                ok = ok and rec['equal'][run]
                del out
        emit(rec)
        del first, grid
        torch.cuda.empty_cache()

    # bit for bit, untimed: the cells in float32, every case in every mode
    checked, differ = 0, []
    work = [(cell, tape, grid_np.astype(np.float32), (mode,))
            for cell, tape, grid_np, mode in cells]
    for name, (chans, grid_np, _) in trace_cases.cases(wt).items():
        for dt in (np.float64, np.float32):
            work.append((name, tape_of(chans), grid_np.astype(dt),
                         (0, 1, 2)))
    for name, tape, grid_np, modes in work:
        grid = torch.from_numpy(np.ascontiguousarray(grid_np)).to('cuda')
        for mode in modes:
            ref = new_out(tape, grid, mode)
            launcher('baseline', tape, grid, mode, ref)()
            for run in runs:
                if run == 'general' and not tape.real:
                    continue
                out = new_out(tape, grid, mode)
                launcher(run, tape, grid, mode, out)()
                checked += 1
                if not bits_equal(out, ref):
                    differ.append([name, str(grid_np.dtype), mode, run])
                del out
        del grid, ref
        torch.cuda.empty_cache()
    ok = ok and not differ
    emit({'bit_equal_checks': checked, 'differ': differ})
    smi = nvidia_smi()
    emit({'nvidia_smi': smi})
    if args.record:
        os.makedirs(os.path.dirname(os.path.abspath(args.record)),
                    exist_ok=True)
        with open(args.record, 'w') as f:
            json.dump(records, f, indent=1)
    return 0 if ok else 1


if __name__ == '__main__':
    sys.exit(main())
