#!/usr/bin/env python3
"""A/B of launch shapes of the trace evaluator's kernel T1 on one GPU.

    python3 tools/ab_trace.py [--record PATH]

Each variant is this checkout's ``csrc/trace_eval.cu`` with one edit of
its launch shape (below, :data:`VARIANTS`), built from a copy of the
package under ``build/ab_trace/<variant>/`` (the builds run at once, one
process each).  Each build's ``wf_trace_eval`` is loaded with ctypes and
run on the same tapes and grids: the flagship and the dense stratum
(128 x 2,000,000 f64, the real part) and the flagship's complex output,
timed in turns (every variant, then every variant backwards; each time
``probes.cuda_ms``, the median of 11) and held bit for bit to the first
variant's output.

Variants: ``as_is`` (the source as it is: 256 threads of 8 samples, the
grid's 8 values loaded first and the 8 samples' code unrolled); ``min4``
(``__launch_bounds__(256, 4)``: at most 64 registers); ``rolled`` (no
preload, the sample loop not unrolled); ``rolled_min4`` and
``rolled_min8`` (both); ``spt4_min4`` (4 samples a thread, at most 64
registers).

Prints each build's ptxas lines for T1's six entries (f64 and f32, three
output modes), then one JSON line a cell with each variant's two times and
whether its output equals the first's, then the card's nvidia-smi line.
Exits 1 if a build fails or an output differs.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(ROOT, 'waveforms_tpu_torch', 'csrc', 'trace_eval.cu')
PRELOAD = """      T tv[TRACE_SPT];
#pragma unroll
      for (int k = 0; k < TRACE_SPT; ++k) {
        long long n = base + (long long)k * TRACE_THREADS + threadIdx.x;
        tv[k] = n < N ? grid[n] : (T)0;
      }
#pragma unroll
"""


def _rolled(src):
    return src.replace(PRELOAD, "#pragma unroll 1\n").replace('tv[k]',
                                                               'grid[n]')


def _min_blocks(src, m):
    return src.replace('__launch_bounds__(TRACE_THREADS)',
                       f'__launch_bounds__(TRACE_THREADS, {m})')


def _spt(src, k):
    return src.replace('TRACE_SPT = 8;', f'TRACE_SPT = {k};')


VARIANTS = {
    'as_is': lambda s: s,
    'min4': lambda s: _min_blocks(s, 4),
    'rolled': _rolled,
    'rolled_min4': lambda s: _min_blocks(_rolled(s), 4),
    'rolled_min8': lambda s: _min_blocks(_rolled(s), 8),
    'spt4_min4': lambda s: _min_blocks(_spt(s, 4), 4),
}


def build_all():
    """Build every variant at once -> {variant: (ctypes library, its T1
    ptxas lines)}; raises if a build fails or an edit did not apply."""
    src = open(SOURCE).read()
    procs = {}
    for name, edit in VARIANTS.items():
        text = edit(src)
        if name != 'as_is' and text == src:
            raise RuntimeError(f"variant {name}: the edit did not apply")
        d = os.path.join(ROOT, 'build', 'ab_trace', name)
        shutil.rmtree(d, ignore_errors=True)
        os.makedirs(d)
        shutil.copytree(os.path.join(ROOT, 'waveforms_tpu_torch'),
                        os.path.join(d, 'waveforms_tpu_torch'),
                        ignore=shutil.ignore_patterns('__pycache__'))
        with open(os.path.join(d, 'waveforms_tpu_torch', 'csrc',
                               'trace_eval.cu'), 'w') as f:
            f.write(text)
        code = ("import sys; sys.path.insert(0, %r); "
                "from waveforms_tpu_torch import kernels; "
                "kernels.load_library(); "
                "print('LIB', kernels.library_path()); "
                "print(kernels.build_log)") % d
        procs[name] = subprocess.Popen(
            [sys.executable, '-c', code], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True, cwd=d)
    libs = {}
    for name, p in procs.items():
        out, _ = p.communicate()
        m = re.search(r'^LIB (\S+)$', out, re.M)
        if p.returncode != 0 or m is None:
            raise RuntimeError(f"variant {name} failed to build:\n"
                               f"{out[-4000:]}")
        lines = out.splitlines()
        ptxas = [ln.strip() for i, ln in enumerate(lines)
                 if i and 'trace_eval' in lines[i - 1]
                 and ('registers' in ln or 'spill' in ln)]
        lib = ctypes.CDLL(m.group(1))
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.wf_trace_eval.argtypes = [P, P, P, L, P, P, P, I, I, I, P]
        lib.wf_trace_eval.restype = I
        libs[name] = (lib, ptxas)
    return libs


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--record', help='write every line to this JSON file')
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch

    from waveforms_tpu_torch.ops import trace_tape
    from waveforms_tpu_torch.probes import cuda_ms, nvidia_smi
    from waveforms_tpu_torch.schedules import FS, STRATA
    if not torch.cuda.is_available():
        print("ab_trace: no CUDA device visible", file=sys.stderr)
        return 2
    records = []
    libs = build_all()
    for name, (_, ptxas) in libs.items():
        records.append({'variant': name, 'ptxas': ptxas})
        print(json.dumps(records[-1]), flush=True)
    ok = True
    for stratum, mode in (('flagship', 0), ('dense', 0), ('flagship', 2)):
        build, stop = STRATA[stratum]
        chans = build()
        grid = torch.from_numpy(np.arange(0.0, stop, 1 / FS)).to('cuda')
        tape = trace_tape.tape_of(tuple(trace_tape.channel_key(c)
                                        for c in chans))
        prog, pool = tape.tensors('cuda')
        dtype = torch.complex128 if mode == 2 else torch.float64
        rec = {'stratum': stratum, 'mode': mode, 'ms': {}, 'equal': {}}
        first = None
        for name in list(libs) + list(libs)[::-1]:
            lib = libs[name][0]
            out = torch.empty((len(chans), grid.shape[0]), dtype=dtype,
                              device='cuda')
            stream = torch.cuda.current_stream().cuda_stream

            def launch():
                code = lib.wf_trace_eval(
                    prog.data_ptr(), pool.data_ptr(), grid.data_ptr(),
                    grid.shape[0], None, None, out.data_ptr(), len(chans),
                    0, mode, stream)
                if code:
                    raise RuntimeError(f"{name}: CUDA error {code}")
            rec['ms'].setdefault(name, []).append(cuda_ms(launch, 11, 0.05))
            torch.cuda.synchronize()
            if first is None:
                first = out.clone()
            rec['equal'][name] = bool(torch.equal(out, first))
            ok = ok and rec['equal'][name]
            del out
        records.append(rec)
        print(json.dumps(rec), flush=True)
        del first, grid
        torch.cuda.empty_cache()
    smi = nvidia_smi()
    records.append({'nvidia_smi': smi})
    print(smi, flush=True)
    if args.record:
        os.makedirs(os.path.dirname(os.path.abspath(args.record)),
                    exist_ok=True)
        with open(args.record, 'w') as f:
            json.dump(records, f, indent=1)
    return 0 if ok else 1


if __name__ == '__main__':
    sys.exit(main())
