"""The JAX suite's cross-engine nets on the card.

The schedules of ``tests/test_fuzz_engines.py`` (every seed,
:func:`.schedules.fuzz_schedule`) and of ``tests/test_station_e2e.py``
(:func:`.schedules.build_station_schedule`) through every route of the
card: ``engine='auto'`` (the card's router, :data:`.ops.routes.CARD_RULE`)
and each forced kernel -- K1 ``'cuda-dense'``, K2 ``'cuda-panel'``, K7
``'cuda-sparse'``, K5 ``'cuda-stack'`` -- in f32 and int16, pair mode
(``part='complex'``) on the complex seeds, and the double tier
(``precision='double'``: ``'auto'`` and ``'cuda-dense'``, K3).

:func:`check` runs one (case, mode, engine) on a device and holds its
output against the plain version of the route it took (the same call on
the CPU, forced to that route) and the float64 oracle (``engine='numpy'``):
f32 and complex64 within :data:`TOL_PLAIN` of each channel's peak and
:data:`TOL_ORACLE` of the oracle, int16 within one code of both, float64
within :data:`TOL_PLAIN_HI` and :data:`TOL_ORACLE_HI` (a peak under 1e-3
counts as 1e-3, as the JAX fuzz file counts it).  The double tier's
oracle clips at the rails rounded to f32: its contract, in both packages,
applies clip rails at f32 precision (``docs/PRECISION.md``, "Double-f32
caveats"), which puts a clipped sample up to half an f32 ulp of the rail
off an oracle clipped in float64 (3e-8 of the peak on the clipped fuzz
channels).  A forced kernel that does
not take a schedule must refuse it (``UnsupportedFactor``) on the CPU too;
on a CUDA device the route's kernel must have launched.
``tests/test_torch_cuda_fuzz.py`` runs every check on the card,
``chip_smoke.py``'s ``cross_engine`` phase a handful.  Nothing here
imports JAX.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from . import kernels
from .core import Waveform, WaveVStack
from .engine import classify_route, synthesize
from .ops.hi_synth import (check_hi_schedule, classify_hi_route,
                           synthesize_hi_panels)
from .ops.lowering import UnsupportedFactor, lower_schedule
from .schedules import (FS, FUZZ_SEEDS, FUZZ_SPAN, STATION_SPAN,
                        build_station_schedule, fuzz_schedule)

__all__ = ['CASES', 'MODES', 'ENGINES', 'checks', 'check', 'TOL_PLAIN',
           'TOL_ORACLE', 'TOL_PLAIN_HI', 'TOL_ORACLE_HI', 'TOL_CODES']

TOL_PLAIN = 1e-6      # f32 and complex64 vs the plain version, of the peak
TOL_ORACLE = 2e-6     # ... vs the float64 oracle
TOL_PLAIN_HI = 1e-12  # the double tier vs its plain float64 version
TOL_ORACLE_HI = 1e-9  # ... vs the oracle
TOL_CODES = 1         # int16, vs either
PEAK_FLOOR = 1e-3

#: every fuzz seed, '<test><seed>' (``kernel0``: the JAX file's first
#: Pallas seed), and the station
CASES = tuple(f'{kind}{seed}' for kind, (_, n) in FUZZ_SEEDS.items()
              for seed in range(n)) + ('station',)
MODES = ('float32', 'int16', 'complex64', 'float64')
FORCED = {'dense': 'cuda-dense', 'panel': 'cuda-panel',
          'sparse': 'cuda-sparse', 'stack': 'cuda-stack'}
#: the engines of each mode
ENGINES = {'float32': ('auto', *FORCED.values()),
           'int16': ('auto', *FORCED.values()),
           'complex64': ('auto', 'cuda-dense', 'cuda-panel', 'cuda-sparse'),
           'float64': ('auto', 'cuda-dense')}
#: the kernel of a route, by mode
KERNEL = {'dense': 'synth_dense', 'panel': 'synth_panel',
          'sparse': 'synth_sparse', 'stack': 'synth_stack'}
KERNEL_HI = {'dense': 'synth_dense_hi', 'panel': 'synth_panel_hi'}


@lru_cache(maxsize=None)
def schedule(case):
    """A case's (channels, bucket_samples, part, stop)."""
    if case == 'station':
        chans = build_station_schedule()
        return [chans[n] for n in sorted(chans)], 'auto', 'real', STATION_SPAN
    kind = case.rstrip('0123456789')
    chans, bucket = fuzz_schedule(kind, int(case[len(kind):]))
    return (chans, bucket, 'complex' if kind == 'complex' else 'real',
            FUZZ_SPAN)


def checks(cases=CASES):
    """Every (case, mode, engine) of ``cases``: pair mode on the complex
    seeds, f32, int16 and the double tier on the others."""
    out = []
    for case in cases:
        modes = (('complex64',) if schedule(case)[2] == 'complex'
                 else ('float32', 'int16', 'float64'))
        out += [(case, mode, eng) for mode in modes for eng in ENGINES[mode]]
    return out


def _kw(case, mode):
    _, bucket, part, _ = schedule(case)
    kw = {'bucket_samples': bucket, 'part': part}
    if mode == 'int16':
        kw['out_dtype'] = torch.int16
    if mode == 'float64':
        kw['precision'] = 'double'
    return kw


def f32_rails(w):
    """A copy of ``w`` clipped at its rails rounded to f32 (a WaveVStack,
    which the lowering does not clip, as it is)."""
    if isinstance(w, WaveVStack) or not isinstance(w, Waveform):
        return w
    w = Waveform.fromlist(w.tolist())
    w.max, w.min = (float(np.float32(v)) for v in (w.max, w.min))
    return w


@lru_cache(maxsize=None)
def oracle(case, mode):
    chans, _, part, stop = schedule(case)
    if mode == 'float64':
        chans = [f32_rails(w) for w in chans]
    return np.asarray(synthesize(
        chans, 0.0, stop, FS, engine='numpy', part=part,
        out_dtype=torch.int16 if mode == 'int16' else None))


def route(case, mode, engine, device):
    """The route a call takes on ``device`` (the routers' own answer):
    'dense', 'panel', 'sparse' or 'stack'; 'oracle' where ``'auto'``
    sends the double tier to the oracle; None where the engine refuses
    the schedule."""
    chans, bucket, part, stop = schedule(case)
    low = lower_schedule(chans, 0.0, stop, FS, part=part,
                         bucket_samples=bucket, keep_f64=mode == 'float64')
    try:
        if mode == 'float64':
            check_hi_schedule(low)
            return ('dense' if engine == 'cuda-dense'
                    else classify_hi_route(low, device)[0])
        force = {v: k for k, v in FORCED.items()}.get(engine)
        return classify_route(low, force=force,
                              out_dtype=_kw(case, mode).get('out_dtype'),
                              device=device)[0]
    except UnsupportedFactor:
        return 'oracle' if mode == 'float64' and engine == 'auto' else None


def _host(out):
    out = out.cpu().numpy() if isinstance(out, torch.Tensor) else out
    return np.asarray(out)


def _rel(a, b):
    a, b = _host(a), _host(b)
    peak = np.maximum(np.abs(b).max(axis=-1), PEAK_FLOOR)
    return float((np.abs(a - b).max(axis=-1) / peak).max())


def _codes(a, b):
    return int(np.abs(_host(a).astype(np.int64)
                      - _host(b).astype(np.int64)).max())


def check(case, mode, engine, device='cuda') -> dict:
    """One call on ``device`` against its route's plain version and the
    oracle -> a record: the route, the kernels it launched (on a CUDA
    device), ``vs_plain``, ``vs_oracle``, ``refused`` and ``ok``."""
    chans, _, _, stop = schedule(case)
    kw = _kw(case, mode)
    rec = {'case': case, 'mode': mode, 'engine': engine,
           'route': route(case, mode, engine, device)}
    before = kernels.launch_counts()
    try:
        out = synthesize(chans, 0.0, stop, FS, engine=engine, device=device,
                         **kw)
    except UnsupportedFactor as exc:
        rec['refused'] = str(exc)
        try:
            synthesize(chans, 0.0, stop, FS, engine=engine, device='cpu',
                       **kw)
            rec['ok'] = False       # the plain version takes it
        except UnsupportedFactor:
            rec['ok'] = rec['route'] is None
        return rec
    if torch.device(device).type == 'cuda':
        torch.cuda.synchronize()
    after = kernels.launch_counts()
    rec['launched'] = {k: after[k] - before[k] for k in after
                       if after[k] > before[k]}
    ora = oracle(case, mode)
    if rec['route'] == 'oracle':
        plain = ora
    elif mode == 'float64' and rec['route'] == 'panel':
        _, bucket, part, _ = schedule(case)
        plain = synthesize_hi_panels(lower_schedule(
            chans, 0.0, stop, FS, part=part, bucket_samples=bucket,
            keep_f64=True), device='cpu')
    else:
        plain = synthesize(chans, 0.0, stop, FS, device='cpu',
                           engine=FORCED.get(rec['route'], engine), **kw)
    if mode == 'int16':
        rec['vs_plain'], rec['vs_oracle'] = _codes(out, plain), _codes(
            out, ora)
        tols = (TOL_CODES, TOL_CODES)
    else:
        rec['vs_plain'], rec['vs_oracle'] = _rel(out, plain), _rel(out, ora)
        tols = ((TOL_PLAIN_HI, TOL_ORACLE_HI) if mode == 'float64'
                else (TOL_PLAIN, TOL_ORACLE))
    dtype = (str(out.dtype).replace('torch.', '')
             if isinstance(out, torch.Tensor) else None)
    rec['ok'] = bool(
        rec['route'] is not None and dtype == mode
        and tuple(out.shape) == ora.shape
        and np.isfinite(_host(out).astype(np.complex128)).all()
        and rec['vs_plain'] <= tols[0] and rec['vs_oracle'] <= tols[1])
    if torch.device(device).type == 'cuda' and rec['route'] != 'oracle':
        table = KERNEL_HI if mode == 'float64' else KERNEL
        rec['ok'] = rec['ok'] and table[rec['route']] in rec['launched']
    return rec
