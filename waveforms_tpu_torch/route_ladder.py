"""The synthesis routers' occupancy ladder on the card.

    python -m waveforms_tpu_torch.route_ladder [--record PATH]

The port's counterpart of ``tools/tpu_capture.py``'s ``task_occ_ladder``
(the panel kernel against the dense kernel a rung) and
``task_occ_ladder_stack`` (the stack kernel on the same rungs), whose
crossovers fixed the JAX router's thresholds.  The rungs are the capture's
ladder, 128 channels over 524.288 us at 2 GS/s (1,048,576 samples a
channel) with ``n_pulses`` 200 ns mixed pulses a channel
(:func:`.schedules.build_ladder_schedule`), for each of
:data:`RUNG_PULSES`; beside them the mid, flagship and dense strata
(the dense one at occupancy 1), and three short windows for the
``small`` rule: one ``seq_station`` schedule (2 channels x 200,000
samples), the flagship's first 16,384 samples, and ``midband``, the
stack route's many-pulse short window of the test suite (2 channels of
120 pulses over 100 us, seed 17).

At each rung every route that takes the schedule -- the dense (K1), panel
(K2), worklist (K7, with the zero fill it stores over) and stack (K5, with
its dense residual) kernels, each as its forced engine plans it -- runs on
inputs uploaded once and is timed (:func:`.probes.cuda_ms`), in f32, in
int16 DAC codes and in pair mode (``part='complex'``, complex64; no stack
route); then the double tier, K3 and, where it takes the
schedule, K4 (one bucket only).  The ladder's rungs lower to 32 buckets
under ``bucket_samples='auto'``, where the double tier's route is K3, so
the double tier is raced on the rungs lowered with one bucket too
(``float64`` ``one_bucket``).  Every output at a rung is held against the
others (f32 and complex64 within 1e-6 of the channel's peak, int16
within one code, f64 within 1e-12) and against the float64 oracle on 2
channels (2e-6, one code, 1e-9).  Each rung's record gives its occupancy (the live-subtile
fraction, and padded to the TPU dense grid's tiles as the JAX router reads
it), ``small``, ``pallas_ok``, the stack plan's advantage and narrow
instances, each route's ms, and the route each rule takes: the JAX
package's (``jax``) and the card's (``card``, :data:`.ops.routes.
CARD_RULE`).  A route's cost is its device time, and for the stack route
also its plan's host time (``build_stack_plan``, 0.1-2 s) where the card's
router would not build the plan anyway (below its stack floor): the
fastest route is the cheapest, and the kernel alone is recorded beside it
(``fastest_kernel``).  The run's checks are the outputs'; its criteria,
recorded and in the exit code, are that the card's route on every rung
costs at most :data:`ROUTE_SLACK` times the cheapest route's, and that the
card's routes summed over the rungs take no longer than the JAX rule's,
in each output type (device ms).

Prints one JSON line per rung and a summary line; exits 1 on a failed
check or criterion.  ``chip_smoke.py`` runs the same ladder as its
``route_ladder`` phase, and fails on a failed check only.
``device='cpu'`` (:func:`run`) runs the plain versions with the same
checks and no times.
"""

from __future__ import annotations

import argparse
import json
import multiprocessing
import sys
import time
from concurrent.futures import ProcessPoolExecutor
from contextlib import contextmanager
from functools import partial

import numpy as np
import torch

from . import engine, kernels
from .engine import _quantize_host, classify_route, synthesize
from .ops.hi_synth import HiSchedule, classify_hi_route
from .ops.lowering import UnsupportedFactor, lower_schedule
from .ops.routes import CARD_RULE, facts, padded_occupancy, stack_first
from .ops.sparse_synth import (PanelWork, SparseWork, build_panel_plan,
                               build_sparse_plan)
from .ops.stack_synth import build_stack_plan, build_stack_tables
from .ops.synth import DeviceSchedule, resolve_device, validate_out_mode
from .probes import cuda_ms, nvidia_smi
from .schedules import (FS, build_dense_schedule, build_ladder_schedule,
                        build_mid_schedule, build_schedule, station_channels)

__all__ = ['RUNG_PULSES', 'RUNGS', 'sources', 'run', 'measure_rung',
           'ROUTE_SLACK']

RUNG_PULSES = (5, 10, 25, 60, 120, 200, 300)
LADDER_STOP = 524.288e-6
#: rung -> (the schedule it runs, :func:`sources`' key; its stop in s; its
#: first channels, or None for all)
RUNGS = {**{f'ladder{n}': (f'ladder{n}', LADDER_STOP, None)
            for n in RUNG_PULSES},
         'mid': ('mid', 524.288e-6, None),
         'flagship': ('flagship', 1e-3, None),
         'dense': ('dense', 1e-3, None), 'station': ('station', 1e-4, None),
         'flagship_16k': ('flagship', 16384 / FS, None),
         'midband': ('midband', 100e-6, None)}
KINDS = ('dense', 'panel', 'sparse', 'stack')
DTYPES = {'float32': torch.float32, 'int16': torch.int16,
          'complex64': torch.float32}      # pair mode: f32 accumulation
TOL = {'float32': 1e-6, 'complex64': 1e-6, 'int16': 1, 'float64': 1e-12}
TOL_ORACLE = {'float32': 2e-6, 'complex64': 2e-6, 'int16': 1,
              'float64': 1e-9}
OUT_TYPES = ('float32', 'int16', 'complex64', 'float64')
ORACLE_CHANNELS = 2
#: the card's route may cost this much more than the rung's cheapest
ROUTE_SLACK = 1.10


def station_schedule():
    """The first of ``seq_station``'s 16 gate-train schedules (2 channels
    over 100 us)."""
    return station_channels()[0]


def sources(n_channels=128) -> dict:
    """The rungs' schedules: key -> a builder (picklable, no arguments)."""
    out = {f'ladder{n}': partial(build_ladder_schedule, n, n_channels)
           for n in RUNG_PULSES}
    out.update(mid=partial(build_mid_schedule, n_channels),
               flagship=partial(build_schedule, n_channels),
               dense=partial(build_dense_schedule, n_channels),
               station=station_schedule,
               midband=partial(build_ladder_schedule, 120, 2, 100e-6,
                               seed=17))
    return out


def build_sources(keys, n_channels=128, workers=8) -> dict:
    """Build the schedules of ``keys`` in spawned worker processes (the
    waveform algebra in Python, ~12 s for ladder300) -> key -> channels."""
    builders = sources(n_channels)
    with ProcessPoolExecutor(
            max_workers=min(workers, len(keys)),
            mp_context=multiprocessing.get_context('spawn')) as pool:
        futures = {k: pool.submit(builders[k]) for k in keys}
        return {k: f.result() for k, f in futures.items()}


def rel_err(a, b):
    """Max over channels of max|a - b| / max|b| (on ``b``'s device;
    complex values by modulus)."""
    dt = (torch.complex128 if a.is_complex() or b.is_complex()
          else torch.float64)
    a = a.to(dt)
    b = b.to(dt)
    peak = b.abs().amax(dim=-1).clamp_min(1e-30)
    return float(((a - b).abs().amax(dim=-1) / peak).max())


def code_err(a, b):
    return int((a.to(torch.int32) - b.to(torch.int32)).abs().max())


def worst_pair(outs, dname):
    """The largest disagreement between any two routes' outputs."""
    err = code_err if dname == 'int16' else rel_err
    names = list(outs)
    return max((err(outs[x], outs[y]) for i, x in enumerate(names)
                for y in names[i + 1:]), default=0)


@contextmanager
def planned(low, plan):
    """The routers' ``build_stack_plan`` answering ``plan`` for ``low``
    (the plan is O(instances): seconds for the upper rungs)."""
    orig = engine.build_stack_plan
    engine.build_stack_plan = lambda l: plan if l is low else orig(l)
    try:
        yield
    finally:
        engine.build_stack_plan = orig


def route_runs(low, dt, device, dev):
    """kind -> (run, out) for each route whose forced engine takes ``low``
    in ``dt``: the device work of ``synthesize`` on that route, on inputs
    uploaded once (the worklist route's zero fill and the stack route's
    residual included); ``run()`` leaves the output in ``out``."""
    C = low.shape[0]
    out_dt, scale = validate_out_mode(dt, C, 32767.0, device,
                                      pair=low.amp_im is not None)
    runs = {}
    for kind in KINDS:
        try:
            _, plan = classify_route(low, force=kind, out_dtype=dt)
        except UnsupportedFactor:
            continue
        if kind == 'dense':
            out = torch.empty((C, low.n_samples), dtype=out_dt,
                              device=device)
            run = partial(kernels.synth_dense, dev, out, scale)
        elif kind == 'panel':
            out = torch.empty((C, plan.window_samples), dtype=out_dt,
                              device=device)
            run = partial(kernels.synth_panel, dev,
                          PanelWork.upload(plan, device), out, scale)
        elif kind == 'sparse':
            out = torch.empty((C, plan.window_samples), dtype=out_dt,
                              device=device)
            work = SparseWork.upload(plan, device)

            def run(out=out, work=work):
                kernels.synth_sparse(dev, work, out.zero_(), scale)
        else:
            out = torch.empty((C, low.n_samples), dtype=out_dt,
                              device=device)
            tables = build_stack_tables(plan, low, device)
            if plan.wide is None:
                run = partial(kernels.synth_stack, tables, out, scale)
            else:
                # the f32 sum, then the store: synthesize_stack's residual
                wide = DeviceSchedule(plan.wide, device)
                acc = torch.empty((C, low.n_samples), dtype=torch.float32,
                                  device=device)

                def run(out=out, acc=acc, tables=tables, wide=wide):
                    kernels.synth_stack(tables, acc, None)
                    acc += kernels.synth_dense(wide, torch.empty_like(acc),
                                               None)
                    if out_dt == torch.int16:
                        out.copy_(torch.clamp(torch.round(
                            acc * scale[:, None]), -32768.0, 32767.0))
                    else:
                        out.copy_(acc)
        runs[kind] = (run, out)
    return runs


def hi_runs(low, device):
    """The double tier's routes on a ``keep_f64`` lowering: kind -> (run,
    out), K3 ('dense') always, K4 ('panel') on one bucket."""
    dev = HiSchedule(low, device)
    C = low.shape[0]
    out = torch.empty((C, low.n_samples), dtype=torch.float64, device=device)
    runs = {'dense': (partial(kernels.synth_dense_hi, dev, out, None), out)}
    if low.shape[1] == 1:
        plan = build_panel_plan(low)
        pout = torch.empty((C, plan.window_samples), dtype=torch.float64,
                           device=device)
        runs['panel'] = (partial(kernels.synth_panel_hi, dev,
                                 PanelWork.upload(plan, device), pout, None),
                         pout)
    return runs


def race(runs, dname, oracle, timed):
    """Run every route once, hold the outputs against each other and the
    oracle's channels, and time each -> record."""
    outs = {}
    for kind, (run, out) in runs.items():
        run()
        outs[kind] = out
    rec = {'vs_others': worst_pair(outs, dname)}
    sel = oracle['channels']
    want = oracle[dname]
    err = code_err if dname == 'int16' else rel_err
    rec['vs_oracle'] = max(err(o[sel].cpu(), want) for o in outs.values())
    rec['ok'] = (rec['vs_others'] <= TOL[dname]
                 and rec['vs_oracle'] <= TOL_ORACLE[dname])
    if timed:
        rec['ms'] = {kind: cuda_ms(run) for kind, (run, _) in runs.items()}
        rec['fastest'] = min(rec['ms'], key=rec['ms'].get)
    return rec


def hi_race(low, oracle, device, timed):
    """The double tier's race on a ``keep_f64`` lowering -> its record."""
    rec = race(hi_runs(low, device), 'float64', oracle, timed)
    rec.update(buckets=int(low.shape[1]),
               occupancy=build_sparse_plan(low).occupied_fraction,
               route={rule: classify_hi_route(low, rdev)[0]
                      for rule, rdev in (('jax', None), ('card', 'cuda'))})
    if timed:
        judge(rec)
    return rec


def judge(rec, plan_ms=0.0):
    """The card's route against the rung's cheapest route: each route's
    device ms, the stack route's plus ``plan_ms`` (its plan's host time
    where the card's router would not build it otherwise)."""
    ms = rec['ms']
    cost = {k: v + plan_ms * (k == 'stack') for k, v in ms.items()}
    card = rec['route']['card']
    rec['fastest_kernel'] = rec.pop('fastest')
    rec['fastest'] = min(cost, key=cost.get)
    rec['card_vs_fastest'] = cost[card] / cost[rec['fastest']]
    rec['card_vs_fastest_kernel'] = ms[card] / ms[rec['fastest_kernel']]
    rec['card_ok'] = rec['card_vs_fastest'] <= ROUTE_SLACK


def measure_rung(name, chans, stop, device='cuda'):
    """One rung -> its record (module docstring)."""
    device = resolve_device(device)
    timed = device.type == 'cuda'
    host = {}
    t0 = time.perf_counter()
    low = lower_schedule(chans, 0.0, stop, FS)
    host['lower'] = time.perf_counter() - t0
    C = low.shape[0]
    sp = build_sparse_plan(low)
    occ_padded, small = padded_occupancy(low, sp)
    t0 = time.perf_counter()
    splan = build_stack_plan(low)
    host['build_stack_plan'] = time.perf_counter() - t0
    # whether the card's router builds the stack plan to decide
    card_plans = stack_first(*facts(low, sp, CARD_RULE))
    plan_ms = 0.0 if card_plans else host['build_stack_plan'] * 1e3
    rec = {'phase': 'route_ladder', 'rung': name, 'channels': C,
           'samples': int(low.n_samples), 'shape': [int(v) for v in
                                                    low.shape],
           'occupancy': sp.occupied_fraction,
           'padded_occupancy': occ_padded, 'small': small,
           'pallas_ok': bool(low.pallas_ok),
           'advantage': None if splan is None else splan.advantage,
           'n_narrow': 0 if splan is None else splan.n_narrow,
           'wide_residual': splan is not None and splan.wide is not None,
           'card_plans_stack': card_plans}
    sel = sorted({0, C - 1})[:ORACLE_CHANNELS]
    t0 = time.perf_counter()
    ora = synthesize([chans[c] for c in sel], 0.0, stop, FS, engine='numpy')
    oracle = {'channels': sel, 'float32': torch.from_numpy(ora),
              'float64': torch.from_numpy(ora),
              'int16': torch.from_numpy(_quantize_host(ora, np.int16,
                                                       32767.0)),
              'complex64': torch.from_numpy(synthesize(
                  [chans[c] for c in sel], 0.0, stop, FS, engine='numpy',
                  part='complex'))}
    host['oracle'] = time.perf_counter() - t0
    t0 = time.perf_counter()
    low_pair = lower_schedule(chans, 0.0, stop, FS, part='complex')
    host['lower_pair'] = time.perf_counter() - t0
    for dname, dt in DTYPES.items():
        lw = low_pair if dname == 'complex64' else low
        dev = DeviceSchedule(lw, device)
        with planned(low, splan):
            routes = {rule: classify_route(lw, out_dtype=dt,
                                           device=rdev)[0]
                      for rule, rdev in (('jax', None), ('card', 'cuda'))}
            runs = route_runs(lw, dt, device, dev)
        rec[dname] = dict(race(runs, dname, oracle, timed), route=routes)
        if timed:
            judge(rec[dname], plan_ms)
        del runs, dev
    # the double tier: under 'auto' buckets (its route) and on one bucket
    t0 = time.perf_counter()
    low_hi = lower_schedule(chans, 0.0, stop, FS, keep_f64=True)
    host['lower_hi'] = time.perf_counter() - t0
    hi = hi_race(low_hi, oracle, device, timed)
    if low_hi.shape[1] > 1:
        t0 = time.perf_counter()
        low_hi = lower_schedule(chans, 0.0, stop, FS, keep_f64=True,
                                bucket_samples=None)
        host['lower_hi_one_bucket'] = time.perf_counter() - t0
        hi['one_bucket'] = hi_race(low_hi, oracle, device, timed)
    else:                   # 'auto' lowered it to one bucket already
        hi['one_bucket'] = dict(hi)
    rec['float64'] = hi
    rec['host_s'] = host
    parts = [rec[d] for d in OUT_TYPES] + [hi['one_bucket']]
    rec['ok'] = all(r['ok'] for r in parts)
    rec['card_ok'] = all(r.get('card_ok', True) for r in parts)
    return rec


def summarize(records):
    """The ladder's totals: each rule's routes' device ms summed over the
    rungs, per output type -> the summary record (``ok``: the checks;
    ``criteria_ok``: the card's route on every rung and the sums)."""
    out = {'phase': 'route_ladder_summary', 'rungs': len(records),
           'ok': all(r['ok'] for r in records)}
    crit = all(r['card_ok'] for r in records)
    for dname in OUT_TYPES:
        recs = [r[dname] for r in records if 'ms' in r[dname]]
        if not recs:
            continue
        tot = {rule: sum(r['ms'][r['route'][rule]] for r in recs)
               for rule in ('jax', 'card')}
        tot['fastest_kernel'] = sum(r['ms'][r['fastest_kernel']]
                                    for r in recs)
        out[dname] = dict(tot, card_vs_jax=tot['card'] / tot['jax'],
                          worst_card_vs_fastest=max(
                              r['card_vs_fastest'] for r in recs))
        crit = crit and tot['card'] <= tot['jax']
    out['criteria_ok'] = crit
    return out


def brief(rec):
    """A rung's printed line: its facts, and for each output type its
    routes' ms (to 0.1 us), the JAX rule's route and the card's."""
    line = {'phase': 'route_ladder', 'rung': rec['rung'], 'ok': rec['ok'],
            'card_ok': rec['card_ok'], 'occ': round(rec['occupancy'], 4), 'C': rec['channels'],
            'n': rec['samples']}
    for dname in OUT_TYPES:
        r = rec[dname]
        line[dname] = [{k: round(v, 4) for k, v in r.get('ms', {}).items()},
                       r['route']['jax'], r['route']['card']]
    r = rec['float64']['one_bucket']
    line['float64_one_bucket'] = [
        {k: round(v, 4) for k, v in r.get('ms', {}).items()},
        r['route']['jax'], r['route']['card']]
    return line


def _print(record, line):
    print(json.dumps(line), flush=True)


def run(schedules, device='cuda', log=_print):
    """Measure every rung of ``schedules`` (source key -> channels, as
    :func:`build_sources` makes them) -> (records, summary); ``log(record,
    line)`` takes each rung's record and its brief line, then the
    summary's."""
    records = []
    for name, (key, stop, width) in RUNGS.items():
        rec = measure_rung(name, schedules[key][:width], stop, device)
        records.append(rec)
        log(rec, brief(rec))
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
    summary = summarize(records)
    log(summary, summary)
    return records, summary


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--record', help="write every rung's record to this "
                    "JSON file")
    args = ap.parse_args(argv)
    print(nvidia_smi(), flush=True)
    t0 = time.perf_counter()
    schedules = build_sources(sorted({k for k, _, _ in RUNGS.values()}))
    print(json.dumps({'phase': 'build_schedules',
                      'seconds': time.perf_counter() - t0}), flush=True)
    records, summary = run(schedules)
    if args.record:
        with open(args.record, 'w') as f:
            json.dump(records + [summary], f, indent=1)
    return 0 if summary['ok'] and summary['criteria_ok'] else 1


if __name__ == '__main__':
    sys.exit(main())
