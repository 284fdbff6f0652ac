"""The measurement probes P1-P4 on the card.

The port's counterpart of ``tools/tpu_capture.py``'s
``task_sparse_step_cost_probe`` (P1), ``task_grid_overhead_probe`` (P2),
``task_walker_cost_probe`` (P3) and the health probe of its ``main`` (P4),
on the kernels of ``csrc/probes.cu`` and the worklist kernel (K7).  The
inputs are the JAX tasks' own: the same seeds, sizes and tables, made with
numpy.

    python -m waveforms_tpu_torch.probes

prints one JSON line per probe, the health probe first (and exits 1 if it
fails).

Times are CUDA-event medians of 11 calls after at least 50 ms of warm-up,
each result with the card's ``nvidia-smi`` name and power limit.  On the
GPU the thread blocks of one launch run at the same time on 132 SMs, where
the TPU's grid steps run one after another: a time per block here is a
throughput (kernel time / K), not the latency of one block.

Every probe function defaults to ``device='cuda'`` and raises without a
GPU; ``device='cpu'`` runs the plain versions and returns their outputs
(under ``'outputs'``), with no times.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from . import kernels
from .ops.lowering import lower_schedule
from .ops.reference_probes import WALKER_BODIES
from .ops.sparse_synth import SparseWork, build_sparse_plan
from .ops.synth import DeviceSchedule, resolve_device
from .schedules import FS, build_schedule

__all__ = ['health_probe', 'sparse_step_cost_probe', 'grid_overhead_probe',
           'walker_cost_probe', 'grid_inputs', 'walker_inputs',
           'sparse_inputs', 'GRID_VARIANTS', 'cuda_ms', 'nvidia_smi']

RS = 32                  # subtile rows: one output block is RS x 128 f32
GRID_K, GRID_L, GRID_C, GRID_TABLES = 4096, 64, 128, 13
WALKER_K, WALKER_L, WALKER_C = 2048, 128, 8
SPARSE_CHANNELS, SPARSE_STOP = 128, 524.288e-6
PAD = 4                  # P1's padded worklist: PAD x K items
QUEUE_CYCLES = 2_000_000  # the card's least sleep before a timed run, ~1 ms
MAX_QUEUE_MS = 50.0       # its longest: a slower enqueue is timed unqueued

#: P2's variants: (operands touched, dynamic index map, dynamic output map)
GRID_VARIANTS = {'op13_dyn_dynout': (13, True, True),
                 'op13_dyn': (13, True, False),
                 'op2_dyn': (2, True, False),
                 'op13_static': (13, False, False),
                 'op2_static': (2, False, False)}


#: what :func:`cuda_ms` met in this process: runs timed behind the card's
#: sleep, runs redone because the sleep ended before the host had queued
#: them, the longest host enqueue (start event, ``fn``, end event) of a
#: kept run and its least margin (sleep minus enqueue), in ms, and the
#: host enqueue in ms of each call timed unqueued (a function that waits
#: on the card, or takes longer to queue than a sleep may last)
QUEUE = {'runs': 0, 'redone': 0, 'max_enqueue_ms': 0.0,
         'min_margin_ms': None, 'unqueued_enqueue_ms': []}
_SLEEP = {}      # cycles per ms of torch.cuda._sleep, measured once


def _sleep_cycles_per_ms():
    if not _SLEEP:
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(QUEUE_CYCLES)
        a.record()
        torch.cuda._sleep(QUEUE_CYCLES)
        b.record()
        b.synchronize()
        _SLEEP['per_ms'] = QUEUE_CYCLES / a.elapsed_time(b)
    return _SLEEP['per_ms']


def cuda_ms(fn, reps=11, warm_s=0.05, queued=True):
    """Median device time of ``fn`` in ms over ``reps`` runs (CUDA events),
    after warming up for at least ``warm_s`` seconds: the card lowers its
    clocks while the host works alone.

    ``queued``: before each timed run the card sleeps
    (``torch.cuda._sleep``) for twice the host's enqueue time of the last
    warm-up run, and at least :data:`QUEUE_CYCLES`, while the host
    enqueues the start event, ``fn``'s launches and the end event, so the
    events time the device's work and not the host's launch path (tens of
    µs through the ctypes wrappers, more than a short kernel's run).  A
    run whose start event has already passed when the host has queued the
    end event included host gaps: it is redone with the sleep doubled.
    After three such runs, or where the sleep would pass
    :data:`MAX_QUEUE_MS`, the call is timed unqueued; :data:`QUEUE`
    records all of it.  ``queued=False`` times what a caller on an idle
    card sees: the launch path and the kernel."""
    t0 = time.perf_counter()
    while True:
        t1 = time.perf_counter()
        fn()
        enqueue_ms = (time.perf_counter() - t1) * 1e3
        torch.cuda.synchronize()
        if time.perf_counter() - t0 >= warm_s:
            break
    if queued:
        per_ms = _sleep_cycles_per_ms()
        sleep_ms = max(QUEUE_CYCLES / per_ms, 2 * enqueue_ms)
    times, redone = [], 0
    while len(times) < reps:
        if queued and (redone == 3 or sleep_ms > MAX_QUEUE_MS):
            QUEUE['unqueued_enqueue_ms'].append(enqueue_ms)
            queued, times = False, []
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        if queued:
            torch.cuda._sleep(int(sleep_ms * per_ms))
        t1 = time.perf_counter()
        a.record()
        fn()
        b.record()
        run_ms = (time.perf_counter() - t1) * 1e3
        late = queued and a.query()
        b.synchronize()
        if late:
            QUEUE['redone'] += 1
            redone += 1
            sleep_ms *= 2
            continue
        if queued:
            QUEUE['runs'] += 1
            QUEUE['max_enqueue_ms'] = max(QUEUE['max_enqueue_ms'], run_ms)
            margin = sleep_ms - run_ms
            if QUEUE['min_margin_ms'] is None or margin < QUEUE[
                    'min_margin_ms']:
                QUEUE['min_margin_ms'] = margin
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def nvidia_smi() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    try:
        lines = subprocess.run(
            ['nvidia-smi', '--query-gpu=name,power.limit',
             '--format=csv,noheader'], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi unavailable: {exc}"
    return lines[0] if lines else 'nvidia-smi gave nothing'


def _card(device):
    return {'device': torch.cuda.get_device_name(device),
            'nvidia_smi': nvidia_smi(), 'queue': dict(QUEUE)}


def health_probe(device='cuda') -> dict:
    """P4: ``2 * x`` over an (8, 128) f32 block of ones, checked to be 2
    everywhere (and a sum of ``arange(1024)`` on the device, as the TPU
    probe checks its runtime).  On the card also the kernel's time
    (``ms``) and the time of a call on an idle card (``launch_ms``: the
    wrapper's launch path and the kernel)."""
    device = resolve_device(device)
    x = torch.ones((8, 128), dtype=torch.float32, device=device)
    y = torch.empty_like(x)
    kernels.probe_health(x, y)
    arange_sum = float(torch.arange(1024.0, device=device).sum())
    res = {'probe': 'health', 'value': float(y[0, 0]),
           'ok': bool((y == 2.0).all()) and arange_sum == 523776.0}
    if device.type == 'cpu':
        res['outputs'] = {'y': y}
        return res
    res['ms'] = cuda_ms(lambda: kernels.probe_health(x, y))
    res['launch_ms'] = cuda_ms(lambda: kernels.probe_health(x, y),
                               queued=False)
    return dict(res, **_card(device))


def grid_inputs(K=GRID_K, device='cuda') -> dict:
    """P2's inputs: ``wc`` in [0, 128) from ``default_rng(0)``, ``wo =
    arange(K) % 256``, 13 tables (128, 1, 64) f32 holding their index."""
    device = resolve_device(device)
    rng = np.random.default_rng(0)
    wc = rng.integers(0, GRID_C, K).astype(np.int32)
    wo = (np.arange(K) % 256).astype(np.int32)
    return {'tables': [torch.full((GRID_C, 1, GRID_L), float(i),
                                  device=device) for i in range(GRID_TABLES)],
            'wc': torch.from_numpy(wc).to(device),
            'wo': torch.from_numpy(wo).to(device)}


def grid_out(variant, inp):
    """A zeroed output for a P2 variant: 256 blocks under the dynamic
    output map, else one per step."""
    K = inp['wc'].shape[0]
    n_blocks = 256 if GRID_VARIANTS[variant][2] else K
    return torch.zeros((n_blocks, RS, 128), device=inp['wc'].device)


def run_grid(variant, inp, out, kern=None):
    """One P2 launch (or, with ``kern=kernels.probe_grid.plain``, its
    plain version) of ``variant`` into ``out``."""
    kern = kern or kernels.probe_grid
    return kern(inp['tables'], inp['wc'], inp['wo'], *GRID_VARIANTS[variant],
                out)


def grid_overhead_probe(device='cuda', K=GRID_K) -> dict:
    """P2: µs per block of each variant (:data:`GRID_VARIANTS`) over ``K``
    steps of a trivial body that sums one value of each touched table and
    fills one RS x 128 block."""
    device = resolve_device(device)
    inp = grid_inputs(K, device)
    res = {'probe': 'grid_overhead', 'K': K}
    outs = {}
    for name in GRID_VARIANTS:
        out = grid_out(name, inp)
        run_grid(name, inp, out)
        if device.type == 'cpu':
            outs[name] = out
        else:
            res[name] = cuda_ms(lambda: run_grid(name, inp, out)) * 1e3 / K
    if device.type == 'cpu':
        return dict(res, outputs=outs)
    return dict(res, **_card(device))


def walker_inputs(K=WALKER_K, device='cuda') -> dict:
    """P3's inputs, drawn in the JAX task's order from ``default_rng(0)``:
    ``wc`` in [0, 8), an f table (8, 1, 128) f32 N(0, 1) and an i table
    (8, 1, 128) int32 in {0, 1, 2}."""
    device = resolve_device(device)
    rng = np.random.default_rng(0)
    wc = rng.integers(0, WALKER_C, K).astype(np.int32)
    ftab = rng.standard_normal((WALKER_C, 1, WALKER_L)).astype(np.float32)
    itab = rng.integers(0, 3, (WALKER_C, 1, WALKER_L)).astype(np.int32)
    return {name: torch.from_numpy(a).to(device)
            for name, a in (('wc', wc), ('ftab', ftab), ('itab', itab))}


def run_walker(body, inp, out, kern=None):
    kern = kern or kernels.probe_walker
    return kern(body, inp['wc'], inp['ftab'], inp['itab'], out)


def walker_cost_probe(device='cuda', K=WALKER_K) -> dict:
    """P3: µs per block of each walker body over ``K`` steps, and
    ``ns_per`` = (body - base) / repetitions, per construct."""
    device = resolve_device(device)
    inp = walker_inputs(K, device)
    res = {'probe': 'walker_cost', 'K': K}
    outs = {}
    for body, _ in WALKER_BODIES:
        out = torch.zeros((K, RS, 128), device=device)
        run_walker(body, inp, out)
        if device.type == 'cpu':
            outs[body] = out
        else:
            res[body] = cuda_ms(lambda: run_walker(body, inp, out)) * 1e3 / K
    if device.type == 'cpu':
        return dict(res, outputs=outs)
    res['ns_per'] = {body: (res[body] - res['base']) / reps * 1e3
                     for body, reps in WALKER_BODIES[1:]}
    return dict(res, **_card(device))


def pad_work(work: SparseWork, padx=PAD) -> SparseWork:
    """``work`` padded to ``padx`` times its length as the TPU probe pads
    it: the extra items have ``work_t = work_o = n_tiles`` (the worklist
    kernel returns at once on them) and zeros elsewhere."""
    K = work.work_c.shape[0]
    n = K * (padx - 1)

    def cat(t, fill):
        return torch.cat([t, torch.full((n,), fill, dtype=t.dtype,
                                        device=t.device)])
    return SparseWork(
        Rs=work.Rs, n_tiles=work.n_tiles, n_live=work.n_live,
        work_c=cat(work.work_c, 0), work_b=cat(work.work_b, 0),
        work_t=cat(work.work_t, work.n_tiles),
        work_o=cat(work.work_o, work.n_tiles),
        work_s0=cat(work.work_s0, 0), work_s1=cat(work.work_s1, 0))


def sparse_inputs(n_channels=SPARSE_CHANNELS, stop=SPARSE_STOP,
                  device='cuda') -> dict:
    """P1's inputs: the flagship schedule (``build_schedule(n_channels,
    0)``) lowered over ``[0, stop)`` at 2 GS/s, its descriptors on
    ``device``, ``build_sparse_plan(low, Rs=32)``'s worklist and that
    worklist padded :data:`PAD` times."""
    device = resolve_device(device)
    low = lower_schedule(build_schedule(n_channels, 0), 0.0, stop, FS)
    plan = build_sparse_plan(low, Rs=RS)
    work = SparseWork.upload(plan, device)
    return {'low': low, 'plan': plan, 'dev': DeviceSchedule(low, device),
            'work': work, 'padded': pad_work(work)}


def sparse_step_cost_probe(device='cuda', n_channels=SPARSE_CHANNELS,
                           stop=SPARSE_STOP) -> dict:
    """P1: the worklist kernel's cost per step on the flagship plan, three
    ways: ``aliased`` (K7 as the path runs it, timed alone on a zeroed
    (C, window) output: its stores are idempotent), ``aliased_pad4`` (the
    worklist padded 4x: ``us_per_padstep`` prices an item that returns at
    once) and ``compact`` (item k stored at block k of a (K, 32, 128)
    output, no background); ``fill_ms`` is the zero fill of the (C,
    window) output that the path runs before K7, and
    ``aliased_launch_ms`` K7's call timed on an idle card."""
    device = resolve_device(device)
    inp = sparse_inputs(n_channels, stop, device)
    dev, work, padded, plan = (inp['dev'], inp['work'], inp['padded'],
                               inp['plan'])
    K = work.work_c.shape[0]
    res = {'probe': 'sparse_step_cost', 'n_live': plan.n_live, 'K': K,
           'n_tiles': plan.n_tiles, 'window_samples': plan.window_samples}
    out = torch.zeros((dev.shape[0], plan.window_samples), device=device)
    out4 = torch.zeros_like(out)
    cout = torch.empty((K, RS, 128), device=device)
    cout4 = torch.empty((PAD * K, RS, 128), device=device)
    kernels.synth_sparse(dev, work, out, None)
    kernels.synth_sparse(dev, padded, out4, None)
    kernels.probe_sparse_compact(dev, work, cout)
    if device.type == 'cpu':
        kernels.probe_sparse_compact(dev, padded, cout4)
        return dict(res, outputs={'aliased': out, 'aliased_pad4': out4,
                                  'compact': cout, 'compact_pad4': cout4})
    del out4
    res['aliased_ms'] = cuda_ms(lambda: kernels.synth_sparse(dev, work, out,
                                                             None))
    res['aliased_launch_ms'] = cuda_ms(
        lambda: kernels.synth_sparse(dev, work, out, None), queued=False)
    res['aliased_pad4_ms'] = cuda_ms(
        lambda: kernels.synth_sparse(dev, padded, out, None))
    res['us_per_step'] = res['aliased_ms'] * 1e3 / K
    res['us_per_padstep'] = ((res['aliased_pad4_ms'] - res['aliased_ms'])
                             / ((PAD - 1) * K) * 1e3)
    res['compact_ms'] = cuda_ms(
        lambda: kernels.probe_sparse_compact(dev, work, cout))
    res['compact_us_per_step'] = res['compact_ms'] * 1e3 / K
    res['fill_ms'] = cuda_ms(lambda: out.zero_())
    return dict(res, **_card(device))


def main(argv=None) -> int:
    argparse.ArgumentParser(description=__doc__.split('\n')[0]).parse_args(
        argv)
    health = health_probe()
    print(json.dumps(health), flush=True)
    if not health['ok']:
        return 1
    for probe in (sparse_step_cost_probe, grid_overhead_probe,
                  walker_cost_probe):
        print(json.dumps(probe()), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
