#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``waveforms_tpu_torch/csrc`` and runs:

1. the card's name and power limit (nvidia-smi) and the toolchain;
2. small schedules (4 channels, a few us; one with several buckets; one per
   opcode): each kernel against its plain PyTorch version on the card, and
   both against the float64 numpy oracle;
3. the three bench strata at full size (128 channels, 2 GS/s):
   flagship f32 and int16, mid, dense, through
   ``waveforms_tpu_torch.synthesize(..., engine='auto', device='cuda')``,
   with the kernel launch counts of that run;
4. for each stratum: kernel against plain version over the whole output,
   the oracle on 3 channels at full length, and the kernel's and the plain
   version's times (CUDA events, warm-up, median of 5) beside a plain
   ``fill_`` of the same output (the store roofline the panel kernel meets).

Each phase prints one JSON line.  The line before the last is the kernel
summary; the last line is ``{"ok": true, "device": {...}}`` and is printed
only when every phase passed.  Exits non-zero without a result when no
CUDA device is visible or the port is not importable.
"""

import json
import os
import statistics
import subprocess
import sys
import time

TOL_PLAIN = 1e-6      # kernel vs plain version, f32, of the channel's peak
TOL_ORACLE = 2e-6     # vs the float64 oracle (the JAX suite's RTOL)
TOL_CODES = 1         # int16 codes
REPS = 5


def log(record):
    print(json.dumps(record), flush=True)


def rel_err(a, b):
    """Max over channels of max|a - b| / max|b| (per-channel peak)."""
    import numpy as np
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    peak = np.maximum(np.abs(b).max(axis=-1), 1e-30)
    return float((np.abs(a - b).max(axis=-1) / peak).max())


def rel_err_t(a, b):
    """rel_err on the card (full-size outputs stay there)."""
    a = a.double()
    b = b.double()
    peak = b.abs().amax(dim=-1).clamp_min(1e-30)
    return float(((a - b).abs().amax(dim=-1) / peak).max())


def cuda_ms(fn, reps=REPS):
    """Median device time of fn over reps runs, after one warm-up."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def small_cases():
    """(name, channels, start, stop, fs, bucket_samples, oracle tolerance,
    kernel-vs-plain tolerance).

    Oracle tolerances above TOL_ORACLE are the JAX suite's own for the same
    waveforms (tests/test_pallas_synth.py): the linear chirp's long phase
    and the multi-tone DRAG blend polynomials."""
    import numpy as np

    from waveforms_tpu_torch import (WaveVStack, chirp, cos, cosh, cosPulse,
                                     drag, drag_sin, drag_sinx, exp,
                                     gaussian, mollifier, poly, sinc, sinh,
                                     square)
    bf = (151e6, -83e6, 217e6)
    rng = np.random.default_rng(9)
    return [
        ('shapes', [gaussian(1e-6), cosPulse(1e-6),
                    square(1e-6, edge=0.2e-6), sinc(20e6)],
         -2e-6, 2e-6, 1e9, 'auto', TOL_ORACLE, TOL_PLAIN),
        ('two_buckets', [WaveVStack([(0.4 * cosPulse(40e-9) >> o)
                                     for o in rng.uniform(0, 7e-6, 60)])
                         for _ in range(4)],
         0.0, 8.192e-6, 2e9, 4096, TOL_ORACLE, TOL_PLAIN),
        ('linear_pow2', [poly([0.5, 1e5, -1e11]) * square(3e-6),
                         square(1e-6, edge=0.2e-6, type='linear')],
         -2e-6, 2e-6, 1e9, 'auto', TOL_ORACLE, TOL_PLAIN),
        ('gaussian_pow6', [(gaussian(50e-9) ** 6) >> 100e-9],
         0.0, 0.4e-6, 1e9, 'auto', TOL_ORACLE, TOL_PLAIN),
        ('erf_cos', [square(1e-6, edge=0.2e-6),
                     cos(2 * np.pi * 137.137e6, 0.3) * square(2e-6)],
         -2e-6, 2e-6, 1e9, 'auto', TOL_ORACLE, TOL_PLAIN),
        ('exp_cosh_sinh', [exp(1e5) * square(2e-6),
                           cosh(1e6) * square(2e-6),
                           sinh(1e6) * square(2e-6),
                           square(1e-6) * cosh(1e6) ** -1],
         -2e-6, 2e-6, 1e9, 'auto', TOL_ORACLE, TOL_PLAIN),
        ('linearchirp', [chirp(1e6, 50e6, 1e-5, 0.3, 'linear'),
                         chirp(1e6, 50e6, 1e-5, 0.3, 'exponential')],
         0.0, 1e-5, 2e9, 'auto', 5e-6, TOL_PLAIN),
        ('drag', [drag(100e6, 20e-9, plateau=10e-9, delta=2e6,
                       block_freq=250e6, phase=0.4, t0=3e-9) >> 0.1e-6],
         -0.1e-6, 0.4e-6, 2e9, 'auto', TOL_ORACLE, TOL_PLAIN),
        ('poly_gauss_mollifier', [gaussian(1e-6, d=2),
                                  mollifier(1e-6, d=2), mollifier(1e-6)],
         -2e-6, 2e-6, 1e9, 'auto', TOL_ORACLE, TOL_PLAIN),
        ('drag_sin', [drag_sin(0.2e9, 22.3e-9, plateau=6.1e-9, delta=3e6,
                               block_freq=bf, phase=0.1),
                      drag_sinx(0.2e9, 22.3e-9, plateau=6.1e-9, delta=3e6,
                                block_freq=bf, phase=0.1, tab=0.5)],
         -5e-9, 40e-9, 2e9, 'auto', 5e-6, TOL_PLAIN),
    ]


def exotic_chirp_schedule():
    """A lowered schedule whose factors are OP_EXPCHIRP and OP_HYPCHIRP.

    The lowering rewrites exp/hyperbolic chirps into quadratic windows
    inside the synthesis range, so these opcodes are set directly into the
    descriptors of a gaussian's lowering (args as the lowering packs them);
    only kernel vs plain version is checked."""
    import numpy as np

    from waveforms_tpu_torch import gaussian
    from waveforms_tpu_torch.ops.lowering import (OP_EXPCHIRP, OP_HYPCHIRP,
                                                  lower_schedule)
    low = lower_schedule([gaussian(1e-6), gaussian(1e-6)], -1e-6, 1e-6, 1e9)
    # phases stay within a few radians, where one f32 ulp is ~2e-7
    f0, rate = 1e5, 1e6
    low.op[0, 0, 0, 0, 0] = OP_EXPCHIRP
    low.args[0, 0, 0, 0, 0, 1:4] = (2 * np.pi * f0 / rate, rate * 1e-9, 0.3)
    low.op[1, 0, 0, 0, 0] = OP_HYPCHIRP
    low.args[1, 0, 0, 0, 0, 1:4] = (2 * np.pi * f0 / rate, rate * 1e-9, 0.3)
    return low


def check_small(fail):
    """Phase 2: every kernel against its plain version and the oracle."""
    import numpy as np
    import torch

    from waveforms_tpu_torch import kernels, synthesize
    from waveforms_tpu_torch.engine import _quantize_host
    from waveforms_tpu_torch.ops.lowering import lower_schedule
    from waveforms_tpu_torch.ops.sparse_synth import PanelWork, \
        build_panel_plan
    from waveforms_tpu_torch.ops.synth import DeviceSchedule

    def run_pair(devs, plan, route, dtype, scale):
        """(kernel on the card, plain version on the card, plain version
        on the CPU) for one route and output type."""
        dev = devs['cuda']
        C = dev.shape[0]
        n = dev.n_samples if route == 'dense' else plan.window_samples
        outs = []
        for device in ('cuda', 'cpu'):
            d = devs[device]
            sc = None if scale is None else scale.to(device)
            out = torch.empty((C, n), dtype=dtype, device=device)
            if route == 'dense':
                outs.append(kernels.synth_dense(d, out, sc))
            else:
                outs.append(kernels.synth_panel(
                    d, PanelWork.upload(plan, device), out, sc))
        torch.cuda.synchronize()
        # the plain version on the card too, on the same tensors
        out = torch.empty_like(outs[0])
        sc = None if scale is None else scale.to('cuda')
        if route == 'dense':
            kernels.synth_dense.plain(dev, out, sc)
        else:
            kernels.synth_panel.plain(dev, PanelWork.upload(plan, 'cuda'),
                                      out, sc)
        return outs[0].cpu().numpy(), out.cpu().numpy(), outs[1].numpy()

    for name, chans, start, stop, fs, bs, tol, tol_plain in small_cases():
        low = lower_schedule(chans, start, stop, fs, bucket_samples=bs)
        devs = {d: DeviceSchedule(low, d) for d in ('cuda', 'cpu')}
        ora = synthesize(chans, start, stop, fs, engine='numpy')
        plan = build_panel_plan(low)
        rec = {'phase': 'small', 'case': name, 'shape': list(low.shape),
               'ops': sorted(int(o) for o in np.unique(
                   low.op[np.arange(low.shape[4]) < low.nfac[..., None]]))}
        for route in ('dense', 'panel'):
            for dtype in (torch.float32, torch.int16):
                if dtype == torch.int16 and (route == 'panel'
                                             and low.shape[1] > 1):
                    continue
                scale = (None if dtype == torch.float32 else
                         torch.full((low.shape[0],), 30000.0))
                k, p, pc = run_pair(devs, plan, route, dtype, scale)
                key = f"{route}_{'f32' if scale is None else 'i16'}"
                if scale is None:
                    e_plain = rel_err(k, p)
                    e_cpu = rel_err(pc, p)
                    e_ora = rel_err(k, ora)
                    ok = (e_plain <= tol_plain and e_cpu <= tol_plain
                          and e_ora <= tol)
                else:
                    codes = _quantize_host(ora, np.int16, 30000.0)
                    e_plain = int(np.abs(k.astype(int) - p).max())
                    e_cpu = int(np.abs(pc.astype(int) - p).max())
                    e_ora = int(np.abs(k.astype(int) - codes).max())
                    ok = max(e_plain, e_cpu, e_ora) <= TOL_CODES
                rec[key] = {'vs_plain': e_plain, 'cpu_vs_card_plain': e_cpu,
                            'vs_oracle': e_ora, 'ok': ok}
                if not ok:
                    fail.append(f"small {name} {key}")
        log(rec)

    low = exotic_chirp_schedule()
    devs = {d: DeviceSchedule(low, d) for d in ('cuda', 'cpu')}
    plan = build_panel_plan(low)
    rec = {'phase': 'small', 'case': 'expchirp_hypchirp', 'ops': [7, 8]}
    for route in ('dense', 'panel'):
        k, p, pc = run_pair(devs, plan, route, torch.float32, None)
        e = rel_err(k, p)
        ok = (e <= TOL_PLAIN and rel_err(pc, p) <= TOL_PLAIN
              and np.isfinite(k).all())
        rec[f'{route}_f32'] = {'vs_plain': e, 'ok': bool(ok)}
        if not ok:
            fail.append(f"small expchirp_hypchirp {route}")
    log(rec)


def run_strata(fail):
    """Phases 3 and 4 at full size; returns the kernel summary."""
    import numpy as np
    import torch

    import waveforms_tpu_torch as wt
    from waveforms_tpu_torch import kernels
    from waveforms_tpu_torch.engine import _quantize_host, classify_route
    from waveforms_tpu_torch.ops.lowering import lower_schedule
    from waveforms_tpu_torch.ops.sparse_synth import PanelWork
    from waveforms_tpu_torch.ops.synth import DeviceSchedule
    from waveforms_tpu_torch.schedules import FS, STRATA

    cells = [('flagship', torch.float32), ('flagship', torch.int16),
             ('mid', torch.float32), ('dense', torch.float32)]
    expect = {'flagship': 'panel', 'mid': 'panel', 'dense': 'dense'}
    chans = {name: STRATA[name][0]() for name in STRATA}

    # the main path, through the public entry point; counts from this run
    kernels.reset_launch_counts()
    outs = {}
    walls = {}
    for name, dtype in cells:
        t0 = time.perf_counter()
        outs[name, dtype] = wt.synthesize(chans[name], 0.0, STRATA[name][1],
                                          FS, engine='auto', device='cuda',
                                          out_dtype=dtype, dac_scale=32767.0)
        torch.cuda.synchronize()
        walls[name, dtype] = time.perf_counter() - t0
    counts = kernels.launch_counts()
    log({'phase': 'main_path', 'launches': counts,
         'wall_s': {f'{n}_{str(d)[6:]}': w for (n, d), w in walls.items()}})
    for k in kernels.KERNELS:
        if counts[k.name] == 0:
            fail.append(f"{k.name} never launched on the main path")

    summary = {k.name: {'name': k.name, 'route': 'cuda', 'source': k.source,
                        'replaces': k.replaces, 'launches': counts[k.name],
                        'max_abs_err': 0.0, 'ms': None, 'plain_ms': None}
               for k in kernels.KERNELS}
    for name, dtype in cells:
        stop = STRATA[name][1]
        # the host layers of the same path, timed one by one
        t0 = time.perf_counter()
        low = lower_schedule(chans[name], 0.0, stop, FS)
        t1 = time.perf_counter()
        kind, plan = classify_route(low, out_dtype=dtype)
        t2 = time.perf_counter()
        dev = DeviceSchedule(low, 'cuda')
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        out = outs[name, dtype]
        C, n = out.shape
        i16 = dtype == torch.int16
        scale = torch.full((C,), 32767.0, device='cuda') if i16 else None
        kern = kernels.synth_panel if kind == 'panel' else kernels.synth_dense
        args = ((dev, PanelWork.upload(plan, 'cuda')) if kind == 'panel'
                else (dev,))
        plain_out = torch.empty_like(out)
        kern.plain(*args, plain_out, scale)
        torch.cuda.synchronize()
        rec = {'phase': 'stratum', 'stratum': name, 'dtype': str(dtype)[6:],
               'shape': list(low.shape), 'samples': [C, n], 'route': kind,
               'route_ok': kind == expect[name],
               'host_s': {'lower': t1 - t0, 'route_and_plan': t2 - t1,
                          'upload': t3 - t2,
                          'synthesize_wall': walls[name, dtype]},
               'finite': bool(torch.isfinite(out.float()).all())}
        if i16:
            rec['vs_plain_codes'] = int(
                (out.int() - plain_out.int()).abs().max())
            ok_plain = rec['vs_plain_codes'] <= TOL_CODES
        else:
            rec['vs_plain'] = rel_err_t(out, plain_out)
            abs_err = float((out - plain_out).abs().max())
            rec['vs_plain_abs'] = abs_err
            summary[kern.name]['max_abs_err'] = max(
                summary[kern.name]['max_abs_err'], abs_err)
            ok_plain = rec['vs_plain'] <= TOL_PLAIN
        del plain_out
        sel = [0, 1, C - 1]
        t = np.arange(0.0, stop, 1 / FS)
        ora = np.stack([np.asarray(chans[name][c](t)) for c in sel])
        got = out[sel].cpu().numpy()
        if i16:
            rec['vs_oracle_codes'] = int(np.abs(
                got.astype(int) - _quantize_host(ora, np.int16, 32767.0)
            ).max())
            ok_ora = rec['vs_oracle_codes'] <= TOL_CODES
        else:
            rec['vs_oracle'] = rel_err(got, ora)
            ok_ora = rec['vs_oracle'] <= TOL_ORACLE

        scratch = torch.empty_like(out)
        rec['kernel_ms'] = cuda_ms(lambda: kern(*args, scratch, scale))
        rec['plain_ms'] = cuda_ms(lambda: kern.plain(*args, scratch, scale))
        rec['fill_ms'] = cuda_ms(lambda: scratch.fill_(0))
        del scratch
        rec['kernel_gsps'] = C * n / rec['kernel_ms'] / 1e6
        rec['plain_gsps'] = C * n / rec['plain_ms'] / 1e6
        nbytes = out.numel() * out.element_size()
        rec['store_gbps'] = nbytes / rec['kernel_ms'] / 1e6
        rec['fill_gbps'] = nbytes / rec['fill_ms'] / 1e6
        rec['store_share'] = rec['fill_ms'] / rec['kernel_ms']
        rec['ok'] = bool(rec['route_ok'] and rec['finite'] and ok_plain
                         and ok_ora)
        log(rec)
        if not rec['ok']:
            fail.append(f"stratum {name} {rec['dtype']}")
        # each kernel's time is taken at its main-path stratum
        if (name, dtype) in (('flagship', torch.float32),
                             ('dense', torch.float32)):
            summary[kern.name]['ms'] = rec['kernel_ms']
            summary[kern.name]['plain_ms'] = rec['plain_ms']
        del out
        outs.pop((name, dtype))
        torch.cuda.empty_cache()
    return list(summary.values())


def main():
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    try:
        from waveforms_tpu_torch import kernels
    except ImportError as exc:
        print(f"chip_smoke: the port is not importable here ({exc})",
              file=sys.stderr)
        return 2

    fail = []
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    smi = smi[0] if smi else 'nvidia-smi gave nothing'
    print(smi, flush=True)
    try:
        nvcc = subprocess.run([kernels._nvcc(), '--version'],
                              capture_output=True, text=True,
                              timeout=60).stdout.strip().splitlines()[-1]
    except (RuntimeError, OSError, IndexError) as exc:
        nvcc = f"unavailable: {exc}"
    log({'phase': 'device', 'nvidia_smi': smi,
         'name': torch.cuda.get_device_name(0),
         'count': torch.cuda.device_count(), 'torch': torch.__version__,
         'cuda': torch.version.cuda, 'nvcc': nvcc,
         'python': sys.version.split()[0]})

    t0 = time.perf_counter()
    try:
        kernels.load_library()
    except (RuntimeError, OSError) as exc:
        log({'phase': 'build', 'ok': False, 'error': str(exc)[-4000:]})
        return 1
    ptxas = [ln.strip() for ln in kernels.build_log.splitlines()
             if 'registers' in ln or 'spill' in ln]
    log({'phase': 'build', 'ok': True, 'seconds': time.perf_counter() - t0,
         'library': str(kernels.library_path().name), 'ptxas': ptxas})

    summary = None
    for phase in (check_small, run_strata):
        try:
            res = phase(fail)
            if phase is run_strata:
                summary = res
        except Exception as exc:     # a phase that raises fails the run
            import traceback
            log({'phase': phase.__name__, 'ok': False,
                 'error': traceback.format_exc()[-4000:]})
            fail.append(f"{phase.__name__}: {exc!r}")

    if fail or summary is None:
        print(json.dumps({'ok': False, 'failures': fail}), flush=True)
        return 1
    print(smi, flush=True)
    print(json.dumps({'kernels': summary}), flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
