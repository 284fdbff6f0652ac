#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths once on one NVIDIA GPU.

    python3 chip_smoke.py [--record PATH]

Builds the port's CUDA kernels from ``waveforms_tpu_torch/csrc`` and its
C++ host layer from ``waveforms_tpu_torch/native`` (the lowering walker and
the host engine, with g++; a failed build ends the run) and runs:

1. the card's name and power limit (nvidia-smi), the toolchain and the host
   CPU; then, before every other phase, the health probe P4
   (``waveforms_tpu_torch.probes.health_probe``: ``2 * x`` on the card),
   whose failure ends the run;
2. small schedules (a few channels, a few us): every kernel -- dense (K1),
   panel (K2), worklist (K7), stack (K5) -- against its plain PyTorch
   version on the card and on the CPU, and against the float64 numpy
   oracle, in f32 and int16; one schedule per opcode, several buckets, the
   stack route's vstack / overlapping-DRAG / wide-residual / clipped /
   multi-tone DRAG / bucketed / odd-length / empty-chunk / overflowing
   descriptor shapes with int16 quantized in the kernel and after the
   residual (between them every staging path of K5, or the run fails),
   K5 on every opcode, and pair mode (``part='complex'``) on K1, K2, K7;
   then the double tier (``precision='double'``): one schedule per
   ``HI_OPS`` opcode, powers, clip rails, several buckets, a 2M-sample
   carrier and exotic chirps through K3 (``engine='cuda-dense'``) and,
   where single-bucket, K4, each against its plain float64 version on the
   card (1e-12 of the channel's peak) and the oracle (the JAX suite's
   limits), with the ``combine=False`` (hi, lo) planes; then the narrowed
   stores: K1, K2, K7, K5 (in its store and after a wide residual) and K6
   in bf16 and f16, each equal to the same call's f32 output rounded once
   and within one ulp (over the f32 contract) of its plain version;
3. the strata at full size (128 channels, 2 GS/s), each main path through
   ``waveforms_tpu_torch.synthesize(..., device='cuda')`` with the launch
   counts set to 0 just before it and read just after, each on the route
   of the card's rule (``ops.routes.CARD_RULE``): flagship f32 and int16
   (``engine='auto'``, the worklist kernel), mid and dense (``auto``, the
   dense kernel), ladder120 f32 and int16
   (``auto``, the stack kernel), flagship ``part='complex'`` (``auto``,
   the worklist kernel in pair mode), flagship f32 with
   ``engine='cuda-panel'`` (the panel kernel, which no stratum's ``auto``
   takes on the card), flagship, dense and ladder120 with
   ``precision='double'`` (``auto``: K3 on all three), flagship and dense
   with ``out_dtype=torch.bfloat16`` (K7, K1), each equal to its f32
   cell's output rounded once, and the flagship through
   ``synthesize_hi_panels`` (K4, which no ``auto`` takes on the card);
4. for each stratum: the host lowering by the walker (its seconds and its
   channels lowered and declined; the run fails if it lowered no channel
   of the flagship or ladder120) and, for each of flagship, mid, dense and
   ladder120, once on the Python path (its seconds, and the descriptors
   against the walker's: structure equal, q32 within one step, args within
   one f32 ulp plus one phase step 2*pi/2^32, ext within rtol 1e-10), with
   the seconds of the ``build_stack_plan`` call that the router makes on
   ladder120; kernel against plain
   version over the whole output,
   the oracle on 3 channels at full length, and the kernel's and the plain
   version's times (CUDA events, warm-up, median of 11; of 3 for the
   double tier's plain versions) beside a plain ``fill_`` of the same
   output (the store roofline), with the host layers' seconds; on
   ladder120 also K1 (``engine='cuda-dense'``, the route the port took
   before the stack route) on the same schedule, and on the dense stratum
   K1 in pair mode;
5. the host engines at full size, each a main path: ``engine_native``
   (``synthesize(flagship, engine='native')`` on the card's host, its wall
   and engine seconds, against the oracle on four seeded channels within
   TOL_NATIVE and against K2's f32 plane within TOL_ORACLE) and
   ``engine_torch`` (``engine='torch'`` on the flagship and the dense
   stratum: wall time, device time of the evaluation, the CUDA launches of
   one call in torch.profiler's trace, peak memory; against the oracle on
   four seeded channels and K3 within TOL_ORACLE_HI; then ``sample()``
   with an SOS filter on one channel against scipy within TOL_SOS);
6. the sequence tables: at small size (tests/test_torch_sequencer.py's and
   test_torch_stack_seq.py's tables) every ``Sequencer`` method and
   ``StackSequencer.play_packed`` on the card against the same call on the
   CPU and the oracle, f32 and int16, with indices past both ends; then
   the full-size main paths, each with its launch counts read right after
   it: ``seq_flagship`` (8 flagship schedules: ``play`` -> K1,
   ``play_sparse`` -> K7, ``play_many`` of 3 shots -> K1 x 3),
   ``seq_flagship_packed`` (8 shots in one K2 launch, f32 and int16),
   ``seq_station`` (16 gate-train schedules of 2 ch x 200,000 samples:
   ``play_packed`` of 50 shots -> K2, ``play_replay`` of 1000 shots -> the
   K1 palette and a gather), ``stackseq_ladder`` (4 ladder120 schedules,
   16 shots, f32 and int16 -> K6, K5 never) and ``stackseq_rb`` (16
   schedules of 30 cosPulses, 1000 shots -> K6), each kernel against its
   plain version, the oracle on a few channels of a few shots, and the
   kernel's, the plain version's and the fill's times;
7. the signal chain at full width (the flagship, 128 x 2,000,000, and the
   seq_station table), each stage a main path with its counts read right
   after it; every real filter section runs the recurrence kernel S1 (a
   blocked scan): ``signal_flagship`` -- the flagship's f32 plane (K7) in
   f64 through ``lfilter`` of the station's Z-settle pair (one S1 call),
   ``lfilter`` of the clustered three-pole filter (one) and ``filter_zpk``
   of it (three, a real pole and zero each), each against scipy and the
   long-double answer on 4 seeded rows with its route, device time and the
   doubling scan's time on the same rows, a 31-tap Hann
   ``fft_convolve_centered`` and ``demodulate`` at the two readout tones,
   then S1 against its plain version over the first chunk and the plain
   model of its arithmetic beyond, on the main path's rows and on (8,
   20,000) rows; ``stream_flagship`` -- ``synthesize_stream`` in chunks of
   512 rows (31 K1 windows a pass), f32 equal to one-shot K1 bit for bit,
   filtered (2 S1 calls a chunk) against the port's whole-row ``sosfilt``
   and scipy, int16 codes equal to one-shot K1's; ``seq_station_chain`` --
   ``run_sequence`` of 1000 shots (K1 and S1 each) with the Z-settle pair
   and two tones, 8 shots against ``Sequencer.play`` + scipy ``lfilter`` +
   ``getFTMatrix``; ``iir_routes`` -- at each shape the main paths give a
   filter, S1's device time beside the doubling scan's, and the route;
8. the routers' occupancy ladder (``route_ladder``,
   ``waveforms_tpu_torch.route_ladder``, the port of
   ``tools/tpu_capture.py``'s ``task_occ_ladder`` and
   ``task_occ_ladder_stack``): 128 channels over 524.288 us with 5, 10,
   25, 60, 120, 200 and 300 pulses a channel, the mid, flagship and dense
   strata, and the short windows (a ``seq_station`` schedule, the
   flagship's first 16,384 samples, 2 channels of 120 pulses over 100
   us); at each rung every route that takes the schedule (K1, K2, the
   worklist path, K5) timed in f32, int16 and pair mode, and K3 against
   K4 in the double tier (on the rung's buckets and on one bucket), all
   outputs held against each other and the oracle on 2 channels; each
   rung's occupancy, ``small``, ``pallas_ok``, stack plan (and its host
   time) and both rules' routes; the run fails if a check fails.  The
   ladder's criteria -- the card's route on a rung within 10% of the
   cheapest route, the stack kernel's cost counting its plan where the
   card's router would not build one, and the card's routes summed no
   longer than the JAX rule's -- are recorded, not failed on here
   (schedules the spawned workers build);
9. the mesh (``run_mesh``): a (4, 2) ('channel', 'time') mesh of
   distinct cards where the host has two or more, else of ``cuda:0``
   eight times (``distinct_devices`` in every record).  First
   ``mesh_small``: on a (2, 2) mesh, four channels of 16,384 samples in
   four buckets (bucket0 = 2 on the second time shard) and in one, the
   sharded dense, panel and worklist paths in f32, int16, bf16 and pair
   mode and the stacked-table path against the same mesh of the CPU (the
   plain versions) and bit for bit against the kernel on the whole
   schedule, ``play_packed_sharded``, and K1 with bucket0 and K6 with
   chunk0 against their plain versions on the card and the CPU.  Then the
   cells at full width, each a main path with its launch counts, wall
   time, the shards' summed kernel time (CUDA events, the launches alone)
   beside the unsharded kernel's: ``mesh_flagship`` f32 and int16 and
   ``mesh_mid`` (``synthesize_panels_sharded`` -> K2 x 8: the card's
   router takes them to K7 and K1), ``mesh_dense`` (``synthesize_on_mesh``
   -> K1 x 8, 4 windowed), ``mesh_dense_bucketed`` (62 buckets, bucket0
   31), ``mesh_sparse`` (``synthesize_on_mesh`` -> K7 x 8) and
   ``mesh_complex`` (K2 pair mode, combined and as two planes), each
   bit-equal to the single-device call of the same kernel;
   ``mesh_ladder120`` (K6 x 8, K5 never) within TOL_PLAIN of K5 and of
   K6's plain version, TOL_ORACLE of the oracle on 3 channels;
   ``mesh_play_packed`` (stackseq_ladder's table, 16 shots) bit-equal to
   ``play_packed``; ``mesh_step`` (``make_step`` on the flagship with the
   Z-settle pair and with the clustered filter, S1 x 8 each, and the two
   tones) against scipy on 4 seeded rows and the IQ
   against scipy and ``getFTMatrix``; ``mesh_fft`` (``fft_convolve_
   sharded`` of 4 flagship rows over the 2 time shards, a centered 31-tap
   Hann kernel) against numpy's circular convolution in f64;
10. the multi-process runtime (``run_multiproc``,
   ``waveforms_tpu_torch.parallel.multiproc_smoke``): two spawned worker
   processes on the card, each owning 4 shards of one (4, 2) mesh of
   ``cuda:0``, the process group on gloo, in JAX's layout and in the time
   split (rank r owns time shard r), at full size:
   ``synthesize_sharded`` on the dense stratum (K1 x 4 a process),
   ``synthesize_panels_sharded`` on the flagship (K2 x 4), ``synthesize_sparse_
   sharded`` (K7 x 4), ``synthesize_on_mesh`` (the card's router, K7 x
   4), each local block bit-equal to the single-device
   call; the global mean against the oracle; ``make_step`` with the
   clustered filter, the Z-settle pair and a single exponential, each
   carried across the processes in parallel (S1's full
   call x 4 a process, and its state-only call on the 4 shards of rank 0
   where a row crosses to rank 1: the time split and an 8-shard 'time'
   mesh; that call also on every worker block of the step, bit-equal to
   the full call's zf and the plain model's) and two tones,
   against scipy, S1's long-double contract and the step in one process,
   its bytes between the processes at most the (C, d) states and the IQ
   points; K6 on small tables; ``fft_convolve_sharded`` of 4 flagship rows
   on an 8-shard 'time' mesh over both processes; each worker's wall, its
   kernel times (the workers timing in turns), the exchange's ms and
   bytes, and S1's time for the parallel carry against the sequential;
11. the measurement probes (``waveforms_tpu_torch.probes``): at small size
   (K = 64) P4, every P2 variant and every P3 body against its plain
   version on the card, bit for bit, and P1's compact worklist kernel on 8
   flagship channels over 32.768 us, padded and not, within TOL_PLAIN;
   then the main path ``probes``: P4, P1, P2 and P3 at the JAX tasks' full
   sizes (one line each), with the launch counts read right after, and on
   the same inputs every variant against its plain version, and K7 on
   P1's worklist and on that worklist padded 4x against its plain version
   within TOL_PLAIN;
12. the profiling hooks (``profiling``, ``waveforms_tpu_torch.utils.
   profiling``): ``measure_device`` beside ``probes.cuda_ms`` on K1 over
   the dense stratum (within PROFILE_TOL, or the run fails), K7 alone on
   the flagship and each of S1's kernels on the clustered filter over the
   flagship's f64 rows (recorded), and a trace of one ``synthesize`` call
   inside ``annotate`` holding the annotation and the call's kernel;
13. the JAX suite's cross-engine nets (``cross_engine``,
   ``waveforms_tpu_torch.cross_engine``, a main path): the fuzz seeds of
   CROSS_CASES and the station through ``engine='auto'`` and every forced
   kernel (K1, K2, K7, K5) in f32 and int16, pair mode and the double tier
   (K3), each against its route's plain version and the oracle;
14. the examples (``examples``): each ``examples/torch_*.py`` on the card,
   a main path each.

Kernel times are CUDA-event medians with the card's queue pre-filled
(``probes.cuda_ms``), so they time the device and not the host's launch
path; a run the host had not queued before the card's sleep ended is
redone with a longer sleep, a call the host cannot queue behind one (a
plain version that waits on the card) is timed unqueued, and the
``timing`` line records both.  Every kernel's summary entry carries its
bound: the larger of the bytes its call must move (inputs read once,
the output written once) over the card's HBM rate and the operations that call needs (counted from the
descriptors, ``OP_COST``) over the FP32 (FP64 for K3/K4) peak; S1's are
the flagship rows read and written once and the sequential recurrence's
multiplies and adds over the FP64 peak (no PyTorch call computes an IIR
recurrence), its entry also the blocked design's own floor.  The probe
kernels' entries time one variant each (P2 ``op13_dyn``, P3 ``base``);
``library_ms`` is ``torch.mul`` for P4 and null for the rest (no PyTorch
call computes a table-read-and-fill probe or a descriptor walk).

Each phase prints one compact JSON line (``--record PATH`` writes every
record in full to one JSON file).  The line before the last is the kernel
summary: each kernel's ``launches`` on the user paths (for the probe
kernels, on the ``probes`` path) and, apart, its ``probe_launches`` on the
``probes`` path, whose counts are timing loops, and ``launch_floor_ms``:
one empty launch (``torch.cuda._sleep(0)``) under the same timer, also in
K7's, P1's and P4's rows, the least time a kernel can show there.  The
last line is ``{"ok": true, "device": {...}}`` and is printed only when
every phase passed; a spill in the tile walkers (K1, K3, K7, P1) or the
row walkers (K5, K6) fails the run.  The summary also gives each
kernel's registers and shared memory per thread block from ptxas.  Exits
non-zero without a result when no CUDA device is visible or the port is
not importable.
"""

import json
import os
import re
import subprocess
import sys
import time

TOL_PLAIN = 1e-6      # kernel vs plain version, f32, of the channel's peak
TOL_ORACLE = 2e-6     # vs the float64 oracle (the JAX suite's RTOL)
TOL_CODES = 1         # int16 codes
TOL_PLAIN_HI = 1e-12  # double-tier kernel vs plain version, f64
TOL_ORACLE_HI = 1e-9  # double tier vs the float64 oracle
TOL_SPLIT = 1e-14     # hi + lo vs the f64 output (the split loses 2^-48)
TOL_NATIVE = 2e-7     # engine='native' vs the oracle: its descriptors' f32
                      # arguments set it (the JAX suite's tests/test_native.py)
TOL_SOS = (1e-9, 1e-12)  # sample() with SOS filters vs scipy: rtol, atol
                         # (the JAX suite's tests/test_jax_eval.py)
REPS = 11
REPS_PLAIN_HI = 3     # the double tier's plain versions take seconds
RECORDS = []
MAIN_COUNTS = []      # (path, launch counts) of every main path, read right
                      # after it
MAIN_WINDOWED = []    # (path, K1's launches with row0 != 0) of the same
BUILDS = {}           # key -> the future of a schedule built in a worker
LADDER_SEEDS = (5, 6, 7, 8)   # stackseq_ladder's four ladder120 schedules

# The card's peaks for the bound (NVIDIA's H100 SXM data sheet, at its full
# 700 W): HBM3 bytes/s, and FP32 / FP64 operations/s outside the tensor
# cores.
HBM_BPS = 3.35e12
PEAK_OPS = {'fp32': 67e12, 'fp64': 34e12}
# Operations per evaluated sample of each opcode: the arithmetic of
# op_value in csrc/synth_common.cuh counted by hand (integer phase steps
# included), with expf, sinf, cosf, logf and powf at 8 each and a division
# at 4.  An estimate: the bound it gives is a floor, not a prediction.
OP_COST = {0: 3, 1: 13, 2: 33, 3: 38, 4: 19, 5: 13, 6: 67, 7: 23, 8: 23,
           9: 19, 10: 19, 11: 63, 12: 33, 13: 50, 14: 3, 15: 130, 16: 140}


def start_builds():
    """Build the ladder120 schedules and the route ladder's rungs in worker
    processes while the first phases run -> the pool, which ``main`` shuts
    down.  The builder is the waveform algebra in Python, ~5 s a ladder120
    schedule and ~12 s for ladder300 on the card's host; the main paths
    need five ladder120 schedules (the stratum's and stackseq_ladder's
    four), ``route_ladder`` the rungs that no stratum builds.  The workers
    are spawned, import no CUDA and only build."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor
    from functools import partial

    from waveforms_tpu_torch.route_ladder import sources
    from waveforms_tpu_torch.schedules import STRATA, build_ladder_schedule
    jobs = {'ladder120': STRATA['ladder120'][0]}
    jobs.update({('ladder', s): partial(build_ladder_schedule, 120, seed=s)
                 for s in LADDER_SEEDS})
    jobs.update({('rung', k): job for k, job in sources().items()
                 if k not in STRATA})
    pool = ProcessPoolExecutor(max_workers=min(len(jobs), os.cpu_count()),
                               mp_context=multiprocessing.get_context('spawn'))
    BUILDS.update({key: pool.submit(job) for key, job in jobs.items()})
    return pool


def schedule(key):
    """A schedule that :func:`start_builds` builds, waited for."""
    return BUILDS[key].result()


def log(record, brief=None):
    """Keep ``record`` for --record; print ``brief`` (default: the record)
    as one line."""
    RECORDS.append(record)
    print(json.dumps(record if brief is None else brief), flush=True)


def rel_err(a, b):
    """Max over channels of max|a - b| / max|b| (per-channel peak; complex
    values by modulus)."""
    import numpy as np
    a = np.asarray(a)
    b = np.asarray(b)
    dt = np.complex128 if np.iscomplexobj(a) or np.iscomplexobj(b) \
        else np.float64
    a = a.astype(dt)
    b = b.astype(dt)
    peak = np.maximum(np.abs(b).max(axis=-1), 1e-30)
    return float((np.abs(a - b).max(axis=-1) / peak).max())


def rel_err_t(a, b):
    """rel_err on the card (full-size outputs stay there)."""
    import torch
    dt = torch.complex128 if a.is_complex() else torch.float64
    a = a.to(dt)
    b = b.to(dt)
    peak = b.abs().amax(dim=-1).clamp_min(1e-30)
    return float(((a - b).abs().amax(dim=-1) / peak).max())


# The walker's descriptors against the Python path's, on one schedule: the
# structure arrays and amplitudes equal; each int32 phase word (q32) within
# one step; each f32 argument within one f32 ulp of its value plus one
# fixed-point phase step 2*pi/2^32 rad, the float64 phase reductions of the
# two paths running in another order -- where a phase lies at a rounding
# tie of its int32 turns they split it on the two sides, q32 one step apart
# and its f32 residual one step the other way; ext within rtol 1e-10 (the
# JAX suite's bound, tests/test_native.py).
DESCRIPTOR_STRUCTURE = ('seg_lo', 'seg_hi', 'nterm', 'amp', 'nfac', 'op',
                        'power', 'shift_hi', 'clip_min', 'clip_max')
PHASE_STEP = 2 * 3.141592653589793 / 2**32
TOL_EXT = 1e-10


def descriptor_agreement(walker, python):
    """How the walker's LoweredSchedule ``walker`` agrees with the Python
    path's ``python`` (see DESCRIPTOR_STRUCTURE): a record with ``ok``."""
    import numpy as np
    rec = {'shape_equal': walker.shape == python.shape,
           'structure_equal': all(
               np.array_equal(getattr(walker, n), getattr(python, n))
               for n in DESCRIPTOR_STRUCTURE)}
    if not rec['shape_equal']:
        return dict(rec, ok=False)
    dq = np.abs(walker.q32.astype(np.int64) - python.q32.astype(np.int64))
    rec['q32_differing'] = int((dq > 0).sum())
    rec['q32_max_steps'] = int(dq.max()) if dq.size else 0
    a = walker.args.astype(np.float64)
    b = python.args.astype(np.float64)
    d = np.abs(a - b)
    ulp = np.spacing(np.maximum(np.abs(walker.args),
                                np.abs(python.args))).astype(np.float64)
    rec['args_max_abs'] = float(d.max()) if d.size else 0.0
    beyond = d > ulp
    rec['args_beyond_ulp'] = int(beyond.sum())
    rec['args_beyond_ulp_max_abs'] = float(d[beyond].max()) \
        if beyond.any() else 0.0
    rec['args_ok'] = bool((d <= ulp + PHASE_STEP).all())
    we, pe = walker.ext, python.ext
    rec['ext_equal_size'] = we.size == pe.size
    rec['ext_max_rel'] = float((np.abs(we - pe) / np.maximum(
        np.abs(pe), 1e-300)).max()) if we.size and we.size == pe.size \
        else 0.0
    rec['ok'] = bool(rec['structure_equal'] and rec['q32_max_steps'] <= 1
                     and rec['args_ok'] and rec['ext_equal_size']
                     and (we.size == 0 or np.allclose(
                         we, pe, rtol=TOL_EXT, atol=1e-18)))
    return rec


def code_err(a, b):
    import numpy as np
    return int(np.abs(np.asarray(a).astype(int) - np.asarray(b)).max())


def cuda_ms(fn, reps=REPS, warm_s=0.05):
    """Median device time of fn over reps runs, after warming up for at
    least ``warm_s`` seconds (``waveforms_tpu_torch.probes.cuda_ms``): the
    card lowers its clocks while the host works alone (the oracle, the
    plain versions' set-up), and a 0.2 ms kernel timed right after that
    reads up to 1.5x slow."""
    from waveforms_tpu_torch.probes import cuda_ms as median_ms
    return median_ms(fn, reps, warm_s)


def traced_kernels(fn, pattern, reps=10):
    """The CUDA kernels one call of ``fn`` launches whose names match the
    regular expression ``pattern``, from torch.profiler's trace of ``reps``
    calls after an untraced one (``utils.profiling``'s trace and its reader
    of the card's kernel events): {'kernels': {name: [launches a call,
    device ms a launch]}, 'calls_traced': n, 'reps': reps}, or None where
    the trace holds no such kernel.  Each call is followed on its stream
    by a one-element add, the trace's only other kernel, which closes the
    call's window; a kernel's launches a call are the most common count of
    it in a window, its time the median of its launches: a trace can lose
    a single kernel's record (one launch in ten on an H100)."""
    import collections
    import statistics
    import tempfile

    import torch

    from waveforms_tpu_torch.utils.profiling import device_events, trace
    mark = torch.zeros(1, device='cuda')

    def call():
        fn()
        mark.add_(1)
    call()
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as log_dir:
        with trace(log_dir):
            for _ in range(reps):
                call()
        events = device_events(log_dir)
    windows, now, us = [], collections.Counter(), collections.defaultdict(list)
    for ev in events:
        m = re.search(pattern, ev['name'])
        if m is None:
            windows.append(now)
            now = collections.Counter()
            continue
        now[m.group(0)] += 1
        us[m.group(0)].append(ev['dur'])
    if not us or not windows:
        return None
    return {'kernels': {k: [statistics.mode(w[k] for w in windows),
                            statistics.median(v) / 1e3]
                        for k, v in us.items()},
            'calls_traced': len(windows), 'reps': reps}


def input_bytes(*objs):
    """Bytes of every tensor that ``objs`` hold as attributes (a
    DeviceSchedule, a worklist, stack tables) or are: each read once."""
    import torch
    total = 0
    for o in objs:
        ts = [o] if isinstance(o, torch.Tensor) else [
            v for v in vars(o).values() if isinstance(v, torch.Tensor)]
        total += sum(t.numel() * t.element_size() for t in ts)
    return total


def factor_cost(op, power):
    """Operations of each factor slot: its opcode's cost and |power|
    multiplications (power - 1 for the power, 1 into the product)."""
    import numpy as np
    cost = np.vectorize(OP_COST.get, otypes=[np.int64])(op)
    return cost + np.abs(power)


def walk_ops(low):
    """Operations a segment walk needs on lowering ``low``: every sample of
    every live segment (clipped to its bucket) evaluates its live terms'
    factors, one add per term, and a clip and an add per segment."""
    import numpy as np
    C, NB, S, T, F = low.shape
    n, bs = low.n_samples, low.bucket_samples
    b = np.arange(NB, dtype=np.int64)
    b_lo = b * bs if NB > 1 else np.zeros(1, np.int64)
    b_hi = (np.where(b == NB - 1, n, np.minimum(b_lo + bs, n)) if NB > 1
            else np.full(1, n, np.int64))
    width = (np.minimum(low.seg_hi.astype(np.int64), b_hi[:, None])
             - np.maximum(low.seg_lo.astype(np.int64), b_lo[:, None]))
    width = np.where(low.nterm > 0, np.maximum(width, 0), 0)
    live_f = np.arange(F) < low.nfac[..., None]
    live_t = np.arange(T) < low.nterm[..., None]
    per_term = (factor_cost(low.op, low.power) * live_f).sum(-1) + 1
    per_seg = (per_term * live_t).sum(-1) + 3
    return int((width * per_seg).sum())


def stack_ops(t):
    """Operations per instance of stack tables ``t`` (numpy, one entry per
    instance): its samples times its live factors' costs, one add per term
    and one into the tile."""
    import numpy as np
    inst = t.inst.cpu().numpy().astype(np.int64)
    tnf = t.term_nfac.cpu().numpy()
    nt = inst[:, 3]
    nf = (tnf * (np.arange(tnf.shape[1]) < nt[:, None])).sum(1)
    live = np.arange(t.op.shape[1]) < nf[:, None]
    cost = (factor_cost(t.op.cpu().numpy(), t.power.cpu().numpy())
            * live).sum(1) + nt + 1
    return (inst[:, 2] - inst[:, 1]) * cost


def sched_ops(t):
    """Operations of each schedule of stacked tables ``t``: the sum of
    stack_ops over the instances its blocks reference."""
    import numpy as np
    inst = stack_ops(t)
    cs = t.chunk_start.cpu().numpy()
    bi = t.blk_inst.cpu().numpy()
    return [int(inst[np.unique(bi[cs[k, 0]:cs[k, -1]])].sum())
            for k in range(cs.shape[0])]


def bound(nbytes, ops, peak='fp32'):
    """The least time the card could take: the larger of the bytes over
    HBM_BPS and the operations over the peak, in ms, and which sets it."""
    t_bytes = nbytes / HBM_BPS * 1e3
    t_ops = ops / PEAK_OPS[peak] * 1e3
    return {'bound_ms': max(t_bytes, t_ops),
            'bound_by': 'bytes' if t_bytes >= t_ops else 'operations',
            'bound_bytes': int(nbytes), 'bound_ops': int(ops),
            'library_ms': None}


def brief_checks(rec):
    """The printed line of a small-size record: its name, whether every
    check passed, and the worst float error (vs the plain version, vs the
    oracle) and the worst int16 code difference over its checks."""
    checks = [v for v in rec.values() if isinstance(v, dict) and 'ok' in v]
    floats = [v for v in checks if isinstance(v['vs_plain'], float)]
    codes = [v for v in checks if isinstance(v['vs_plain'], int)]
    return {'phase': rec['phase'], 'case': rec.get('case', rec.get('table')),
            'checks': len(checks), 'ok': all(v['ok'] for v in checks),
            'worst_vs_plain': max((v['vs_plain'] for v in floats),
                                  default=None),
            'worst_vs_oracle': max((v['vs_oracle'] for v in floats
                                    if 'vs_oracle' in v), default=None),
            'worst_codes': max((max(v['vs_plain'], v['vs_oracle'])
                                for v in codes), default=None)}


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


def stack_cases():
    """(name, channels, stop, bucket_samples): the stack route's shapes of
    tests/test_stack_synth.py, at 2 GS/s from 0."""
    import numpy as np

    from waveforms_tpu_torch import (WaveVStack, cos, cosPulse, cut, drag,
                                     drag_sin, gaussian, zero)
    rng = np.random.default_rng(7)
    vstack = WaveVStack([(0.5 * cosPulse(50e-9) >> o)
                         for o in rng.uniform(0, 9e-6, 200)])
    overlap = zero()
    for _ in range(40):
        overlap += drag(100e6, 300e-9, plateau=200e-9, delta=2e6,
                        block_freq=None, phase=rng.uniform(0, 6),
                        t0=0.0) >> rng.uniform(0, 0.6e-6)
    carrier = 0.1 * cos(2 * np.pi * 150e6) + 0.05
    for _ in range(30):
        carrier += 0.4 * (cosPulse(40e-9) >> rng.uniform(0, 7e-6))
    pulses = zero()
    for _ in range(80):
        pulses += 0.3 * (cosPulse(40e-9) >> rng.uniform(0, 7e-6))
    ds = zero()
    p = drag_sin(5e9, 20e-9, plateau=10e-9, delta=1e6)
    for _ in range(70):
        ds += p >> rng.uniform(0, 7e-6)
    sparse = [WaveVStack([(0.5 * cosPulse(50e-9) >> o)
                          for o in (0.3e-6, 0.31e-6, 21.4e-6, 39.9e-6)])]
    short = WaveVStack([(0.5 * cosPulse(20e-9) >> o)
                        for o in np.sort(rng.uniform(0, 15e-6, 150))])
    gcc = (gaussian(40e-9) * cos(2 * np.pi * 100e6)
           * cos(2 * np.pi * 37e6, 0.3)) >> 1e-6
    return [
        ('vstack', [vstack, vstack >> 1e-7], 10e-6, 'auto'),
        ('overlap_drag', [overlap], 1.1e-6, 'auto'),
        ('mixed_wide', [carrier, gaussian(7e-6) >> 3.5e-6], 8.192e-6,
         'auto'),
        ('clipped', [cut(2.0 * (gaussian(2e-6) >> 4e-6), max=1.2), pulses],
         8.192e-6, 'auto'),
        ('multitone_drag', [ds], 8.192e-6, 'auto'),
        ('bucketed', [vstack], 8.192e-6, 2048),
        # 16,381 samples: rows stored sample by sample
        ('odd_length', [vstack, vstack >> 1e-7], 8.1905e-6, 'auto'),
        # 80,000 samples, 10 chunks of which 7 hold no block
        ('empty_chunks', sparse * 2, 40e-6, 'auto'),
        # 150 instances in one thread block's rows, of a table whose
        # three-factor term gives 63 descriptor words an instance: more
        # than the staged descriptors hold
        ('wide_descriptors', [short, gcc], 16e-6, None),
    ]


def pair_cases():
    """(name, channels, start, stop, bucket_samples): complex schedules for
    pair mode (tests/test_pallas_synth.py and test_sparse_synth.py)."""
    import numpy as np

    from waveforms_tpu_torch import cos, cosPulse, gaussian, mixing, zero
    I, Q = mixing(0.5 * cosPulse(50e-9), freq=-80e6, DRAGScaling=1e-10)
    fused = [(1 + 0.5j) * gaussian(2e-7) * cos(2 * np.pi * 150e6),
             I + 1j * Q]
    rng = np.random.default_rng(3)
    iq = []
    for c in range(4):
        x = zero()
        for _ in range(6):
            x += ((0.4 + 0.6j) * gaussian(3e-8)
                  * cos(2 * np.pi * (5e7 + 1e6 * c))
                  >> float(rng.uniform(1e-7, 8e-6)))
        iq.append(x)
    return [('pair_fused', fused, -1e-7, 1e-7, 'auto'),
            ('pair_pulses', iq, 0.0, 8.192e-6, 'auto'),
            ('pair_two_buckets', iq, 0.0, 8.192e-6, 4096)]


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


def every_opcode_schedule():
    """A lowered schedule with every opcode of op_builders, each the only
    factor of a channel: the lowering's own, and OP_EXPCHIRP, OP_HYPCHIRP
    and the reserved OP_INTERP set directly into a gaussian's descriptors
    (tests/test_torch_cuda.py's every-opcode channels).  Every channel is
    narrow, so the stack route takes them all."""
    import numpy as np

    from waveforms_tpu_torch import (chirp, cos, cosh, drag, drag_sin,
                                     drag_sinx, exp, gaussian, mollifier,
                                     poly, sinc, sinh, square)
    from waveforms_tpu_torch.ops.lowering import (OP_EXPCHIRP, OP_HYPCHIRP,
                                                  OP_INTERP, lower_schedule)
    bf = (151e6, -83e6)
    chans = [gaussian(1e-7), square(1e-7, edge=2e-8, type='erf'),
             cos(2 * np.pi * 1e8), sinc(5e7), exp(1e6),
             chirp(1e6, 5e7, 4e-7, 0.3, 'linear'),
             cosh(5e6) * square(2e-7), sinh(5e6) * square(2e-7),
             drag(100e6, 20e-9, plateau=10e-9, delta=2e6, block_freq=250e6,
                  phase=0.4),
             gaussian(1e-7, d=2), mollifier(1e-7, d=1),
             drag_sin(0.2e9, 22.3e-9, plateau=6.1e-9, delta=3e6,
                      block_freq=bf, phase=0.1),
             drag_sinx(0.2e9, 22.3e-9, plateau=6.1e-9, delta=3e6,
                       block_freq=bf, phase=0.1, tab=0.5),
             poly([0.5, 1e5]) * square(3e-7)]
    chans += [gaussian(1e-7)] * 3
    low = lower_schedule(chans, -2e-7, 2e-7, 2e9)
    for c, op in zip(range(len(chans) - 3, len(chans)),
                     (OP_EXPCHIRP, OP_HYPCHIRP, OP_INTERP)):
        low.op[c, 0, 0, 0, 0] = op
        low.args[c, 0, 0, 0, 0, 1:4] = (2 * np.pi * 0.1, 1e-3, 0.3)
    return low


def staging(t):
    """How many chunks of stack tables ``t`` the stack kernels stage in
    shared memory, walk with their block list staged but their descriptors
    in place, and walk with both in place (ops/stack_synth.chunk_staging)."""
    from waveforms_tpu_torch.ops.stack_synth import (STAGE_BLOCKS,
                                                     chunk_staging)
    st = chunk_staging(t)
    listed = st['blocks'] <= STAGE_BLOCKS
    return {'staged': int(st['staged'].sum()),
            'descriptors_in_place': int((listed & ~st['staged']).sum()),
            'in_place': int((~listed).sum()),
            'most_blocks': int(st['blocks'].max(initial=0)),
            'most_slots': int(st['slots'].max(initial=0))}


def walk_kernel(route):
    from waveforms_tpu_torch import kernels
    return {'dense': kernels.synth_dense, 'panel': kernels.synth_panel,
            'sparse': kernels.synth_sparse}[route]


def walk_args(route, dev, plans):
    """The wrapper's leading arguments for a descriptor-walk route."""
    from waveforms_tpu_torch.ops.sparse_synth import PanelWork, SparseWork
    if route == 'dense':
        return (dev,)
    if route == 'panel':
        return (dev, PanelWork.upload(plans['panel'], dev.device))
    return (dev, SparseWork.upload(plans['sparse'], dev.device))


def walk_out(route, dev, plans, dtype):
    """A fresh output for a walk route (zeroed: the worklist kernel's
    background)."""
    import torch
    C = dev.shape[0]
    n = (dev.n_samples if route == 'dense'
         else plans[route].window_samples)
    return torch.zeros((C, n), dtype=dtype, device=dev.device)


def run_walk(route, devs, plans, dtype, scale):
    """(kernel on the card, plain version on the card, plain version on the
    CPU) for one descriptor-walk route and output type."""
    import torch
    kern = walk_kernel(route)
    outs = []
    for device in ('cuda', 'cpu', 'cuda'):
        d = devs[device]
        sc = None if scale is None else scale.to(device)
        out = walk_out(route, d, plans, dtype)
        fn = kern if len(outs) == 0 else kern.plain
        outs.append(fn(*walk_args(route, d, plans), out, sc))
    torch.cuda.synchronize()
    k, pc, p = (o.cpu().numpy() for o in outs)
    return k, p, pc


def check_small(fail):
    """Phase 2: every kernel against its plain version and the oracle."""
    import numpy as np
    import torch

    from waveforms_tpu_torch import kernels, synthesize
    from waveforms_tpu_torch.engine import _quantize_host
    from waveforms_tpu_torch.ops.lowering import lower_schedule
    from waveforms_tpu_torch.ops.sparse_synth import (build_panel_plan,
                                                      build_sparse_plan)
    from waveforms_tpu_torch.ops.stack_synth import (build_stack_plan,
                                                     build_stack_tables,
                                                     synthesize_stack)
    from waveforms_tpu_torch.ops.synth import DeviceSchedule

    def plans_of(low):
        return {'panel': build_panel_plan(low),
                'sparse': build_sparse_plan(low)}

    for name, chans, start, stop, fs, bs, tol, tol_plain in small_cases():
        low = lower_schedule(chans, start, stop, fs, bucket_samples=bs)
        devs = {d: DeviceSchedule(low, d) for d in ('cuda', 'cpu')}
        ora = synthesize(chans, start, stop, fs, engine='numpy')
        plans = plans_of(low)
        rec = {'phase': 'small', 'case': name, 'shape': list(low.shape),
               'ops': sorted(int(o) for o in np.unique(
                   low.op[np.arange(low.shape[4]) < low.nfac[..., None]]))}
        for route in ('dense', 'panel', 'sparse'):
            for dtype in (torch.float32, torch.int16):
                if dtype == torch.int16 and (route == 'panel'
                                             and low.shape[1] > 1):
                    continue
                scale = (None if dtype == torch.float32 else
                         torch.full((low.shape[0],), 30000.0))
                k, p, pc = run_walk(route, devs, plans, dtype, scale)
                key = f"{route}_{'f32' if scale is None else 'i16'}"
                if scale is None:
                    e_plain = rel_err(k, p)
                    e_cpu = rel_err(pc, p)
                    e_ora = rel_err(k, ora)
                    ok = (e_plain <= tol_plain and e_cpu <= tol_plain
                          and e_ora <= tol)
                else:
                    codes = _quantize_host(ora, np.int16, 30000.0)
                    e_plain = code_err(k, p)
                    e_cpu = code_err(pc, p)
                    e_ora = code_err(k, codes)
                    ok = max(e_plain, e_cpu, e_ora) <= TOL_CODES
                rec[key] = {'vs_plain': e_plain, 'cpu_vs_card_plain': e_cpu,
                            'vs_oracle': e_ora, 'ok': ok}
                if not ok:
                    fail.append(f"small {name} {key}")
        log(rec, brief_checks(rec))

    low = exotic_chirp_schedule()
    devs = {d: DeviceSchedule(low, d) for d in ('cuda', 'cpu')}
    plans = plans_of(low)
    rec = {'phase': 'small', 'case': 'expchirp_hypchirp', 'ops': [7, 8]}
    for route in ('dense', 'panel', 'sparse'):
        k, p, pc = run_walk(route, devs, plans, torch.float32, None)
        e = rel_err(k, p)
        ok = (e <= TOL_PLAIN and rel_err(pc, p) <= TOL_PLAIN
              and np.isfinite(k).all())
        rec[f'{route}_f32'] = {'vs_plain': e, 'ok': bool(ok)}
        if not ok:
            fail.append(f"small expchirp_hypchirp {route}")
    log(rec, brief_checks(rec))

    # pair mode on the three descriptor walks: complex64 out
    for name, chans, start, stop, bs in pair_cases():
        low = lower_schedule(chans, start, stop, 2e9, part='complex',
                             bucket_samples=bs)
        devs = {d: DeviceSchedule(low, d) for d in ('cuda', 'cpu')}
        ora = synthesize(chans, start, stop, 2e9, engine='numpy',
                         part='complex')
        plans = plans_of(low)
        rec = {'phase': 'small_pair', 'case': name, 'shape': list(low.shape)}
        for route in ('dense', 'panel', 'sparse'):
            k, p, pc = run_walk(route, devs, plans, torch.complex64, None)
            e_plain, e_cpu, e_ora = rel_err(k, p), rel_err(pc, p), \
                rel_err(k, ora)
            ok = bool(k.dtype == np.complex64 and e_plain <= TOL_PLAIN
                      and e_cpu <= TOL_PLAIN and e_ora <= TOL_ORACLE)
            rec[f'{route}_c64'] = {'vs_plain': e_plain,
                                   'cpu_vs_card_plain': e_cpu,
                                   'vs_oracle': e_ora, 'ok': ok}
            if not ok:
                fail.append(f"small_pair {name} {route}")
        log(rec, brief_checks(rec))

    # the stack route: K5 (and K1 on the wide residual) in f32 and int16;
    # between them the cases reach each of K5's staging paths
    paths = set()
    for name, chans, stop, bs in stack_cases():
        low = lower_schedule(chans, 0.0, stop, 2e9, bucket_samples=bs)
        plan = build_stack_plan(low)
        ora = synthesize(chans, 0.0, stop, 2e9, engine='numpy')
        rec = {'phase': 'small_stack', 'case': name, 'shape': list(low.shape),
               'n_narrow': plan.n_narrow, 'groups': len(plan.groups),
               'blocks': plan.n_blocks_total,
               'wide_residual': plan.wide is not None,
               'pallas_ok': bool(low.pallas_ok)}
        # K5 alone against its plain version on the card, on one table
        t = build_stack_tables(plan, low, 'cuda')
        rec['staging'] = staging(t)
        paths |= {k for k in ('staged', 'descriptors_in_place', 'in_place')
                  if rec['staging'][k]}
        kn = kernels.synth_stack(t, torch.empty((low.shape[0], low.n_samples),
                                                device='cuda'), None)
        pn = kernels.synth_stack.plain(t, torch.empty_like(kn), None)
        rec['k5_vs_card_plain'] = rel_err(kn.cpu().numpy(),
                                          pn.cpu().numpy())
        ok_k5 = rec['k5_vs_card_plain'] <= TOL_PLAIN
        # the whole route (K5 + K1 on the residual) against the CPU plain
        # versions and the oracle
        for dtype in (torch.float32, torch.int16):
            kw = {} if dtype == torch.float32 else {
                'out_dtype': torch.int16, 'dac_scale': 30000.0}
            k = synthesize_stack(low, plan, device='cuda', **kw).cpu().numpy()
            pc = synthesize_stack(low, plan, device='cpu', **kw).numpy()
            if dtype == torch.float32:
                e_plain, e_ora = rel_err(k, pc), rel_err(k, ora)
                ok = (ok_k5 and e_plain <= TOL_PLAIN
                      and e_ora <= TOL_ORACLE)
                rec['f32'] = {'vs_plain': e_plain, 'vs_oracle': e_ora,
                              'ok': ok}
            else:
                codes = _quantize_host(ora, np.int16, 30000.0)
                e_plain, e_ora = code_err(k, pc), code_err(k, codes)
                ok = bool(k.dtype == np.int16
                          and max(e_plain, e_ora) <= TOL_CODES)
                rec['i16'] = {'quantized': ('kernel' if plan.wide is None
                                            else 'epilogue'),
                              'vs_plain': e_plain, 'vs_oracle': e_ora,
                              'ok': ok}
            if not ok:
                fail.append(f"small_stack {name} {dtype}")
        log(rec, brief_checks(rec) | {'staging': rec['staging']})
    if len(paths) < 3:
        fail.append(f"small_stack reached only the staging paths {paths}")

    # K5 on every opcode, each the only factor of a channel, against its
    # plain version on the card
    low = every_opcode_schedule()
    t = build_stack_tables(build_stack_plan(low), low, 'cuda')
    kn = kernels.synth_stack(t, torch.empty((low.shape[0], low.n_samples),
                                            device='cuda'), None)
    pn = kernels.synth_stack.plain(t, torch.empty_like(kn), None)
    torch.cuda.synchronize()
    e = rel_err(kn.cpu().numpy(), pn.cpu().numpy())
    rec = {'phase': 'small_stack', 'case': 'every_opcode',
           'shape': list(low.shape), 'staging': staging(t),
           'k5': {'vs_plain': e, 'ok': bool(
               e <= TOL_PLAIN and torch.isfinite(kn).all())}}
    if not rec['k5']['ok']:
        fail.append("small_stack every_opcode")
    log(rec, brief_checks(rec))


def hi_small_cases():
    """(name, channels, start, stop, bucket_samples, oracle tolerance) for
    the double tier, at 2 GS/s: one schedule per HI_OPS opcode (the
    mollifier at d = 0..3), powers, clip rails, several buckets, the
    2M-sample carrier and the exotic chirps of tests/test_hi_synth.py.
    Tolerances above TOL_ORACLE_HI are that suite's own."""
    import numpy as np

    from waveforms_tpu_torch import (WaveVStack, chirp, cos, cosh, cosPulse,
                                     drag, drag_sin, drag_sinx, exp,
                                     gaussian, mollifier, poly, sinc, sinh,
                                     square)
    bf = (151e6, -83e6, 217e6)
    clipped = (2.0 * gaussian(2e-6)) >> 4e-6
    clipped.min, clipped.max = -1.0, 1.0
    rng = np.random.default_rng(5)
    stack = WaveVStack([(0.3 * cosPulse(40e-9) >> o)
                        for o in rng.uniform(0, 7e-6, 60)])
    span = 8.192e-6
    t = TOL_ORACLE_HI
    return [
        ('linear', [poly([0.5, 1e5, -1e11]) * square(3e-6),
                    square(1e-6, edge=0.2e-6, type='linear')],
         -2e-6, 2e-6, 'auto', t),
        ('gaussian', [gaussian(1e-6)], -2e-6, 2e-6, 'auto', t),
        ('cos', [cos(2 * np.pi * 137.137e6, 0.3)], 0.0, span, 'auto', t),
        ('exp', [exp(1e5) * square(2e-6)], -2e-6, 2e-6, 'auto', t),
        ('sinc', [sinc(20e6)], -2e-6, 2e-6, 'auto', t),
        ('drag', [drag(50e6, 100e-9, plateau=40e-9, delta=1e6,
                       block_freq=None, phase=0.3) >> 2e-6],
         0.0, span, 'auto', t),
        ('linearchirp', [chirp(1e6, 50e6, 1e-5, 0.3, 'linear')], 0.0, span,
         'auto', t),
        ('erf', [square(2e-6, edge=1e-7, type='erf') >> 3e-6],
         0.0, span, 'auto', t),
        ('cosh', [cosh(1e6) * square(2e-6)], -2e-6, 2e-6, 'auto', t),
        ('sinh', [sinh(1e6) * square(2e-6)], -2e-6, 2e-6, 'auto', t),
        ('poly_gauss', [gaussian(6e-7, d=d) >> 3e-6 for d in (1, 2, 3)],
         0.0, span, 'auto', t),
        ('mollifier', [mollifier(2e-6, d=d) >> 3e-6 for d in (0, 1, 2, 3)],
         0.0, span, 'auto', t),
        ('drag_sin', [drag_sin(0.2e9, 22.3e-9, plateau=6.1e-9, delta=3e6,
                               block_freq=bf, phase=0.1)],
         -5e-9, 40e-9, 'auto', 2e-9),
        ('drag_sinx', [drag_sinx(0.2e9, 22.3e-9, plateau=6.1e-9, delta=3e6,
                                 block_freq=bf, phase=0.1, tab=0.5)],
         -5e-9, 40e-9, 'auto', 2e-9),
        ('powers', [(gaussian(1e-6) ** 3) >> 3e-6,
                    (square(2e-6) * cosh(1e6) ** -1) >> 3e-6],
         0.0, span, 'auto', t),
        ('clip_rails', [clipped], 0.0, span, 'auto', 2e-7),
        ('bucketed', [stack, stack >> 1e-7], 0.0, span, 4096, t),
        ('carrier_2M', [cos(2 * np.pi * 123.456789e6, 0.7)], 0.0,
         1.048576e-3, 'auto', 2e-9),
        ('exotic_chirps', [chirp(1e6, 8e7, span, type=kind)
                           * gaussian(4e-6) >> 4e-6
                           for kind in ('exponential', 'hyperbolic')],
         0.0, span, None, t),
    ]


def split_err(hi, lo, out):
    """(hi == f32(out), max over channels of |hi + lo - out| / peak)."""
    import torch
    same = bool(torch.equal(hi, out.float()))
    return same, rel_err_t(hi.double() + lo.double(), out)


def check_small_hi(fail):
    """Phase 2, double tier: K3 (through the entry point) and K4 against
    their plain f64 versions on the card and the oracle, and the split
    planes.  One line for the phase; per-case records in --record."""
    import torch

    from waveforms_tpu_torch import kernels, synthesize
    from waveforms_tpu_torch.ops.hi_synth import (HiSchedule, synthesize_hi,
                                                  synthesize_hi_panels)
    from waveforms_tpu_torch.ops.lowering import lower_schedule
    from waveforms_tpu_torch.ops.sparse_synth import (PanelWork,
                                                      build_panel_plan)
    worst = {'k3_vs_plain': 0.0, 'k4_vs_plain': 0.0, 'split': 0.0}
    bad = []
    fs = 2e9
    for name, chans, start, stop, bs, tol in hi_small_cases():
        low = lower_schedule(chans, start, stop, fs, bucket_samples=bs,
                             keep_f64=True)
        ora = synthesize(chans, start, stop, fs, engine='numpy')
        n3 = kernels.synth_dense_hi.launches
        k3 = synthesize(chans, start, stop, fs, engine='cuda-dense',
                        bucket_samples=bs, precision='double', device='cuda')
        torch.cuda.synchronize()
        n3 = kernels.synth_dense_hi.launches - n3
        dev = HiSchedule(low, 'cuda')
        p3 = kernels.synth_dense_hi.plain(dev, torch.empty_like(k3), None)
        same, e_split = split_err(*synthesize_hi(dev, combine=False), k3)
        rec = {'phase': 'small_hi', 'case': name, 'shape': list(low.shape),
               'k3_launched': n3,
               'k3_vs_plain': rel_err_t(k3, p3),
               'k3_vs_oracle': rel_err(k3.cpu().numpy(), ora),
               'k3_split_hi_is_f32': same, 'k3_split': e_split,
               'tol_oracle': tol}
        ok = (rec['k3_launched'] == 1 and k3.dtype == torch.float64
              and rec['k3_vs_plain'] <= TOL_PLAIN_HI
              and rec['k3_vs_oracle'] <= tol and same
              and e_split <= TOL_SPLIT)
        worst['k3_vs_plain'] = max(worst['k3_vs_plain'], rec['k3_vs_plain'])
        worst['split'] = max(worst['split'], e_split)
        if low.shape[1] == 1:
            plan = build_panel_plan(low)
            k4 = synthesize_hi_panels(dev, plan=plan)
            p4 = kernels.synth_panel_hi.plain(
                dev, PanelWork.upload(plan, 'cuda'), torch.empty_like(k4),
                None)
            same4, e4 = split_err(
                *synthesize_hi_panels(dev, plan=plan, combine=False), k4)
            rec.update(k4_vs_plain=rel_err_t(k4, p4),
                       k4_vs_oracle=rel_err(k4.cpu().numpy(), ora),
                       k4_split_hi_is_f32=same4, k4_split=e4)
            ok = (ok and rec['k4_vs_plain'] <= TOL_PLAIN_HI
                  and rec['k4_vs_oracle'] <= tol and same4
                  and e4 <= TOL_SPLIT)
            worst['k4_vs_plain'] = max(worst['k4_vs_plain'],
                                       rec['k4_vs_plain'])
            worst['split'] = max(worst['split'], e4)
        rec['ok'] = bool(ok)
        RECORDS.append(rec)
        if not ok:
            bad.append(name)
            fail.append(f"small_hi {name}")
    log({'phase': 'small_hi', 'cases': len(hi_small_cases()), 'worst': worst,
         'failed': bad, 'ok': not bad})


# (stratum, part, engine, dtype, expected route, kernels that must launch);
# dtype 'float64' is precision='double'.  The expected routes are the card's
# (waveforms_tpu_torch.ops.routes.CARD_RULE); K2 and K4, which no stratum's
# 'auto' takes on the card, each run a forced cell of the flagship, the
# stratum they took before: 'cuda-panel', and 'hi-panel' (the double tier's
# panel entry point, synthesize_hi_panels: no engine forces K4)
CELLS = [
    ('flagship', 'real', 'auto', 'float32', 'sparse', ('synth_sparse',)),
    ('flagship', 'real', 'auto', 'int16', 'sparse', ('synth_sparse',)),
    ('mid', 'real', 'auto', 'float32', 'dense', ('synth_dense',)),
    ('dense', 'real', 'auto', 'float32', 'dense', ('synth_dense',)),
    ('ladder120', 'real', 'auto', 'float32', 'stack', ('synth_stack',)),
    ('ladder120', 'real', 'auto', 'int16', 'stack', ('synth_stack',)),
    ('flagship', 'complex', 'auto', 'float32', 'sparse', ('synth_sparse',)),
    ('flagship', 'real', 'cuda-panel', 'float32', 'panel', ('synth_panel',)),
    ('flagship', 'real', 'auto', 'float64', 'dense', ('synth_dense_hi',)),
    ('dense', 'real', 'auto', 'float64', 'dense', ('synth_dense_hi',)),
    ('ladder120', 'real', 'auto', 'float64', 'dense', ('synth_dense_hi',)),
    ('flagship', 'real', 'auto', 'bfloat16', 'sparse', ('synth_sparse',)),
    ('dense', 'real', 'auto', 'bfloat16', 'dense', ('synth_dense',)),
    ('flagship', 'real', 'hi-panel', 'float64', 'panel',
     ('synth_panel_hi',)),
]
# each kernel's time is taken at its own stratum
KERNEL_CELL = {'synth_panel': 7, 'synth_dense': 3, 'synth_stack': 4,
               'synth_sparse': 0, 'synth_panel_hi': 13, 'synth_dense_hi': 9}


def cell_name(cell):
    stratum, part, engine, dtype = cell[:4]
    return '_'.join([stratum, dtype] + ([part] if part != 'real' else [])
                    + ([engine] if engine != 'auto' else []))


def run_strata(fail, summary):
    """Phases 3 and 4 at full size; fills the kernel summary."""
    import numpy as np
    import torch

    import waveforms_tpu_torch as wt
    import waveforms_tpu_torch.engine as engine_mod
    from waveforms_tpu_torch import kernels, native
    from waveforms_tpu_torch.engine import _FORCE, _quantize_host, \
        classify_route
    from waveforms_tpu_torch.ops.lowering import lower_schedule
    from waveforms_tpu_torch.ops.stack_synth import (build_stack_plan,
                                                     build_stack_tables)
    from waveforms_tpu_torch.ops.synth import DeviceSchedule
    from waveforms_tpu_torch.schedules import FS, STRATA

    chans = {name: (schedule(name) if name in BUILDS else STRATA[name][0]())
             for name in STRATA}
    STASH['chans'] = chans                 # the mesh phase runs them too
    dtypes = {'float32': torch.float32, 'int16': torch.int16,
              'bfloat16': torch.bfloat16, 'float64': None}

    # the main paths, through the public entry point; each cell's counts are
    # set to 0 just before it and read just after
    outs, walls, counts = {}, {}, {}
    for cell in CELLS:
        stratum, part, engine, dtype, _, must = cell
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        if engine == 'hi-panel':
            outs[cell] = wt.synthesize_hi_panels(lower_schedule(
                chans[stratum], 0.0, STRATA[stratum][1], FS, keep_f64=True),
                device='cuda')
        else:
            outs[cell] = wt.synthesize(
                chans[stratum], 0.0, STRATA[stratum][1], FS, engine=engine,
                part=part, out_dtype=dtypes[dtype],
                precision='double' if dtype == 'float64' else 'single',
                dac_scale=32767.0, device='cuda')
        torch.cuda.synchronize()
        walls[cell] = time.perf_counter() - t0
        counts[cell] = kernels.launch_counts()
        MAIN_COUNTS.append((cell_name(cell), counts[cell]))
        MAIN_WINDOWED.append((cell_name(cell),
                              kernels.synth_dense.windowed_launches))
        for k in must:
            if counts[cell][k] == 0:
                fail.append(f"{k} never launched on main path "
                            f"{cell_name(cell)}")
    rec = {'phase': 'main_path',
           'launches': {cell_name(c): counts[c] for c in CELLS},
           'wall_s': {cell_name(c): walls[c] for c in CELLS}}
    log(rec, {'phase': 'main_path', 'launches': {
        cell_name(c): {k: n for k, n in counts[c].items() if n}
        for c in CELLS}})
    lowered = {}
    # the narrowed cells, by (stratum, part, engine): their f32 twin's output
    # (an earlier cell) rounded once is what their stores must equal
    narrow_twin = {c[:3]: c[3] for c in CELLS if c[3] in NARROW}
    rounded = {}
    for i, cell in enumerate(CELLS):
        stratum, part, engine, dname, expect, _ = cell
        if dname == 'float64':
            rec = hi_stratum(cell, outs.pop(cell), chans[stratum],
                             walls[cell], counts[cell])
            if not rec['ok']:
                fail.append(f"stratum {cell_name(cell)}")
            name = rec['kernel']
            if i == KERNEL_CELL[name]:
                summary[name].update(max_abs_err=rec['vs_plain_abs'],
                                     ms=rec['kernel_ms'],
                                     plain_ms=rec['plain_ms'],
                                     **rec['bound'])
            torch.cuda.empty_cache()
            continue
        dtype = dtypes[dname]
        stop = STRATA[stratum][1]
        # the host layers of the same path, timed one by one; each stratum
        # is lowered once (by the walker, the Python path for the channels
        # it declines) and reused across its output types
        rec_host = {}
        lower_rec = {}
        if (stratum, part) not in lowered:
            native.reset_lower_counts()
            t0 = time.perf_counter()
            low = lower_schedule(chans[stratum], 0.0, stop, FS, part=part)
            lower_s = time.perf_counter() - t0
            lower_rec['lower_channels'] = native.lower_counts()
            if part == 'real':
                lower_rec.update(python_lowering(chans[stratum], stop, low))
                if not lower_rec['walker_vs_python']['ok']:
                    fail.append(f"walker vs Python path on {stratum}")
                if (stratum in ('flagship', 'ladder120')
                        and lower_rec['lower_channels']['walker'] == 0):
                    fail.append(f"the walker lowered no channel of "
                                f"{stratum}")
            lowered[stratum, part] = (low, lower_s)
        low, rec_host['lower'] = lowered[stratum, part]
        if 'lower_python' in lower_rec:
            rec_host['lower_python'] = lower_rec.pop('lower_python')
        # the route, with the seconds of the stack plan it builds (the
        # router's own call, timed in place)
        plan_s = []

        def timed_stack_plan(low_):
            t = time.perf_counter()
            made = build_stack_plan(low_)
            plan_s.append(time.perf_counter() - t)
            return made
        t1 = time.perf_counter()
        engine_mod.build_stack_plan = timed_stack_plan
        try:
            kind, plan = classify_route(low, force=_FORCE.get(engine),
                                        out_dtype=dtype, device='cuda')
        finally:
            engine_mod.build_stack_plan = build_stack_plan
        rec_host['route_and_plan'] = time.perf_counter() - t1
        if plan_s:
            rec_host['build_stack_plan'] = sum(plan_s)
        t2 = time.perf_counter()
        if kind == 'stack':
            kern = kernels.synth_stack
            args = (build_stack_tables(plan, low, 'cuda'),)
        else:
            dev = DeviceSchedule(low, 'cuda')
            kern = walk_kernel(kind)
            args = walk_args(kind, dev, {kind: plan})
        torch.cuda.synchronize()
        rec_host['upload'] = time.perf_counter() - t2
        rec_host['synthesize_wall'] = walls[cell]
        out = outs.pop(cell)
        C, n = out.shape
        i16 = dtype == torch.int16
        scale = torch.full((C,), 32767.0, device='cuda') if i16 else None
        plain_out = torch.zeros_like(out)
        kern.plain(*args, plain_out, scale)
        torch.cuda.synchronize()
        rec = {'phase': 'stratum', 'stratum': stratum, 'cell': cell_name(cell),
               'part': part, 'engine': engine, 'dtype': dname,
               'shape': list(low.shape), 'samples': [C, n], 'route': kind,
               'route_ok': kind == expect, 'out_dtype': str(out.dtype)[6:],
               'launches': counts[cell], 'host_s': rec_host, **lower_rec,
               'finite': bool(torch.isfinite(
                   torch.view_as_real(out) if out.is_complex()
                   else out.float()).all())}
        if kind == 'stack':
            rec.update(n_narrow=plan.n_narrow, blocks=plan.n_blocks_total,
                       advantage=plan.advantage,
                       wide_residual=plan.wide is not None)
        if i16:
            rec['vs_plain_codes'] = int(
                (out.int() - plain_out.int()).abs().max())
            ok_plain = rec['vs_plain_codes'] <= TOL_CODES
        elif dname in NARROW:
            # the same stratum's f32 kernel output rounded once, bit for bit;
            # near_narrow: one ulp of the narrow type over the f32 contract
            rec['equals_f32_rounded'] = bool(torch.equal(
                out, rounded.pop(cell[:3])))
            rec['vs_plain_ulps'] = near_narrow(out, plain_out)
            ok_plain = (rec['equals_f32_rounded']
                        and rec['vs_plain_ulps'] <= 1)
        else:
            if dname == 'float32' and cell[:3] in narrow_twin:
                rounded[cell[:3]] = out.to(dtypes[narrow_twin[cell[:3]]])
            rec['vs_plain'] = rel_err_t(out, plain_out)
            abs_err = float((out - plain_out).abs().max())
            rec['vs_plain_abs'] = abs_err
            if i == KERNEL_CELL[kern.name]:
                summary[kern.name]['max_abs_err'] = abs_err
            ok_plain = rec['vs_plain'] <= TOL_PLAIN
        del plain_out
        sel = [0, 1, C - 1]
        ora = wt.synthesize([chans[stratum][c] for c in sel], 0.0, stop, FS,
                            engine='numpy', part=part)
        got = out[sel].float().cpu().numpy() if dname in NARROW else \
            out[sel].cpu().numpy()
        if i16:
            rec['vs_oracle_codes'] = code_err(
                got, _quantize_host(ora, np.int16, 32767.0))
            ok_ora = rec['vs_oracle_codes'] <= TOL_CODES
        else:
            rec['vs_oracle'] = rel_err(got, ora)
            # a narrowed store is within half an ulp of its f32 sum: one
            # ulp at the channel's peak (2^-8 bf16) over TOL_ORACLE
            ok_ora = rec['vs_oracle'] <= TOL_ORACLE + (
                2.0 ** -8 if dname == 'bfloat16' else 0.0)

        # the worklist kernel stores into a zeroed output: time it alone on
        # one (its stores are idempotent) and with the zero fill, the path
        scratch = torch.zeros_like(out)
        rec['kernel_ms'] = cuda_ms(lambda: kern(*args, scratch, scale))
        rec['plain_ms'] = cuda_ms(lambda: kern.plain(*args, scratch, scale))
        rec['fill_ms'] = cuda_ms(lambda: scratch.fill_(0))
        path_ms = rec['kernel_ms']
        if kind == 'sparse':
            rec['path_ms'] = path_ms = cuda_ms(
                lambda: kern(*args, scratch.zero_(), scale))
        rec['kernel_gsps'] = C * n / rec['kernel_ms'] / 1e6
        rec['plain_gsps'] = C * n / rec['plain_ms'] / 1e6
        nbytes = out.numel() * out.element_size()
        rec['store_gbps'] = nbytes / path_ms / 1e6
        rec['fill_gbps'] = nbytes / rec['fill_ms'] / 1e6
        rec['store_share'] = rec['fill_ms'] / path_ms
        if cell_name(cell) == 'ladder120_float32':
            # K1 on the same schedule: the route the port took before the
            # stack route (engine='cuda-dense')
            dev = DeviceSchedule(low, 'cuda')
            dense = kernels.synth_dense(dev, torch.empty_like(out), None)
            rec['dense_vs_stack'] = rel_err_t(dense, out)
            rec['dense_kernel_ms'] = cuda_ms(
                lambda: kernels.synth_dense(dev, scratch, None))
            rec['stack_speedup_vs_dense'] = (rec['dense_kernel_ms']
                                             / rec['kernel_ms'])
            del dense, dev
            ok_plain = ok_plain and rec['dense_vs_stack'] <= TOL_PLAIN
        del scratch
        if cell_name(cell) == 'dense_float32':
            rec['pair'] = dense_pair(fail)
        rec['ok'] = bool(rec['route_ok'] and rec['finite'] and ok_plain
                         and ok_ora)
        log(rec, brief_stratum(rec))
        if not rec['ok']:
            fail.append(f"stratum {cell_name(cell)}")
        if i == KERNEL_CELL[kern.name]:
            summary[kern.name]['ms'] = rec['kernel_ms']
            summary[kern.name]['plain_ms'] = rec['plain_ms']
            # the bound of this call: inputs read once, the output written
            # once (the worklist kernel writes only its live subtiles)
            out_bytes = out.numel() * out.element_size()
            if kind == 'sparse':
                out_bytes = min(plan.n_live * plan.Rs * 128,
                                C * n) * out.element_size()
            summary[kern.name].update(bound(
                input_bytes(*args) + out_bytes,
                sum(stack_ops(args[0])) if kind == 'stack'
                else walk_ops(low)))
            rec['bound'] = {k: summary[kern.name][k]
                            for k in ('bound_ms', 'bound_by')}
        del out
        torch.cuda.empty_cache()


def python_lowering(chans, stop, low):
    """The Python lowering path on the same channels (the walker switched
    off), timed once, and its descriptors against the walker's ``low``."""
    import waveforms_tpu_torch.ops.lowering as lowering
    from waveforms_tpu_torch.schedules import FS
    orig = lowering._lower_schedule_native
    lowering._lower_schedule_native = lambda *a, **k: None
    try:
        t0 = time.perf_counter()
        low_py = lowering.lower_schedule(chans, 0.0, stop, FS)
        seconds = time.perf_counter() - t0
    finally:
        lowering._lower_schedule_native = orig
    return {'lower_python': seconds,
            'walker_vs_python': descriptor_agreement(low, low_py)}


def brief_stratum(rec):
    """The printed line of a stratum record: its checks and times."""
    keys = ('cell', 'route', 'ok', 'vs_plain', 'vs_plain_codes',
            'equals_f32_rounded', 'vs_plain_ulps', 'vs_oracle',
            'vs_oracle_codes', 'kernel_ms', 'plain_ms', 'fill_ms',
            'path_ms', 'store_share', 'dense_kernel_ms', 'lower_channels')
    out = {'phase': 'stratum'}
    out.update({k: rec[k] for k in keys if k in rec})
    host = rec.get('host_s', {})
    out.update({f'{k}_s': host[k] for k in ('lower', 'lower_python',
                                             'build_stack_plan')
                if k in host and 'lower_channels' in rec})
    if 'walker_vs_python' in rec:
        agree = rec['walker_vs_python']
        out['walker_vs_python'] = {k: agree[k] for k in (
            'ok', 'q32_differing', 'args_max_abs', 'args_beyond_ulp_max_abs',
            'ext_max_rel')}
    if 'pair' in rec:
        out['pair'] = {k: rec['pair'][k] for k in
                       ('ok', 'vs_plain', 'vs_oracle', 'kernel_ms')}
    return out


def hi_stratum(cell, out, chans, wall, counts):
    """Phase 4 for a double-tier cell: ``out`` came from synthesize(...,
    precision='double', device='cuda'), or for 'hi-panel' from
    synthesize_hi_panels.  The host layers of the same path
    timed one by one, the kernel against its plain f64 version over the
    whole output, the oracle on 3 channels at full length, and the times."""
    import torch

    import waveforms_tpu_torch as wt
    from waveforms_tpu_torch import kernels
    from waveforms_tpu_torch.ops.hi_synth import HiSchedule, classify_hi_route
    from waveforms_tpu_torch.ops.lowering import lower_schedule
    from waveforms_tpu_torch.ops.sparse_synth import PanelWork, build_panel_plan
    from waveforms_tpu_torch.schedules import FS, STRATA

    stratum, engine, expect = cell[0], cell[2], cell[4]
    stop = STRATA[stratum][1]
    host = {}
    t0 = time.perf_counter()
    low = lower_schedule(chans, 0.0, stop, FS, keep_f64=True)
    host['lower_keep_f64'] = time.perf_counter() - t0
    t0 = time.perf_counter()
    kind, plan = (('panel', build_panel_plan(low)) if engine == 'hi-panel'
                  else classify_hi_route(low, 'cuda'))
    host['route_and_plan'] = time.perf_counter() - t0
    t0 = time.perf_counter()
    dev = HiSchedule(low, 'cuda')
    if kind == 'panel':
        kern = kernels.synth_panel_hi
        args = (dev, PanelWork.upload(plan, 'cuda'))
    else:
        kern = kernels.synth_dense_hi
        args = (dev,)
    torch.cuda.synchronize()
    host['upload'] = time.perf_counter() - t0
    host['synthesize_wall'] = wall
    C, n = out.shape
    plain_out = torch.zeros_like(out)
    kern.plain(*args, plain_out, None)
    torch.cuda.synchronize()
    rec = {'phase': 'stratum', 'stratum': stratum, 'cell': cell_name(cell),
           'precision': 'double', 'shape': list(low.shape),
           'samples': [C, n], 'route': kind, 'route_ok': kind == expect,
           'kernel': kern.name, 'out_dtype': str(out.dtype)[6:],
           'launches': counts, 'host_s': host,
           'finite': bool(torch.isfinite(out).all()),
           'vs_plain': rel_err_t(out, plain_out),
           'vs_plain_abs': float((out - plain_out).abs().max())}
    del plain_out
    sel = [0, 1, C - 1]
    ora = wt.synthesize([chans[c] for c in sel], 0.0, stop, FS,
                        engine='numpy')
    rec['vs_oracle'] = rel_err(out[sel].cpu().numpy(), ora)
    scratch = torch.empty_like(out)
    rec['kernel_ms'] = cuda_ms(lambda: kern(*args, scratch, None))
    rec['plain_ms'] = cuda_ms(lambda: kern.plain(*args, scratch, None),
                              reps=REPS_PLAIN_HI)
    rec['fill_ms'] = cuda_ms(lambda: scratch.fill_(0))
    nbytes = out.numel() * out.element_size()
    rec['kernel_gsps'] = C * n / rec['kernel_ms'] / 1e6
    rec['store_gbps'] = nbytes / rec['kernel_ms'] / 1e6
    rec['fill_gbps'] = nbytes / rec['fill_ms'] / 1e6
    rec['store_share'] = rec['fill_ms'] / rec['kernel_ms']
    rec['bound'] = bound(input_bytes(*args) + nbytes, walk_ops(low), 'fp64')
    del scratch, out
    rec['ok'] = bool(rec['route_ok'] and rec['finite']
                     and rec['out_dtype'] == 'float64'
                     and counts[kern.name] > 0
                     and rec['vs_plain'] <= TOL_PLAIN_HI
                     and rec['vs_oracle'] <= TOL_ORACLE_HI)
    log(rec, brief_stratum(rec))
    return rec


def host_cpu():
    """The host CPU, for the host seconds: its model name, or its vendor,
    family and model numbers where the kernel names it 'unknown'."""
    info = {}
    try:
        with open('/proc/cpuinfo') as f:
            for line in f:
                key, _, value = line.partition(':')
                info.setdefault(key.strip(), value.strip())
    except OSError:
        pass
    if info.get('model name', 'unknown') != 'unknown':
        return info['model name']
    ident = [f"{k} {info[k]}" for k in ('vendor_id', 'cpu family', 'model')
             if info.get(k)]
    return ', '.join(ident) or os.uname().machine


def cuda_activity(fn):
    """The CUDA kernels and memory copies of one call of ``fn`` in
    torch.profiler's trace (after an untraced call; ``utils.profiling``'s
    trace and reader), and their summed device time."""
    import tempfile

    import torch

    from waveforms_tpu_torch.utils.profiling import (COPIES, KERNELS,
                                                     device_events, trace)
    fn()
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as log_dir:
        with trace(log_dir):
            fn()
        evs = device_events(log_dir, KERNELS + COPIES)
    copies = [e for e in evs if e['cat'] in COPIES]
    return {'kernels': len(evs) - len(copies), 'copies': len(copies),
            'device_ms': sum(e['dur'] for e in evs) / 1e3}


def engine_native(fail):
    """``synthesize(flagship, engine='native')``: the C++ host engine on the
    card's host at full size (a main path, counts read after it), timed on
    the host clock; against the oracle on four seeded channels and against
    K2's f32 plane of the same schedule."""
    import statistics

    import numpy as np
    import torch

    import waveforms_tpu_torch as wt
    from waveforms_tpu_torch import kernels, native
    from waveforms_tpu_torch.ops.lowering import lower_schedule
    from waveforms_tpu_torch.schedules import FS, STRATA

    build, stop = STRATA['flagship']
    chans = build()
    kernels.reset_launch_counts()
    native.reset_lower_counts()
    t0 = time.perf_counter()
    out = wt.synthesize(chans, 0.0, stop, FS, engine='native')
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    MAIN_COUNTS.append(('engine_native', counts))
    rec = {'phase': 'engine_native', 'stratum': 'flagship',
           'samples': list(out.shape), 'dtype': str(out.dtype),
           'wall_s': wall, 'lower_channels': native.lower_counts(),
           'cuda_launches': sum(counts.values()), 'host_cpu': host_cpu(),
           'cpus': os.cpu_count()}
    low = lower_schedule(chans, 0.0, stop, FS)
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        native.synthesize_native(low)
        times.append(time.perf_counter() - t0)
    rec['engine_s'] = statistics.median(times)
    rec['host_gsps'] = out.size / rec['engine_s'] / 1e9
    picks = seeded_rows(len(chans), 4, 11)
    ora = wt.synthesize([chans[c] for c in picks], 0.0, stop, FS,
                        engine='numpy')
    rec['oracle_channels'] = picks
    rec['vs_oracle'] = rel_err(out[picks], ora)
    k2 = wt.synthesize(chans, 0.0, stop, FS, engine='cuda-panel',
                       device='cuda')
    rec['vs_k2'] = rel_err_t(k2, torch.from_numpy(out).to('cuda'))
    del k2
    torch.cuda.empty_cache()
    rec['ok'] = bool(out.dtype == 'float64' and out.shape == (128, 2000000)
                     and np.isfinite(out).all()
                     and rec['lower_channels']['walker'] == len(chans)
                     and rec['vs_oracle'] <= TOL_NATIVE
                     and rec['vs_k2'] <= TOL_ORACLE)
    log(rec)
    if not rec['ok']:
        fail.append('engine_native')


def engine_torch(fail):
    """``synthesize(..., engine='torch', device='cuda')``, the trace
    evaluator, on the flagship and the dense stratum at full size (each a
    main path, counts read after it): host wall time, device time of the
    evaluation over the uploaded grid, CUDA launches of one call in
    torch.profiler's trace, peak memory; against the oracle on four seeded
    channels and against the double tier's kernel (K4, K3) on the whole
    plane.  Then ``sample()`` with an SOS filter on one flagship channel
    against scipy, each of the filter's sections one S1 call."""
    import numpy as np
    import scipy.signal as sps
    import torch

    import waveforms_tpu_torch as wt
    from waveforms_tpu_torch import kernels
    from waveforms_tpu_torch.ops.torch_eval import evaluate
    from waveforms_tpu_torch.schedules import FS, STRATA

    ok = True
    for stratum in ('flagship', 'dense'):
        build, stop = STRATA[stratum]
        chans = build()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        out = wt.synthesize(chans, 0.0, stop, FS, engine='torch',
                            device='cuda')
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = kernels.launch_counts()
        MAIN_COUNTS.append((f'engine_torch_{stratum}', counts))
        C, n = out.shape
        rec = {'phase': 'engine_torch', 'stratum': stratum,
               'samples': [C, n], 'dtype': str(out.dtype)[6:],
               'wall_s': wall,
               'peak_gb': (torch.cuda.max_memory_allocated() - base) / 1e9,
               'out_gb': out.numel() * out.element_size() / 1e9,
               'finite': bool(torch.isfinite(out).all())}
        grid = torch.from_numpy(np.arange(0.0, stop, 1 / FS)).to('cuda')
        rec['device_ms'] = cuda_ms(
            lambda: torch.stack([evaluate(ch, grid) for ch in chans]),
            reps=5)
        rec['gsps'] = C * n / rec['device_ms'] / 1e6
        rec['trace'] = cuda_activity(lambda: wt.synthesize(
            chans, 0.0, stop, FS, engine='torch', device='cuda'))
        del grid
        picks = seeded_rows(C, 4, 13)
        ora = wt.synthesize([chans[c] for c in picks], 0.0, stop, FS,
                            engine='numpy')
        rec['oracle_channels'] = picks
        rec['vs_oracle'] = rel_err(out[picks].cpu().numpy(), ora)
        kernels.reset_launch_counts()
        hi = wt.synthesize(chans, 0.0, stop, FS, precision='double',
                           device='cuda')
        rec['hi_kernel'] = [k for k, v in kernels.launch_counts().items()
                            if v]
        rec['vs_hi'] = rel_err_t(out, hi)
        del out, hi
        torch.cuda.empty_cache()
        rec['ok'] = bool(rec['finite'] and rec['dtype'] == 'float64'
                         and [C, n] == [128, 2000000]
                         and rec['vs_oracle'] <= TOL_ORACLE_HI
                         and rec['vs_hi'] <= TOL_ORACLE_HI)
        ok = ok and rec['ok']
        log(rec)

    build, stop = STRATA['flagship']
    wav = build()[0]
    sos = sps.tf2sos(*sps.butter(3, 0.02))
    wav.start, wav.stop, wav.sample_rate = 0.0, stop, FS
    wav.filters = (sos, 0.0)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    got = wt.sample(wav, engine='torch', device='cuda')
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    MAIN_COUNTS.append(('engine_torch_sample', counts))
    got = got.cpu().numpy()
    want = wav.sample()
    rtol, atol = TOL_SOS
    rec = {'phase': 'engine_torch_sample', 'stratum': 'flagship',
           'channel': 0, 'sos': 'butter(3, 0.02)', 'wall_s': wall,
           'launches': {k: v for k, v in counts.items() if v},
           'vs_scipy': float(np.abs(got - want).max()
                             / np.abs(want).max()),
           'within_rtol_atol': bool(np.all(
               np.abs(got - want) <= atol + rtol * np.abs(want)))}
    # each of the filter's sections one S1 call
    rec['ok'] = bool(got.dtype == np.float64 and got.shape == want.shape
                     and rec['within_rtol_atol']
                     and counts['iir_df2t'] == sos.shape[0])
    log(rec)
    if not (ok and rec['ok']):
        fail.append('engine_torch')


def dense_pair(fail):
    """K1 in pair mode on the dense stratum (part='complex'): kernel vs
    plain version, oracle on 3 channels, times."""
    import torch

    import waveforms_tpu_torch as wt
    from waveforms_tpu_torch import kernels
    from waveforms_tpu_torch.ops.lowering import lower_schedule
    from waveforms_tpu_torch.ops.synth import DeviceSchedule
    from waveforms_tpu_torch.schedules import FS, STRATA

    builder, stop = STRATA['dense']
    chans = builder()
    dev = DeviceSchedule(lower_schedule(chans, 0.0, stop, FS,
                                        part='complex'), 'cuda')
    C, n = dev.shape[0], dev.n_samples
    out = torch.empty((C, n), dtype=torch.complex64, device='cuda')
    plain = torch.empty_like(out)
    kernels.synth_dense(dev, out, None)
    kernels.synth_dense.plain(dev, plain, None)
    sel = [0, 1, C - 1]
    ora = wt.synthesize([chans[c] for c in sel], 0.0, stop, FS,
                        engine='numpy', part='complex')
    rec = {'vs_plain': rel_err_t(out, plain),
           'vs_oracle': rel_err(out[sel].cpu().numpy(), ora)}
    del plain
    rec['kernel_ms'] = cuda_ms(lambda: kernels.synth_dense(dev, out, None))
    rec['plain_ms'] = cuda_ms(
        lambda: kernels.synth_dense.plain(dev, out, None))
    rec['fill_ms'] = cuda_ms(lambda: out.fill_(0))
    rec['ok'] = bool(rec['vs_plain'] <= TOL_PLAIN
                     and rec['vs_oracle'] <= TOL_ORACLE)
    if not rec['ok']:
        fail.append("dense pair mode")
    return rec


SEQ_KS = [2, 0, 99, -3, 1]    # shot indices: in range, past both ends


def _vstacks(n_schedules, n_pulses, seed, n_channels=1, stop=8.192e-6):
    """Schedules of random cosPulse trains (tests/test_stack_seq.py)."""
    import numpy as np

    from waveforms_tpu_torch import WaveVStack, cosPulse
    rng = np.random.default_rng(seed)
    return [[WaveVStack([(float(a) * cosPulse(50e-9) >> o)
                         for a, o in zip(rng.uniform(0.2, 1.0, n_pulses),
                                         rng.uniform(0, stop - 1e-7,
                                                     n_pulses))])
             for _ in range(n_channels)] for _ in range(n_schedules)]


def seq_small_tables():
    """(name, channels per schedule, stop, lowering kwargs, oracle
    tolerance): the tables of tests/test_torch_sequencer.py, built with
    the port, at 2 GS/s from 0.  5e-6 on the multi-tone DRAG table is the
    JAX suite's own limit for it."""
    import numpy as np

    from waveforms_tpu_torch import (WaveVStack, cos, cosPulse, drag_sin,
                                     gaussian, square)
    gates = [
        [gaussian(100e-9) >> 0.3e-6, cosPulse(80e-9) >> 0.7e-6],
        [0.7 * square(200e-9, edge=20e-9) >> 0.5e-6,
         drag_sin(0.2e9, 22.3e-9, plateau=6.1e-9, delta=3e6,
                  block_freq=(151e6,), phase=0.1) >> 0.4e-6],
        [gaussian(60e-9) * cos(2 * np.pi * 150e6) >> 0.2e-6,
         cosPulse(50e-9) >> 0.8e-6]]
    bucketed = []
    for seed in (1, 2, 3):
        r = np.random.default_rng(seed)
        bucketed.append([WaveVStack([(0.4 * cosPulse(40e-9) >> o)
                                     for o in r.uniform(0, 7e-6, 60)])])
    return [('gates', gates, 1e-6, {}, 5e-6),
            ('gates_complex', gates, 1e-6, {'part': 'complex'}, TOL_ORACLE),
            ('bucketed', bucketed, 8.192e-6, {'bucket_samples': 2048},
             TOL_ORACLE),
            ('multichannel', _vstacks(2, 15, 17, n_channels=3), 8.192e-6,
             {}, TOL_ORACLE)]


def stack_seq_small_tables():
    """(name, channels per schedule): the narrow-pulse tables of
    tests/test_torch_stack_seq.py, built with the port, 8.192 us at
    2 GS/s."""
    import numpy as np

    from waveforms_tpu_torch import drag_sin, zero
    rng = np.random.default_rng(41)
    ds = []
    for n in (6, 9):
        x = zero()
        p = drag_sin(5e9, 20e-9, plateau=10e-9, delta=1e6,
                     block_freq=(151e6,), phase=float(rng.uniform(0, 6)))
        for o in np.sort(rng.uniform(0, 7e-6, n)):
            x += p >> float(o)
        ds.append([x])
    return [('vstack3', _vstacks(3, 40, 11)),
            ('multichannel', _vstacks(2, 15, 17, n_channels=3)),
            ('drag_sin', ds)]


def check_small_seq(fail):
    """Phase 2, sequence tables: every Sequencer method -- play and
    play_many (K1), play_sparse (K7), play_packed (K2), play_replay (the
    K1 palette and a gather) -- and StackSequencer.play_packed (K6) on the
    card, against the same call on the CPU (the plain versions) and the
    oracle, in f32 and int16, with indices past both ends of the table."""
    import numpy as np
    import torch

    import waveforms_tpu_torch as wt
    from waveforms_tpu_torch.engine import _quantize_host
    from waveforms_tpu_torch.ops import Sequencer, StackSequencer
    from waveforms_tpu_torch.ops.lowering import lower_schedule

    def compare(rec, key, run, want, tol):
        got = run('cuda')
        torch.cuda.synchronize()
        got, plain = got.cpu().numpy(), run('cpu').numpy()
        if got.dtype == np.int16:
            codes = _quantize_host(want, np.int16, 30000.0)
            e = {'vs_plain': code_err(got, plain),
                 'vs_oracle': code_err(got, codes)}
            ok = max(e.values()) <= TOL_CODES
        else:
            e = {'vs_plain': rel_err(got, plain),
                 'vs_oracle': rel_err(got, want)}
            ok = e['vs_plain'] <= TOL_PLAIN and e['vs_oracle'] <= tol
        rec[key] = dict(e, ok=bool(ok))
        if not ok:
            fail.append(f"small_seq {rec['table']} {key}")

    i16 = {'out_dtype': torch.int16, 'dac_scale': 30000.0}
    for name, chans, stop, kw, tol in seq_small_tables():
        lows = [lower_schedule(ch, 0.0, stop, 2e9, **kw) for ch in chans]
        K = len(lows)
        seqs = {d: Sequencer(lows, device=d) for d in ('cuda', 'cpu')}
        ora = [wt.synthesize(ch, 0.0, stop, 2e9, engine='numpy',
                             part=kw.get('part', 'real')) for ch in chans]
        want = np.stack([ora[min(max(k, 0), K - 1)] for k in SEQ_KS])
        pair, single = 'part' in kw, lows[0].shape[1] == 1
        rec = {'phase': 'small_seq', 'table': name, 'schedules': K,
               'shape': list(seqs['cpu'].shape)}
        for method in ('play', 'play_many', 'play_sparse', 'play_packed',
                       'play_replay'):
            if method in ('play_sparse', 'play_packed') and (
                    pair or not single):
                continue
            for okw in ({}, i16):
                if okw and (pair or method == 'play_sparse'):
                    continue

                def run(d, method=method, okw=okw):
                    seq = seqs[d]
                    if method in ('play', 'play_sparse'):
                        return torch.stack([getattr(seq, method)(k, **okw)
                                            for k in SEQ_KS])
                    return getattr(seq, method)(SEQ_KS, **okw)
                compare(rec, f"{method}_{'i16' if okw else 'f32'}", run,
                        want, tol)
        log(rec, brief_checks(rec))

    for name, chans in stack_seq_small_tables():
        lows = [lower_schedule(ch, 0.0, 8.192e-6, 2e9) for ch in chans]
        K = len(lows)
        seqs = {d: StackSequencer(lows, device=d) for d in ('cuda', 'cpu')}
        want = np.stack([wt.synthesize(chans[min(max(k, 0), K - 1)], 0.0,
                                       8.192e-6, 2e9, engine='numpy')
                         for k in SEQ_KS])
        rec = {'phase': 'small_stack_seq', 'table': name, 'schedules': K,
               'describe': seqs['cpu'].describe()}
        for okw in ({}, i16):
            compare(rec, f"play_packed_{'i16' if okw else 'f32'}",
                    lambda d, okw=okw: seqs[d].play_packed(SEQ_KS, **okw),
                    want, TOL_ORACLE)
        log(rec, brief_checks(rec))


NARROW = ('bfloat16', 'float16')


def near_narrow(a, b):
    """Largest |a - b| over one ulp of the narrow type at max(|a|, |b|)
    plus TOL_PLAIN of the channel's finite peak, over samples where a != b
    (a, b: one 16-bit float dtype; <= 1 passes).  Two f32 sums within the
    f32 contract round, monotonically, to values at most that far apart."""
    import torch
    a, b = a.cpu(), b.cpu()
    big = torch.maximum(a.abs(), b.abs())
    ulp = (big.view(torch.int16) + 1).view(a.dtype).float() - big.float()
    fb = b.float()
    peak = torch.where(torch.isfinite(fb), fb.abs(), 0.0).amax(
        dim=-1, keepdim=True)
    ratio = (a.float() - fb).abs() / (ulp + TOL_PLAIN * peak)
    return float(torch.where(a == b, 0.0, ratio).max())


def check_small_narrow(fail):
    """Phase 2, the narrowed stores: K1, K2, K7 (phase 2's schedules), K5
    (in its store, and after a wide residual) and K6, in bf16 and f16, each
    through its entry function on the card: equal to the same call's f32
    output rounded once (torch.equal), and near the plain version's
    narrowed output on the CPU (near_narrow)."""
    import torch

    from waveforms_tpu_torch.ops import StackSequencer
    from waveforms_tpu_torch.ops.lowering import lower_schedule
    from waveforms_tpu_torch.ops.sparse_synth import (build_panel_plan,
                                                      build_sparse_plan,
                                                      synthesize_panels,
                                                      synthesize_sparse)
    from waveforms_tpu_torch.ops.stack_synth import (build_stack_plan,
                                                     synthesize_stack)
    from waveforms_tpu_torch.ops.synth import (DeviceSchedule,
                                               synthesize_device)
    small = {name: (chans, start, stop, fs, bs)
             for name, chans, start, stop, fs, bs, *_ in small_cases()}
    stacks = {name: (chans, stop, bs)
              for name, chans, stop, bs in stack_cases()}

    def walk(route, name):
        chans, start, stop, fs, bs = small[name]
        low = lower_schedule(chans, start, stop, fs, bucket_samples=bs)

        def run(device, **kw):
            dev = DeviceSchedule(low, device)
            if route == 'dense':
                return synthesize_device(dev, **kw)
            if route == 'panel':
                return synthesize_panels(dev, plan=build_panel_plan(low), **kw)
            return synthesize_sparse(dev, plan=build_sparse_plan(low), **kw)
        return run

    def stack(name):
        chans, stop, bs = stacks[name]
        low = lower_schedule(chans, 0.0, stop, 2e9, bucket_samples=bs)
        plan = build_stack_plan(low)
        return lambda device, **kw: synthesize_stack(low, plan,
                                                     device=device, **kw)

    def stack_seq():
        chans = dict(stack_seq_small_tables())['vstack3']
        lows = [lower_schedule(ch, 0.0, 8.192e-6, 2e9) for ch in chans]
        return lambda device, **kw: StackSequencer(
            lows, device=device).play_packed(SEQ_KS, **kw)

    runs = {'k1_drag': walk('dense', 'drag'),
            'k1_two_buckets': walk('dense', 'two_buckets'),
            'k2_shapes': walk('panel', 'shapes'),
            'k7_two_buckets': walk('sparse', 'two_buckets'),
            'k5_vstack': stack('vstack'),
            'k5_mixed_wide': stack('mixed_wide'),
            'k6_vstack3': stack_seq()}
    rec = {'phase': 'small_narrow', 'case': 'bf16_f16'}
    for key, run in runs.items():
        f32 = run('cuda')
        for name in NARROW:
            dt = getattr(torch, name)
            got = run('cuda', out_dtype=dt)
            torch.cuda.synchronize()
            e = near_narrow(got, run('cpu', out_dtype=dt))
            rec[f'{key}_{name}'] = {
                'vs_plain': e, 'rounds_f32': bool(torch.equal(got,
                                                              f32.to(dt))),
                'ok': bool(got.dtype == dt and e <= 1
                           and torch.equal(got, f32.to(dt)))}
    for key, v in rec.items():
        if isinstance(v, dict) and not v['ok']:
            fail.append(f"small_narrow {key}")
    log(rec, brief_checks(rec))


def main_path(label, fn, fail, must, absent=()):
    """Run one main path with the launch counts set to 0 just before it and
    read just after -> (result, wall seconds, nonzero counts).  ``must``
    maps each kernel that has to launch to its exact count (None: any);
    the kernels in ``absent`` must not launch."""
    import torch

    from waveforms_tpu_torch import kernels
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    MAIN_COUNTS.append((label, counts))
    MAIN_WINDOWED.append((label, kernels.synth_dense.windowed_launches))
    for k, n in must.items():
        if counts[k] == 0 or (n is not None and counts[k] != n):
            fail.append(f"{label}: {k} launched {counts[k]} times, "
                        f"expected {n or 'some'}")
    for k in absent:
        if counts[k]:
            fail.append(f"{label}: {k} launched {counts[k]} times, "
                        "expected none")
    return out, wall, {k: n for k, n in counts.items() if n}


def shots_err(got, plain):
    """rel_err_t (f32) or the largest code difference (int16) over the
    shots of two (n_shots, C, N) outputs, one shot at a time."""
    if got.dtype.is_floating_point:
        return max(rel_err_t(g, p) for g, p in zip(got, plain))
    return max(int((g.int() - p.int()).abs().max())
               for g, p in zip(got, plain))


def timed(rec, launch, plain, out, n_samples):
    """Kernel, plain-version and fill times of one output (``launch`` and
    ``plain`` write into it), and the rates over its ``n_samples``
    samples."""
    rec['kernel_ms'] = cuda_ms(launch)
    rec['plain_ms'] = cuda_ms(plain, reps=3)
    rec['fill_ms'] = cuda_ms(lambda: out.fill_(0))
    rec['gsps'] = n_samples / rec['kernel_ms'] / 1e6
    rec['store_share'] = rec['fill_ms'] / rec['kernel_ms']


class Oracle:
    """The float64 oracle of single channels, computed once each."""

    def __init__(self, chans, stop):
        self.chans, self.stop, self.cache = chans, stop, {}

    def err(self, got, picks):
        """rel_err of got[shot, c] against schedule k's channel c for each
        (shot, k, c) in ``picks``; int16 ``got`` -> code_err."""
        import numpy as np

        import waveforms_tpu_torch as wt
        from waveforms_tpu_torch.engine import _quantize_host
        from waveforms_tpu_torch.schedules import FS
        errs = []
        for shot, k, c in picks:
            if (k, c) not in self.cache:
                self.cache[k, c] = wt.synthesize(
                    [self.chans[k][c]], 0.0, self.stop, FS, engine='numpy')
            want = self.cache[k, c]
            g = got[shot, c][None].cpu().numpy()
            errs.append(code_err(g, _quantize_host(want, np.int16, 32767.0))
                        if g.dtype == np.int16 else rel_err(g, want))
        return max(errs)


def brief_seq(rec):
    keys = ('phase', 'method', 'dtype', 'ok', 'launches', 'shots',
            'vs_plain', 'vs_oracle', 'vs_k5', 'kernel_ms', 'plain_ms',
            'fill_ms', 'gsps', 'us_per_shot', 'store_share', 'gather_ms',
            'bound_ms', 'bound_by')
    return {k: rec[k] for k in keys if k in rec}


def run_sequences(fail, summary):
    """The sequence tables' main paths at full size, each with its launch
    counts read right after it, then each kernel against its plain version
    and the oracle, and its times.  Fills K6's summary entry."""
    import numpy as np
    import torch

    from waveforms_tpu_torch import kernels
    from waveforms_tpu_torch.ops import Sequencer, StackSequencer
    from waveforms_tpu_torch.ops.lowering import lower_schedule
    from waveforms_tpu_torch.ops.stack_synth import (build_stack_plan,
                                                     build_stack_tables)
    from waveforms_tpu_torch.schedules import (FS, build_schedule,
                                               station_channels)

    def finish(rec, tol_ok):
        # device time per shot; the replay sets its own (the gather's)
        rec.setdefault('us_per_shot', rec['kernel_ms'] * 1e3 / rec['shots'])
        rec['ok'] = bool(tol_ok)
        log(rec, brief_seq(rec))
        if not rec['ok']:
            fail.append(f"{rec['phase']} {rec.get('method')} "
                        f"{rec.get('dtype')}")
        torch.cuda.empty_cache()

    def ok_errs(rec):
        if rec['dtype'] == 'int16':
            return max(rec['vs_plain'], rec['vs_oracle']) <= TOL_CODES
        return rec['vs_plain'] <= TOL_PLAIN and rec['vs_oracle'] <= TOL_ORACLE

    # ---- seq_flagship: 8 flagship schedules, play / play_sparse / play_many
    host = {}
    t0 = time.perf_counter()
    chans = [build_schedule(seed=s) for s in range(8)]
    lows = [lower_schedule(c, 0.0, 1e-3, FS) for c in chans]
    host['build_and_lower_8'] = time.perf_counter() - t0
    t0 = time.perf_counter()
    seq = Sequencer(lows, device='cuda')
    torch.cuda.synchronize()
    host['table_upload'] = time.perf_counter() - t0
    oracle = Oracle(chans, 1e-3)
    C, N = seq.shape[0], seq.n_samples
    rng = np.random.default_rng(4)
    k = int(rng.integers(0, 8))
    base = {'phase': 'seq_flagship', 'table': seq.describe(), 'host_s': host}

    out, wall, cnt = main_path('seq_flagship play', lambda: seq.play(k),
                               fail, {'synth_dense': 1})
    dev = seq._schedule(k)
    plain = kernels.synth_dense.plain(dev, torch.empty_like(out), None)
    rec = dict(base, method='play', dtype='float32', shots=1, launches=cnt,
               wall_s=wall, vs_plain=rel_err_t(out, plain),
               vs_oracle=oracle.err(out[None], [(0, k, 0), (0, k, C - 1)]))
    del plain
    timed(rec, lambda: kernels.synth_dense(dev, out, None),
          lambda: kernels.synth_dense.plain(dev, out, None), out, C * N)
    finish(rec, ok_errs(rec))
    del out

    out, wall, cnt = main_path('seq_flagship play_sparse',
                               lambda: seq.play_sparse(k), fail,
                               {'synth_sparse': 1})
    dev, work = seq._sparse_args(k, 32)
    plain = kernels.synth_sparse.plain(dev, work, torch.zeros_like(out),
                                       None)
    rec = dict(base, method='play_sparse', dtype='float32', shots=1,
               launches=cnt, wall_s=wall, vs_plain=rel_err_t(out, plain),
               vs_oracle=oracle.err(out[None], [(0, k, 1)]))
    del plain
    timed(rec, lambda: kernels.synth_sparse(dev, work, out, None),
          lambda: kernels.synth_sparse.plain(dev, work, out, None), out,
          C * N)
    finish(rec, ok_errs(rec))
    del out

    ks = [int(rng.integers(0, 8)), 99, -1]
    clamped = [seq._clamp(x) for x in ks]
    out, wall, cnt = main_path('seq_flagship play_many',
                               lambda: seq.play_many(ks), fail,
                               {'synth_dense': len(ks)})
    devs = [seq._schedule(x) for x in clamped]
    plain = torch.empty_like(out)
    for i, d in enumerate(devs):
        kernels.synth_dense.plain(d, plain[i], None)
    rec = dict(base, method='play_many', dtype='float32', shots=len(ks),
               launches=cnt, wall_s=wall, vs_plain=shots_err(out, plain),
               vs_oracle=oracle.err(out, [(1, 7, 0), (2, 0, C - 1)]))
    del plain
    timed(rec, lambda: [kernels.synth_dense(d, out[i], None)
                        for i, d in enumerate(devs)],
          lambda: [kernels.synth_dense.plain(d, out[i], None)
                   for i, d in enumerate(devs)], out, len(ks) * C * N)
    finish(rec, ok_errs(rec) and clamped == [ks[0], 7, 0])
    del out

    # ---- seq_flagship_packed: 8 shots in one panel-kernel launch
    order = np.random.default_rng(8).permutation(8)
    for dtype in (torch.float32, torch.int16):
        okw = {} if dtype == torch.float32 else {'out_dtype': dtype}
        out, wall, cnt = main_path(
            'seq_flagship_packed', lambda: seq.play_packed(order, **okw),
            fail, {'synth_panel': 1})
        ks_dev = torch.as_tensor(order, device='cuda')
        plan, work = seq._packed_work(ks_dev, 8)
        packed = seq._packed_tensors()
        scale = (torch.full((C,), 32767.0, device='cuda')
                 if dtype == torch.int16 else None)
        raw = torch.empty((C, plan.total_rows * 128), dtype=dtype,
                          device='cuda')
        kernels.synth_panel.plain(packed, work, raw, scale)
        rows = plan.tps * 8 * 128
        plain = raw.unflatten(1, (len(order), rows))[..., :N].permute(1, 0, 2)
        rec = dict(base, phase='seq_flagship_packed', method='play_packed',
                   dtype=str(dtype)[6:], shots=len(order), launches=cnt,
                   wall_s=wall, items=plan.n_items, panels=plan.NP,
                   vs_plain=shots_err(out, plain),
                   vs_oracle=oracle.err(out, [(0, int(order[0]), 0),
                                              (1, int(order[1]), C - 1)]))
        del plain
        timed(rec, lambda: kernels.synth_panel(packed, work, raw, scale),
              lambda: kernels.synth_panel.plain(packed, work, raw, scale),
              raw, len(order) * C * N)
        finish(rec, ok_errs(rec))
        del out, raw
    del seq, dev, devs, packed, work

    # ---- seq_station: 16 gate-train schedules (2 ch x 200,000 samples)
    rng = np.random.default_rng(11)
    chans = station_channels(rng)
    lows = [lower_schedule(ch, 0.0, 1e-4, FS) for ch in chans]
    seq = Sequencer(lows, device='cuda')
    oracle = Oracle(chans, 1e-4)
    C, N = seq.shape[0], seq.n_samples
    ks = rng.integers(0, 16, 50)
    base = {'phase': 'seq_station', 'table': seq.describe()}
    out, wall, cnt = main_path('seq_station play_packed',
                               lambda: seq.play_packed(ks, Rs=8), fail,
                               {'synth_panel': 1})
    plan, work = seq._packed_work(torch.as_tensor(ks, device='cuda'), 8)
    packed = seq._packed_tensors()
    raw = torch.empty((C, plan.total_rows * 128), device='cuda')
    kernels.synth_panel.plain(packed, work, raw, None)
    plain = raw.unflatten(1, (len(ks), plan.tps * 8 * 128))[..., :N]
    rec = dict(base, method='play_packed', dtype='float32', shots=len(ks),
               launches=cnt, wall_s=wall, items=plan.n_items,
               vs_plain=shots_err(out, plain.permute(1, 0, 2)),
               vs_oracle=oracle.err(out, [(0, int(ks[0]), 0),
                                          (1, int(ks[1]), 1)]))
    timed(rec, lambda: kernels.synth_panel(packed, work, raw, None),
          lambda: kernels.synth_panel.plain(packed, work, raw, None), raw,
          len(ks) * C * N)
    finish(rec, ok_errs(rec))
    del out, raw, plain

    ks = rng.integers(0, 16, 1000)
    out, wall, cnt = main_path('seq_station play_replay',
                               lambda: seq.play_replay(ks), fail,
                               {'synth_dense': 16})
    pal = seq._palettes[next(iter(seq._palettes))]
    devs = [seq._schedule(x) for x in range(16)]
    plain = torch.empty_like(pal)
    for x, d in enumerate(devs):
        kernels.synth_dense.plain(d, plain[x], None)
    ks_dev = torch.as_tensor(ks, device='cuda')
    rec = dict(base, method='play_replay', dtype='float32', shots=len(ks),
               launches=cnt, wall_s=wall,
               vs_plain=shots_err(pal, plain),
               gathered_exact=bool(torch.equal(out, pal[ks_dev])),
               vs_oracle=oracle.err(out, [(0, int(ks[0]), 0),
                                          (999, int(ks[999]), 1)]))
    timed(rec, lambda: [kernels.synth_dense(d, pal[x], None)
                        for x, d in enumerate(devs)],
          lambda: [kernels.synth_dense.plain(d, pal[x], None)
                   for x, d in enumerate(devs)], pal, 16 * C * N)
    rec['gather_ms'] = cuda_ms(
        lambda: torch.index_select(pal, 0, ks_dev, out=out))
    rec['us_per_shot'] = rec['gather_ms'] * 1e3 / len(ks)
    finish(rec, ok_errs(rec) and rec['gathered_exact'])
    del out, pal, plain, seq, devs

    # ---- stackseq_ladder: 4 ladder120 schedules, 16 shots on K6
    host = {}
    t0 = time.perf_counter()
    chans = [schedule(('ladder', s)) for s in LADDER_SEEDS]
    host['build_4_wait'] = time.perf_counter() - t0
    t0 = time.perf_counter()
    lows = [lower_schedule(c, 0.0, 524.288e-6, FS, bucket_samples=None)
            for c in chans]
    host['lower_4'] = time.perf_counter() - t0
    t0 = time.perf_counter()
    plans = [build_stack_plan(low) for low in lows]
    host['stack_plans'] = time.perf_counter() - t0
    t0 = time.perf_counter()
    seq = StackSequencer(lows, plans, device='cuda')
    torch.cuda.synchronize()
    host['tables_and_upload'] = time.perf_counter() - t0
    oracle = Oracle(chans, 524.288e-6)
    C, N = seq.n_channels, seq.n_samples
    t = seq.tables
    ops = sched_ops(t)
    order = np.random.default_rng(16).integers(0, 4, 16)
    base = {'phase': 'stackseq_ladder', 'table': seq.describe(),
            'host_s': host}
    for dtype in (torch.float32, torch.int16):
        okw = {} if dtype == torch.float32 else {'out_dtype': dtype}
        out, wall, cnt = main_path(
            'stackseq_ladder', lambda: seq.play_packed(order, **okw), fail,
            {'synth_stack_seq': 1}, absent=('synth_stack',))
        ks_dev = torch.as_tensor(order, dtype=torch.int32, device='cuda')
        scale = (torch.full((C,), 32767.0, device='cuda')
                 if dtype == torch.int16 else None)
        plain = kernels.synth_stack_seq.plain(t, ks_dev, torch.empty_like(out),
                                              scale)
        rec = dict(base, method='play_packed', dtype=str(dtype)[6:],
                   shots=len(order), launches=cnt, wall_s=wall,
                   vs_plain=shots_err(out, plain),
                   vs_oracle=oracle.err(out, [(0, int(order[0]), 0),
                                              (1, int(order[1]), C - 1)]))
        if dtype == torch.float32:
            rec['max_abs_err'] = max(float((o - p).abs().max())
                                     for o, p in zip(out, plain))
            # shot 0 against K5, the single-schedule stack route
            k5 = kernels.synth_stack(
                build_stack_tables(plans[order[0]], lows[order[0]], 'cuda'),
                torch.empty_like(out[0]), None)
            rec['vs_k5'] = rel_err_t(out[0], k5)
            del k5
        del plain
        timed(rec, lambda: kernels.synth_stack_seq(t, ks_dev, out, scale),
              lambda: kernels.synth_stack_seq.plain(t, ks_dev, out, scale),
              out, len(order) * C * N)
        rec.update(bound(input_bytes(t, ks_dev)
                         + out.numel() * out.element_size(),
                         sum(ops[x] for x in order)))
        if dtype == torch.float32:
            summary['synth_stack_seq'].update(
                ms=rec['kernel_ms'], plain_ms=rec['plain_ms'],
                max_abs_err=rec['max_abs_err'],
                **{k: rec[k] for k in ('bound_ms', 'bound_by',
                                       'bound_bytes', 'bound_ops',
                                       'library_ms')})
        finish(rec, ok_errs(rec) and rec.get('vs_k5', 0.0) <= TOL_PLAIN)
        del out
    STASH['stackseq_ladder'] = (seq, order)    # the mesh phase plays it too
    del seq, t

    # ---- stackseq_rb: 16 randomized-benchmarking-like tables, 1000 shots
    stop = 5.12e-6
    chans = _vstacks(16, 30, 99, stop=stop)
    lows = [lower_schedule(ch, 0.0, stop, FS) for ch in chans]
    seq = StackSequencer(lows, device='cuda')
    oracle = Oracle(chans, stop)
    N = seq.n_samples
    order = np.arange(1000) % 16
    out, wall, cnt = main_path(
        'stackseq_rb', lambda: seq.play_packed(order), fail,
        {'synth_stack_seq': 1}, absent=('synth_stack',))
    ks_dev = torch.as_tensor(order, dtype=torch.int32, device='cuda')
    t = seq.tables
    plain = kernels.synth_stack_seq.plain(t, ks_dev, torch.empty_like(out),
                                          None)
    rec = {'phase': 'stackseq_rb', 'table': seq.describe(),
           'method': 'play_packed', 'dtype': 'float32', 'shots': 1000,
           'launches': cnt, 'wall_s': wall,
           'vs_plain': shots_err(out, plain),
           'vs_oracle': oracle.err(out, [(x, x, 0) for x in range(4)])}
    del plain
    timed(rec, lambda: kernels.synth_stack_seq(t, ks_dev, out, None),
          lambda: kernels.synth_stack_seq.plain(t, ks_dev, out, None), out,
          1000 * N)
    ops = sched_ops(t)
    rec.update(bound(input_bytes(t, ks_dev) + out.numel() * 4,
                     sum(ops[x] for x in order)))
    finish(rec, ok_errs(rec))


def compact_err(work, got, plain, peak):
    """Max over items of |got - plain| / the peak of the item's channel,
    for (K, Rs, 128) compact worklist outputs."""
    n = got.shape[0]
    return float(((got - plain).abs().reshape(n, -1).amax(dim=1)
                  / peak[work.work_c.long()]).max())


def sparse_peaks(dev, work, window):
    """Each channel's peak of the worklist kernel's plain version."""
    import torch

    from waveforms_tpu_torch import kernels
    out = torch.zeros((dev.shape[0], window), device=dev.device)
    return kernels.synth_sparse.plain(dev, work, out, None).abs().amax(
        dim=1).clamp_min(1e-30)


def check_probes(fail):
    """Phase 2, the probes: P4, P2 (every variant) and P3 (every body) at
    K = 64 against their plain versions on the card, exactly; P1's compact
    kernel on the flagship's first 8 channels over 32.768 us, on its
    worklist and on the worklist padded 4x, within TOL_PLAIN of each
    channel's peak of K7's plain version, and K7 on the padded worklist
    against K7 on the unpadded one, exactly."""
    import torch

    from waveforms_tpu_torch import kernels, probes
    from waveforms_tpu_torch.ops.reference_probes import WALKER_BODIES

    def exact(key, got, plain):
        e = float((got - plain).abs().max())
        rec[key] = {'vs_plain': e, 'ok': bool(torch.equal(got, plain))}

    rec = {'phase': 'small_probes', 'case': 'K64'}
    x = torch.linspace(-3, 3, 8 * 128, device='cuda').reshape(8, 128)
    exact('health', kernels.probe_health(x, torch.empty_like(x)),
          kernels.probe_health.plain(x, torch.empty_like(x)))
    inp = probes.grid_inputs(64)
    for name in probes.GRID_VARIANTS:
        exact(f'grid_{name}', probes.run_grid(name, inp,
                                               probes.grid_out(name, inp)),
              probes.run_grid(name, inp, probes.grid_out(name, inp),
                              kernels.probe_grid.plain))
    inp = probes.walker_inputs(64)
    for body, _ in WALKER_BODIES:
        out = torch.zeros((64, probes.RS, 128), device='cuda')
        exact(f'walker_{body}', probes.run_walker(body, inp, out),
              probes.run_walker(body, inp, torch.zeros_like(out),
                                kernels.probe_walker.plain))
    sp = probes.sparse_inputs(8, 32.768e-6)
    dev, work, padded = sp['dev'], sp['work'], sp['padded']
    window = sp['plan'].window_samples
    peak = sparse_peaks(dev, work, window)
    for key, w in (('compact', work), ('compact_pad4', padded)):
        n = w.work_c.shape[0]
        got = kernels.probe_sparse_compact(
            dev, w, torch.empty((n, probes.RS, 128), device='cuda'))
        e = compact_err(w, got, kernels.probe_sparse_compact.plain(
            dev, w, torch.empty_like(got)), peak)
        rec[key] = {'vs_plain': e, 'items': n,
                    'ok': e <= TOL_PLAIN and bool(
                        (got[work.work_c.shape[0]:] == 0).all())}
    k7 = [kernels.synth_sparse(dev, w, torch.zeros((dev.shape[0], window),
                                                   device='cuda'), None)
          for w in (work, padded)]
    exact('k7_pad4_vs_k7', k7[1], k7[0])
    torch.cuda.synchronize()
    for key, v in rec.items():
        if isinstance(v, dict) and not v['ok']:
            fail.append(f"small_probes {key}")
    log(rec, brief_checks(rec))


# the kernels held to no spill: the tile walkers K1, K3, K7 and P1 and the
# row walkers K5 and K6 (their ptxas entry functions contain these names)
WALKERS = ('synth_dense', 'synth_stack', 'synth_sparse',
           'probe_sparse_compact')
# the kernels whose summary rows carry the one-launch floor: the short ones
FLOOR_ROWS = ('synth_sparse', 'probe_sparse_compact', 'probe_health')


def launch_floor_ms():
    """The time one empty kernel launch takes under the kernels' timer:
    ``torch.cuda._sleep(0)`` timed by ``cuda_ms`` (CUDA events behind the
    queued sleep), the least time any kernel can show there."""
    import torch
    return cuda_ms(lambda: torch.cuda._sleep(0))


# the probe variant whose time stands in the kernel summary (the others
# are in the probes' own lines)
SUMMARY_GRID, SUMMARY_WALKER = 'op13_dyn', 'base'


def run_probes(fail, summary):
    """The probes' main path: P4, P1, P2 and P3 at the JAX tasks' full
    sizes through ``waveforms_tpu_torch.probes``, with the launch counts
    read right after; each result on its own line.  Then, on the same
    inputs, every P2 variant and P3 body against its plain version,
    exactly, and P1's compact output within TOL_PLAIN of each channel's
    peak; fills the probe kernels' summary entries."""
    import torch

    from waveforms_tpu_torch import kernels, probes
    from waveforms_tpu_torch.ops.reference_probes import WALKER_BODIES

    res = {}

    def drive():
        res['health'] = probes.health_probe()
        res['sparse'] = probes.sparse_step_cost_probe()
        res['grid'] = probes.grid_overhead_probe()
        res['walker'] = probes.walker_cost_probe()

    _, wall, cnt = main_path(
        'probes', drive, fail,
        {'probe_health': None, 'probe_grid': None, 'probe_walker': None,
         'probe_sparse_compact': None, 'synth_sparse': None})
    for r in res.values():
        log(r)
    times = [v for r in res.values() for k, v in r.items()
             if k.endswith('_ms') or k in probes.GRID_VARIANTS
             or k in dict(WALKER_BODIES)]
    ok_times = all(0 < t < float('inf') for t in times)
    rec = {'phase': 'probes', 'launches': cnt, 'wall_s': wall,
           'health_ok': res['health']['ok'], 'times_ok': ok_times}

    # P4: the kernel, its plain version, and torch.mul (the same call)
    x = torch.ones((8, 128), device='cuda')
    y = kernels.probe_health(x, torch.empty_like(x))
    p = kernels.probe_health.plain(x, torch.empty_like(x))
    summary['probe_health'].update(
        max_abs_err=float((y - p).abs().max()), ms=res['health']['ms'],
        plain_ms=cuda_ms(lambda: kernels.probe_health.plain(x, p)),
        **bound(2 * x.numel() * 4, 0))
    summary['probe_health']['library_ms'] = cuda_ms(
        lambda: torch.mul(x, 2.0, out=p))

    # P2: every variant at K = 4096 against its plain version
    inp = probes.grid_inputs()
    K = inp['wc'].shape[0]
    errs = {}
    for name in probes.GRID_VARIANTS:
        got = probes.run_grid(name, inp, probes.grid_out(name, inp))
        plain = probes.run_grid(name, inp, probes.grid_out(name, inp),
                                kernels.probe_grid.plain)
        errs[name] = float((got - plain).abs().max())
        if not torch.equal(got, plain):
            fail.append(f"probes grid {name} differs from its plain version")
    out = probes.grid_out(SUMMARY_GRID, inp)
    n_ops = probes.GRID_VARIANTS[SUMMARY_GRID][0]
    summary['probe_grid'].update(
        max_abs_err=max(errs.values()),
        ms=res['grid'][SUMMARY_GRID] * K / 1e3,
        plain_ms=cuda_ms(lambda: probes.run_grid(
            SUMMARY_GRID, inp, out, kernels.probe_grid.plain)),
        **bound(input_bytes(*inp['tables'][:n_ops], inp['wc'], inp['wo'])
                + out.numel() * 4, 0))
    rec['grid_vs_plain'] = errs
    del out, got, plain

    # P3: every body at K = 2048 against its plain version
    inp = probes.walker_inputs()
    K = inp['wc'].shape[0]
    errs = {}
    out = torch.zeros((K, probes.RS, 128), device='cuda')
    for body, _ in WALKER_BODIES:
        got = probes.run_walker(body, inp, out)
        plain = probes.run_walker(body, inp, torch.zeros_like(out),
                                  kernels.probe_walker.plain)
        errs[body] = float((got - plain).abs().max())
        if not torch.equal(got, plain):
            fail.append(f"probes walker {body} differs from its plain "
                        "version")
    summary['probe_walker'].update(
        max_abs_err=max(errs.values()),
        ms=res['walker'][SUMMARY_WALKER] * K / 1e3,
        plain_ms=cuda_ms(lambda: probes.run_walker(
            SUMMARY_WALKER, inp, out, kernels.probe_walker.plain)),
        **bound(input_bytes(*inp.values()) + out.numel() * 4, 0))
    rec['walker_vs_plain'] = errs
    del out, plain

    # P1: the compact kernel, and K7 as P1 launches it (on the worklist and
    # on it padded 4x), on the flagship plan against their plain versions
    sp = probes.sparse_inputs()
    dev, work = sp['dev'], sp['work']
    window = sp['plan'].window_samples
    peak = sparse_peaks(dev, work, window)
    K = work.work_c.shape[0]
    got = kernels.probe_sparse_compact(
        dev, work, torch.empty((K, probes.RS, 128), device='cuda'))
    plain = kernels.probe_sparse_compact.plain(dev, work,
                                               torch.empty_like(got))
    rec['compact_vs_plain'] = compact_err(work, got, plain, peak)
    summary['probe_sparse_compact'].update(
        max_abs_err=float((got - plain).abs().max()),
        ms=res['sparse']['compact_ms'],
        plain_ms=cuda_ms(lambda: kernels.probe_sparse_compact.plain(
            dev, work, plain), reps=3),
        **bound(input_bytes(dev, work) + got.numel() * 4,
                walk_ops(sp['low'])))
    del got, plain
    rec['k7_vs_plain'] = {}
    for key, w in (('aliased', work), ('aliased_pad4', sp['padded'])):
        got = kernels.synth_sparse(
            dev, w, torch.zeros((dev.shape[0], window), device='cuda'), None)
        plain = kernels.synth_sparse.plain(
            dev, w, torch.zeros_like(got), None)
        rec['k7_vs_plain'][key] = float(
            ((got - plain).abs().amax(dim=1) / peak).max())
        summary['synth_sparse']['max_abs_err'] = max(
            summary['synth_sparse']['max_abs_err'] or 0.0,
            float((got - plain).abs().max()))
        del got, plain
    rec['ok'] = bool(rec['health_ok'] and ok_times
                     and rec['compact_vs_plain'] <= TOL_PLAIN
                     and max(rec['k7_vs_plain'].values()) <= TOL_PLAIN
                     and not any(rec['grid_vs_plain'].values())
                     and not any(rec['walker_vs_plain'].values()))
    if not rec['ok']:
        fail.append("probes")
    log(rec)


# The signal chain's filters (tests/test_station_e2e.py, test_ops_iir_fft.py):
# the station's Z-settle inverse pair (d = 2 combined), the clustered
# three-pole exp-settling filter (d = 3 as (b, a), three first-order
# sections as zpk; ops/iir_cases.py's CLUSTERED), each real section on the
# recurrence kernel S1 on the card, and the readout tones FR - READ_LO.
Z_SETTLE = ([0.02, 0.005], [3e-6, 20e-6])
TONES = [6.87836e9 - 6.99e9, 6.92248e9 - 6.99e9]
# vs scipy on the host, of each row's peak.  The Z-settle bound is set by
# the doubling scan that the JAX package runs there (and the port on CPU
# tensors): its doubling lfilter of the Z-settle pair (poles 1 - 2.5e-5,
# 1 - 1.7e-4) is 5.8e-9 off scipy on row 109 of these rows (float64, on
# the CPU, where the port's path equals it; tests/test_torch_signal.py
# holds both to this bound and the reference above 1e-9); the card's S1 is
# held to it unchanged, and to S1's contract below; the
# direct form and zpk bounds are the JAX suite's
# (tests/test_ops_iir_fft.py), the FFT's its rtol.
TOL_DOUBLING = 2e-8
TOL_DIRECT_FORM = 1e-5
TOL_ZPK = 2e-8
TOL_FFT = 1e-9
TOL_DEMOD = 1e-4       # IQ points, of their peak (tests/test_station_e2e.py)
# S1 is a blocked scan (csrc/iir_df2t.cu): chunks of kernels.iir_df2t_chunk()
# samples, the state carried across them in double-double.  Its contract:
# the first chunk of every row equal to its plain sequential version
# (reference_iir.df2t) bit for bit; every output and final state equal to
# the plain model of its arithmetic (reference_iir.df2t_blocked) bit for
# bit, here over the first S1_COLS columns of the main path's 128 rows (the
# filter and the carry are causal, so those columns do not depend on the
# rest); no farther from scipy's lfilter in np.longdouble than TOL_S1_LD
# times the sequential recurrence, or TOL_S1_FLOOR where that is larger
# (distances as rows_err); and the direct-form bound against scipy.
S1_COLS = 20_000
TOL_S1_LD = 2.0
TOL_S1_FLOOR = 1e-13
TOL_STREAM_SOS = 1e-9  # streamed sosfilt vs the whole row's, of the peak
TOL_STREAM_HOST = 2e-7  # absolute, vs scipy (tests/test_streaming.py)


def seeded_rows(n, k, seed):
    import numpy as np
    return sorted(int(r) for r in np.random.default_rng(seed).choice(
        n, k, replace=False))


def rows_err(got, want):
    """max over rows of max|got - want| / max|want| (numpy rows)."""
    import numpy as np
    return max(float(np.abs(g - w).max() / max(np.abs(w).max(), 1e-300))
               for g, w in zip(got, want))


def s1_rows(b, a, x):
    """Normalised coefficients of (b, a) and a zero state for S1 over x."""
    import torch

    from waveforms_tpu_torch.ops import iir_cases
    coef = iir_cases.coefficients(b, a, x.dtype, x.device)
    return coef, torch.zeros((x.shape[0], len(coef) // 2 - 1),
                             dtype=x.dtype, device=x.device)


def long_double(coef, rows):
    """scipy's lfilter of numpy rows in np.longdouble (80-bit on x86) with
    S1's normalised coefficients ``coef`` (b then a), from a zero state."""
    import numpy as np
    import scipy.signal as sps
    c = coef.double().cpu().numpy().astype(np.longdouble)
    d = len(c) // 2 - 1
    return [sps.lfilter(c[:d + 1], c[d + 1:], h.astype(np.longdouble))
            for h in rows]


def s1_contract(y, zf, x, coef, zi, y_plain, zf_plain):
    """S1's outputs ``y``, ``zf`` over rows ``x`` against its contract's
    bit-equalities on the card: the first chunk against the plain
    sequential version's outputs ``y_plain``, ``zf_plain`` over the same
    rows, and y and zf against the plain model of the blocked arithmetic
    -> record, with the largest absolute difference from each
    (``max_abs_err`` from the plain version over every column and the
    final state)."""
    import torch

    from waveforms_tpu_torch import kernels
    from waveforms_tpu_torch.ops import reference_iir
    L = kernels.iir_df2t_chunk()
    m = min(L, x.shape[1])
    yb, zfb = torch.empty_like(x), torch.empty_like(zi)
    reference_iir.df2t_blocked(x, coef, zi, yb, zfb, L)
    rec = {'shape': list(x.shape), 'chunk': L,
           'first_chunk_equal': bool(torch.equal(y[:, :m],
                                                 y_plain[:, :m])),
           'model_equal': bool(torch.equal(y, yb) and torch.equal(zf, zfb)),
           'max_abs_err': float(max((y - y_plain).abs().max(),
                                    (zf - zf_plain).abs().max())),
           'max_abs_err_vs_model': float(max((y - yb).abs().max(),
                                             (zf - zfb).abs().max()))}
    rec['ok'] = rec['first_chunk_equal'] and rec['model_equal']
    return rec


def s1_main_check(coef, zi, x, y_main):
    """S1 on the main path's rows: its plain version (timed) and the plain
    model of its arithmetic over the first S1_COLS columns of every row of
    x, held to those columns of the main path's output ``y_main`` and to
    an S1 launch on them with its final state -> (record, the plain
    version's and the launch's outputs over those columns)."""
    import torch

    from waveforms_tpu_torch import kernels
    xk = x[:, :S1_COLS].contiguous()
    L = kernels.iir_df2t_chunk()
    yp, zfp = torch.empty_like(xk), torch.empty_like(zi)
    plain_ms = cuda_ms(lambda: kernels.iir_df2t.plain(xk, coef, zi, yp, zfp),
                       reps=1)
    yk, zfk = torch.empty_like(xk), torch.empty_like(zi)
    kernels.iir_df2t(xk, coef, zi, yk, zfk)
    rec = {'launch': s1_contract(yk, zfk, xk, coef, zi, yp, zfp)}
    head = y_main[:, :S1_COLS]
    rec['main_path'] = {'first_chunk_equal': bool(torch.equal(head[:, :L],
                                                              yp[:, :L])),
                        'equal_to_launch': bool(torch.equal(head, yk)),
                        'max_abs_err': float((head - yk).abs().max())}
    rec['main_path']['ok'] = (rec['main_path']['first_chunk_equal']
                              and rec['main_path']['equal_to_launch'])
    rec['plain_ms'] = plain_ms
    rec['ok'] = rec['launch']['ok'] and rec['main_path']['ok']
    return rec, yp, yk


def lfilter_doubling(b, a, x):
    """The JAX package's doubling scan of (b, a) over the rows of x, from
    a zero state (``ops.iir._doubling_df2t``, the route CPU tensors take
    where it is stable): the comparison beside S1 on the card."""
    from waveforms_tpu_torch.ops import iir
    bb, aa, d = iir._normalised(b, a)
    M, k = iir._state_space(bb, aa, d)
    return iir._doubling_df2t(iir._like(M, x), iir._like(k, x),
                              float(bb[0]), x, x.new_zeros((d,)))[0]


def zpk_doubling(z, p, k, x):
    """The JAX package's ``filter_zpk`` of real roots over the rows of x:
    the gain, then each real zero as a 1-tap FIR and the real pole at its
    index as an AR1 doubling scan (``ops.iir._ar1_doubling``)."""
    import numpy as np

    from waveforms_tpu_torch.ops import iir
    zr = sorted(np.real(z), reverse=True)
    pr = sorted(np.real(p), reverse=True)
    y = x * float(np.real(k))
    for zero, pole in zip(zr, pr):
        y = iir._ar1_doubling(pole, y - zero * iir._delay(y))
    return y


def zpk_rows(z, p, k, rows, dtype):
    """filter_zpk of real roots over numpy rows as the card runs it -- the
    gain, then each real pole with the real zero at its index as one
    first-order section -- by scipy's lfilter in ``dtype`` (float64: the
    sequential recurrence S1 is held against; np.longdouble: the
    long-double answer)."""
    import numpy as np
    import scipy.signal as sps
    zr = sorted(np.real(z), reverse=True)
    pr = sorted(np.real(p), reverse=True)
    out = []
    for h in rows:
        y = h.astype(dtype) * dtype(np.real(k))
        for zero, pole in zip(zr, pr):
            y = sps.lfilter(np.array([1, -zero], dtype),
                            np.array([1, -pole], dtype), y)
        out.append(y)
    return out


def signal_flagship(fail, summary):
    """The flagship's f32 plane from ``synthesize`` (K7), pre-compensated
    in f64 on all 128 rows -- lfilter of the Z-settle pair, lfilter of the
    clustered filter, each one S1 call, and filter_zpk of it, three S1
    calls of one real pole and zero each -- then the Z-settle output
    through a 31-tap Hann FFT convolution and demodulated against the two
    readout tones -> (128, 2).  Each stage is a main path with its counts
    read right after it; each against scipy on 4 seeded rows, each filter
    stage also against the long-double answer (S1's contract) and timed
    beside the doubling scan that the JAX package runs there, called
    directly on the same rows.  S1 against its contract on the main path's
    rows (s1_main_check) and on (8, 20,000) random rows; S1's summary
    entry timed on the flagship's rows, its output held to the main
    path's over the first S1_COLS columns."""
    import numpy as np
    import scipy.signal as sps
    import torch

    import waveforms_tpu_torch as wt
    from waveforms_tpu_torch import kernels
    from waveforms_tpu_torch.distortion import (combine_filters,
                                                exp_decay_filter)
    from waveforms_tpu_torch.ops import (demod_matrix, demodulate,
                                         fft_convolve_centered, filter_zpk,
                                         iir_cases, lfilter,
                                         predistort_device)
    from waveforms_tpu_torch.schedules import FS, build_schedule
    from waveforms_tpu_torch.utils.signal import getFTMatrix

    b_s, a_s = combine_filters([exp_decay_filter(a, t, FS, inv=True)
                                for a, t in zip(*Z_SETTLE)])
    b_c, a_c = exp_decay_filter(*iir_cases.CLUSTERED, FS, output='ba')
    z_c, p_c, k_c = exp_decay_filter(*iir_cases.CLUSTERED, FS, output='zpk')
    hann = sps.windows.hann(31)
    hann /= hann.sum()
    chans = build_schedule()
    sig, wall, cnt = main_path(
        'signal_flagship synthesize',
        lambda: wt.synthesize(chans, 0.0, 1e-3, FS, device='cuda'), fail,
        {'synth_sparse': 1})
    x = sig.double()
    del sig
    C, N = x.shape
    rows = seeded_rows(C, 4, 9)
    host = x[rows].cpu().numpy()
    rec = {'phase': 'signal_flagship', 'shape': [C, N], 'rows': rows,
           'synthesize': {'launches': cnt, 'wall_s': wall}}
    ok = True

    def ba_rows(b, a, dtype):
        c = iir_cases.coefficients(b, a).numpy().astype(dtype)
        d = len(c) // 2 - 1
        return [sps.lfilter(c[:d + 1], c[d + 1:], h.astype(dtype))
                for h in host]

    # (name, main path, scipy's answer and its bound, S1 calls, the
    # sequential recurrence and the long-double answer, the doubling scan)
    stages = (
        ('lfilter_z_settle', lambda: lfilter(b_s, a_s, x),
         lambda h: sps.lfilter(b_s, a_s, h), TOL_DOUBLING, 1,
         lambda t: ba_rows(b_s, a_s, t),
         lambda: lfilter_doubling(b_s, a_s, x)),
        ('lfilter_clustered', lambda: lfilter(b_c, a_c, x),
         lambda h: sps.lfilter(b_c, a_c, h), TOL_DIRECT_FORM, 1,
         lambda t: ba_rows(b_c, a_c, t),
         lambda: lfilter_doubling(b_c, a_c, x)),
        ('filter_zpk_clustered', lambda: filter_zpk(z_c, p_c, k_c, x),
         lambda h: sps.sosfilt(sps.zpk2sos(z_c, p_c, k_c), h), TOL_ZPK, 3,
         lambda t: zpk_rows(z_c, p_c, k_c, host, t),
         lambda: zpk_doubling(z_c, p_c, k_c, x)))
    settled = None
    for name, run, ref, tol, calls, direct, doubling in stages:
        torch.cuda.empty_cache()
        out, wall, cnt = main_path(f'signal_flagship {name}', run, fail,
                                   {'iir_df2t': calls})
        route = 'S1' if cnt.get('iir_df2t') else 'doubling'
        want = [ref(h) for h in host]
        got = out[rows].cpu().numpy()
        truth = direct(np.longdouble)
        seq = direct(np.float64)
        err = rows_err(got, want)
        stage = {'route': route, 'launches': cnt, 'wall_s': wall,
                 'vs_scipy': err, 'tol': tol, 'finite': bool(
                     torch.isfinite(out).all()),
                 'vs_long_double': rows_err(got, truth),
                 'scipy_vs_long_double': rows_err(want, truth),
                 'sequential_vs_long_double': rows_err(seq, truth),
                 'ms': cuda_ms(run, reps=3)}
        # the doubling scan beside it (on the clustered (b, a) filter it
        # is unstable: timed, its output unused)
        torch.cuda.empty_cache()
        stage['doubling_ms'] = cuda_ms(doubling, reps=3)
        if name != 'lfilter_clustered':
            stage['doubling_vs_scipy'] = rows_err(
                doubling()[rows].cpu().numpy(), want)
        stage['ok'] = bool(
            route == 'S1' and err <= tol and stage['finite']
            and cnt.get('iir_df2t') == calls
            and stage['vs_long_double'] <= max(
                TOL_S1_LD * stage['sequential_vs_long_double'],
                TOL_S1_FLOOR))
        rec[name] = stage
        ok &= stage['ok']
        if name == 'lfilter_clustered':
            coef_c, zi_c = s1_rows(b_c, a_c, x)
            s1_main, yp_main, yk_main = s1_main_check(coef_c, zi_c, x, out)
            rec['s1_main_path_contract'] = s1_main
            ok &= s1_main['ok']
        if name == 'lfilter_z_settle':
            settled = out
        del out
        torch.cuda.empty_cache()
    ker = torch.tensor(hann, device='cuda')
    conv, wall, cnt = main_path('signal_flagship fft_convolve_centered',
                                lambda: fft_convolve_centered(settled, ker),
                                fail, {})
    h_set = settled[rows].cpu().numpy()
    want = []
    for h in h_set:
        padded = np.hstack([np.zeros(N), h, np.zeros(N)])
        start = N + len(hann) // 2
        want.append(sps.fftconvolve(padded, hann, mode='full')
                    [start:start + N])
    stage = {'vs_scipy': rows_err(conv[rows].cpu().numpy(), want),
             'tol': TOL_FFT, 'wall_s': wall,
             'ms': cuda_ms(lambda: fft_convolve_centered(settled, ker),
                           reps=3)}
    stage['ok'] = bool(stage['vs_scipy'] <= TOL_FFT)
    rec['fft_convolve_centered'] = stage
    ok &= stage['ok']
    del settled
    m = demod_matrix(TONES, N, FS, device='cuda')
    iq, wall, cnt = main_path('signal_flagship demodulate',
                              lambda: demodulate(conv, m), fail, {})
    h_conv = conv[rows].float().double().cpu().numpy()
    ref = h_conv @ getFTMatrix(TONES, N, sampleRate=FS)
    got = iq[rows].cpu().numpy()
    stage = {'shape': list(iq.shape), 'dtype': str(iq.dtype)[6:],
             'vs_host': float(np.abs(got - ref).max() / np.abs(ref).max()),
             'tol': TOL_DEMOD, 'wall_s': wall,
             'ms': cuda_ms(lambda: demodulate(conv, m), reps=3)}
    stage['ok'] = bool(stage['vs_host'] <= TOL_DEMOD
                       and tuple(iq.shape) == (C, 2)
                       and iq.dtype == torch.complex64)
    rec['demodulate'] = stage
    ok &= stage['ok']
    del conv, iq
    torch.cuda.empty_cache()
    # predistort_device as a user calls it (the Z-settle lfilter on S1,
    # from lfiltic's steady state, then the kernel)
    settle = [exp_decay_filter(a, t, FS, inv=True) for a, t in zip(*Z_SETTLE)]
    rec['predistort_device'] = {
        'ms': cuda_ms(lambda: predistort_device(x, settle, ker=hann),
                      reps=3),
        'lfilter_ms': rec['lfilter_z_settle']['ms'],
        'fft_ms': rec['fft_convolve_centered']['ms']}
    torch.cuda.empty_cache()

    # S1 against its contract on random rows, three filters
    rng = np.random.default_rng(12)
    xs = torch.tensor(rng.standard_normal((8, 20_000)), device='cuda')
    s1 = {}
    for name, (b, a) in iir_cases.filters().items():
        coef, zi = s1_rows(b, a, xs)
        y, zf = torch.empty_like(xs), torch.empty_like(zi)
        kernels.iir_df2t(xs, coef, zi, y, zf)
        yp, zfp = torch.empty_like(xs), torch.empty_like(zi)
        kernels.iir_df2t.plain(xs, coef, zi, yp, zfp)
        s1[name] = s1_contract(y, zf, xs, coef, zi, yp, zfp)
        truth = long_double(coef, xs.cpu().numpy())
        s1[name].update(
            vs_plain=rel_err_t(y, yp),
            vs_long_double=rows_err(y.cpu().numpy(), truth),
            plain_vs_long_double=rows_err(yp.cpu().numpy(), truth))
        s1[name]['ok'] = bool(s1[name]['ok'] and s1[name]['vs_long_double']
                              <= max(TOL_S1_LD
                                     * s1[name]['plain_vs_long_double'],
                                     TOL_S1_FLOOR))
        ok &= s1[name]['ok']
    rec['s1_vs_plain'] = s1
    # S1 on the flagship's rows: the clustered filter, 128 x 2,000,000 f64,
    # its first S1_COLS columns against the main path's (= the model's)
    L = kernels.iir_df2t_chunk()
    y, zf = torch.empty_like(x), torch.empty_like(zi_c)
    ms = cuda_ms(lambda: kernels.iir_df2t(x, coef_c, zi_c, y, zf), reps=3)
    rec['s1_flagship'] = {
        'ms': ms, 'chunk': L,
        'first_chunk_equal': bool(torch.equal(y[:, :L], yp_main[:, :L])),
        'model_equal': bool(torch.equal(y[:, :S1_COLS], yk_main)),
        'max_abs_err': float((y[:, :S1_COLS] - yp_main).abs().max()),
        'max_abs_err_vs_model': float(
            (y[:, :S1_COLS] - yk_main).abs().max()),
        # the CUDA kernels of one call, their launches and device ms
        'cuda_kernels': traced_kernels(
            lambda: kernels.iir_df2t(x, coef_c, zi_c, y, zf),
            r'iir_\w+_kernel')}
    ok &= (rec['s1_flagship']['first_chunk_equal']
           and rec['s1_flagship']['model_equal'])
    d = zi_c.shape[1]
    K = -(-N // L)
    traced = rec['s1_flagship']['cuda_kernels']
    summary['iir_df2t'].update(
        # from the plain version df2t over whole rows (the random ones) and
        # the first S1_COLS columns of the flagship's; from the plain model
        # of the blocked arithmetic, df2t_blocked, over the same
        max_abs_err=max([v['max_abs_err'] for v in s1.values()]
                        + [s1_main['launch']['max_abs_err'],
                           rec['s1_flagship']['max_abs_err']]),
        max_abs_err_vs_model=max(
            [v['max_abs_err_vs_model'] for v in s1.values()]
            + [s1_main['launch']['max_abs_err_vs_model'],
               s1_main['main_path']['max_abs_err'],
               rec['s1_flagship']['max_abs_err_vs_model']]), ms=ms,
        plain_ms=s1_main['plain_ms'], plain_shape=s1_main['launch']['shape'],
        shape=[C, N, d], chunk=L,
        cuda_launches_a_call=traced and sum(
            n for n, _ in traced['kernels'].values()),
        dynamic_smem_bytes=kernels.iir_df2t_smem_bytes(x.dtype),
        # the blocked design's own floor: x read twice (the chunk pass and
        # the output pass) and y written once; the chunk pass's
        # double-double step (3 + 51 d FP64 operations, an FMA two) over
        # every chunk but the last, the output pass's 2 + 4 d
        design_floor=bound(3 * x.numel() * 8, C * (K - 1) * L * (3 + 51 * d)
                           + x.numel() * (2 + 4 * d), peak='fp64'),
        **bound(2 * x.numel() * 8 + 2 * zi_c.numel() * 8, x.numel()
                * (2 + 4 * d), peak='fp64'))
    rec['ok'] = bool(ok)
    del x, y, xs, yp_main, yk_main
    torch.cuda.empty_cache()
    brief = {k: {kk: vv for kk, vv in v.items()
                 if kk in ('route', 'vs_scipy', 'vs_host', 'ms',
                           'doubling_ms', 'vs_long_double',
                           'sequential_vs_long_double', 'ok')}
             for k, v in rec.items() if isinstance(v, dict)
             and k not in ('synthesize', 's1_vs_plain',
                           's1_main_path_contract', 's1_flagship')}
    log(rec, dict(brief, phase='signal_flagship', ok=rec['ok'],
                  s1_vs_plain={k: {kk: v[kk] for kk in (
                      'ok', 'vs_long_double', 'plain_vs_long_double')}
                      for k, v in s1.items()},
                  s1_main_path_contract={
                      'ok': s1_main['ok'], 'plain_ms': s1_main['plain_ms']},
                  s1_flagship=rec['s1_flagship']))
    if not ok:
        fail.append('signal_flagship')


def stream_flagship(fail, summary):
    """``synthesize_stream`` of the flagship, chunk_rows=512 (65,536 samples
    a chunk, 31 chunks, the last trimmed), K1 from row0 = k * 65,536: f32
    equal to one-shot K1 bit for bit; with ``filters=(tf2sos(butter(3,
    0.02)), 0)`` (each of the 2 sections one S1 call a chunk, its state
    carried) against one-shot K1 plus the port's sosfilt over the whole
    row and against scipy on 4 seeded rows; int16 codes equal to one-shot
    K1's.  Each pass a main path with 31 K1 launches."""
    import numpy as np
    import scipy.signal as sps
    import torch

    from waveforms_tpu_torch.ops import sosfilt, synthesize_stream
    from waveforms_tpu_torch.ops.lowering import lower_schedule
    from waveforms_tpu_torch.ops.synth import (DeviceSchedule,
                                               synthesize_device)
    from waveforms_tpu_torch.schedules import FS, build_schedule

    dev = DeviceSchedule(lower_schedule(build_schedule(), 0.0, 1e-3, FS),
                         'cuda')
    C, N = dev.shape[0], dev.n_samples
    chunk_rows = 512
    n_chunks = -(-N // (chunk_rows * 128))
    sos = sps.tf2sos(*sps.butter(3, 0.02))
    rows = seeded_rows(C, 4, 10)
    one = synthesize_device(dev)
    rec = {'phase': 'stream_flagship', 'shape': [C, N],
           'chunk_samples': chunk_rows * 128, 'chunks': n_chunks}
    ok = True

    def stream(**kw):
        return torch.cat(list(synthesize_stream(dev, chunk_rows=chunk_rows,
                                                **kw)), 1)

    def per_chunk_ms(**kw):
        def run():
            for _ in synthesize_stream(dev, chunk_rows=chunk_rows, **kw):
                pass
        return cuda_ms(run, reps=3) / n_chunks

    got, wall, cnt = main_path('stream_flagship f32', stream, fail,
                               {'synth_dense': n_chunks})
    f32 = {'launches': cnt, 'wall_s': wall,
           'equal_one_shot': bool(torch.equal(got, one)),
           'ms_per_chunk': per_chunk_ms()}
    f32['ok'] = f32['equal_one_shot']
    rec['f32'] = f32
    del got
    got, wall, cnt = main_path('stream_flagship filtered',
                               lambda: stream(filters=(sos, 0.0)), fail,
                               {'synth_dense': n_chunks,
                                'iir_df2t': sos.shape[0] * n_chunks})
    whole = sosfilt(sos, one.double())
    host = [sps.sosfilt(sos, one[r].double().cpu().numpy()) for r in rows]
    filt = {'launches': cnt, 'wall_s': wall,
            'vs_whole_row': rel_err_t(got, whole),
            'vs_scipy_abs': max(float(np.abs(got[r].cpu().numpy() - h).max())
                                for r, h in zip(rows, host)),
            'ms_per_chunk': per_chunk_ms(filters=(sos, 0.0))}
    filt['ok'] = bool(got.dtype == torch.float64
                      and filt['vs_whole_row'] <= TOL_STREAM_SOS
                      and filt['vs_scipy_abs'] <= TOL_STREAM_HOST)
    rec['filtered'] = filt
    del got, whole
    torch.cuda.empty_cache()
    codes = synthesize_device(dev, out_dtype=torch.int16)
    got, wall, cnt = main_path('stream_flagship int16',
                               lambda: stream(out_dtype=torch.int16), fail,
                               {'synth_dense': n_chunks})
    i16 = {'launches': cnt, 'wall_s': wall,
           'equal_one_shot': bool(torch.equal(got, codes)),
           'ms_per_chunk': per_chunk_ms(out_dtype=torch.int16)}
    i16['ok'] = i16['equal_one_shot']
    rec['int16'] = i16
    ok = f32['ok'] and filt['ok'] and i16['ok']
    rec['ok'] = bool(ok)
    del got, codes, one
    torch.cuda.empty_cache()
    log(rec)
    if not ok:
        fail.append('stream_flagship')


def seq_station_chain(fail, summary):
    """``run_sequence`` on the seq_station table (16 schedules, 2 ch x
    200,000 samples), 1000 shots in the replay's seeded order, with the
    Z-settle pre-compensation and the two readout tones -> (1000, 2, 2);
    8 shots' IQ points against ``Sequencer.play`` plus scipy's lfilter
    (from lfiltic's zero history) plus ``getFTMatrix`` on the host.  Each
    shot one K1 launch and one S1 call; its time a shot on the host's
    clock (the main path's wall) and on the card's (CUDA events)."""
    import numpy as np
    import scipy.signal as sps
    import torch

    from waveforms_tpu_torch.distortion import (combine_filters,
                                                exp_decay_filter)
    from waveforms_tpu_torch.ops import Sequencer
    from waveforms_tpu_torch.ops.lowering import lower_schedule
    from waveforms_tpu_torch.parallel import run_sequence
    from waveforms_tpu_torch.schedules import FS, station_channels
    from waveforms_tpu_torch.utils.signal import getFTMatrix

    rng = np.random.default_rng(11)      # the seq_station phase's draws
    chans = station_channels(rng)
    rng.integers(0, 16, 50)
    ks = rng.integers(0, 16, 1000)
    seq = Sequencer([lower_schedule(ch, 0.0, 1e-4, FS) for ch in chans],
                    device='cuda')
    ba = [exp_decay_filter(a, t, FS, inv=True) for a, t in zip(*Z_SETTLE)]

    def run():
        return run_sequence(seq, ks, ba_filters=ba, demod_freqs=TONES)

    iq, wall, cnt = main_path('seq_station_chain', run, fail,
                              {'synth_dense': len(ks), 'iir_df2t': len(ks)})
    b, a = combine_filters(ba)
    zi = sps.lfiltic(b, a, np.zeros(len(a) - 1), np.zeros(len(b) - 1))
    ft = getFTMatrix(TONES, seq.n_samples, sampleRate=FS)
    errs = []
    for i in seeded_rows(len(ks), 8, 13):
        sig = seq.play(int(ks[i])).double().cpu().numpy()
        ref = np.stack([sps.lfilter(b, a, r, zi=zi)[0] for r in sig]) @ ft
        got = iq[i].cpu().numpy()
        errs.append(float(np.abs(got - ref).max() / np.abs(ref).max()))
    rec = {'phase': 'seq_station_chain', 'table': seq.describe(),
           'shots': len(ks), 'shape': list(iq.shape),
           'dtype': str(iq.dtype)[6:], 'launches': cnt, 'wall_s': wall,
           'us_per_shot_wall': wall * 1e6 / len(ks),
           'vs_host': max(errs), 'tol': TOL_DEMOD}
    rec['device_ms'] = cuda_ms(run, reps=1)
    rec['us_per_shot'] = rec['device_ms'] * 1e3 / len(ks)
    rec['ok'] = bool(rec['vs_host'] <= TOL_DEMOD
                     and tuple(iq.shape) == (len(ks), 2, 2)
                     and bool(torch.isfinite(torch.view_as_real(iq)).all()))
    del iq, seq
    torch.cuda.empty_cache()
    log(rec)
    if not rec['ok']:
        fail.append('seq_station_chain')


# The shapes the main paths give a filter: (rows, samples, the filter's
# order) -> where.  d = 2 is the Z-settle pair, d = 1 a real pole and zero
# of the clustered filter's zpk form.
IIR_SHAPES = (((128, 2_000_000, 2), 'signal_flagship lfilter, mesh_step'),
              ((128, 2_000_000, 1), 'signal_flagship filter_zpk'),
              ((128, 65_536, 2), 'stream_flagship, a chunk'),
              ((2, 200_000, 2), 'seq_station_chain, a shot'),
              ((32, 1_000_000, 2), 'run_multiproc, a JAX-layout shard'),
              ((128, 250_000, 2), 'run_multiproc, a time-split shard'),
              ((8, 4_096, 2), 'the small mesh and process steps, a shard'))


def iir_routes(fail):
    """The evidence for the card's IIR route: at each shape of IIR_SHAPES,
    f64 rows drawn from a seed, the device time of the doubling scan the
    JAX package runs there (``_doubling_df2t`` for d = 2, the FIR and
    ``_ar1_doubling`` for d = 1) and of one S1 call on the same rows, S1's
    output against the doubling scan's, and the route ``ops.iir._route``
    takes.  The run fails where the route is not S1."""
    import numpy as np
    import torch

    from waveforms_tpu_torch import kernels
    from waveforms_tpu_torch.distortion import (combine_filters,
                                                exp_decay_filter)
    from waveforms_tpu_torch.ops import iir, iir_cases
    from waveforms_tpu_torch.schedules import FS

    b2, a2 = combine_filters([exp_decay_filter(a, t, FS, inv=True)
                              for a, t in zip(*Z_SETTLE)])
    z, p, _ = exp_decay_filter(*iir_cases.CLUSTERED, FS, output='zpk')
    zero, pole = float(np.real(z).max()), float(np.real(p).max())
    rng = np.random.default_rng(14)
    rec = {'phase': 'iir_routes', 'dtype': 'float64', 'cells': []}
    ok = True
    for (R, n, d), where in IIR_SHAPES:
        x = torch.from_numpy(rng.standard_normal((R, n))).cuda()
        if d == 2:
            b, a = b2, a2

            def doubling(x=x):
                return lfilter_doubling(b2, a2, x)
        else:
            b, a = [1.0, -zero], [1.0, -pole]

            def doubling(x=x):
                return iir._ar1_doubling(pole, x - zero * iir._delay(x))
        coef, zi = s1_rows(b, a, x)
        y, zf = torch.empty_like(x), torch.empty_like(zi)
        reps = 3 if R * n > 10**8 else 11
        cell = {'shape': [R, n], 'd': d, 'where': where,
                'route': iir._route(x.device, iir._normalised(b, a)[1], n),
                's1_ms': cuda_ms(lambda: kernels.iir_df2t(x, coef, zi, y,
                                                          zf), reps=reps)}
        torch.cuda.empty_cache()
        cell['doubling_ms'] = cuda_ms(doubling, reps=reps)
        cell['s1_vs_doubling'] = rel_err_t(y, doubling())
        cell['doubling_over_s1'] = cell['doubling_ms'] / cell['s1_ms']
        ok &= cell['route'] == 'S1'
        rec['cells'].append(cell)
        del x, y
        torch.cuda.empty_cache()
    rec['ok'] = bool(ok)
    log(rec)
    if not ok:
        fail.append('iir_routes')


def route_ladder(fail):
    """Phase 8: the routers' occupancy ladder
    (``waveforms_tpu_torch.route_ladder``) on the strata's schedules and
    the rungs built in the workers; fails on a failed check.  Its criteria
    (the card's route on each rung within ROUTE_SLACK of the cheapest
    route, and the card's routes summed no longer than the JAX rule's) are
    recorded in its summary, ``criteria_ok``, and fail the ladder's own
    command, not this run: they are timing margins."""
    from waveforms_tpu_torch import route_ladder as rl
    chans = STASH['chans']
    schedules = {key: chans[key] if key in chans else schedule(('rung', key))
                 for key, _, _ in rl.RUNGS.values()}
    _, summary = rl.run(schedules, log=log)
    if not summary['ok']:
        fail.append("route_ladder")


# The mesh phase: a (4, 2) ('channel', 'time') mesh, on distinct cards when
# the host has two or more and on cuda:0 eight times otherwise.
MESH = (4, 2)
STASH = {}            # inputs an earlier phase made that the mesh reuses


def mesh_devices(n):
    """``n`` mesh slots over the visible cards, round robin -> (devices,
    whether they are distinct cards)."""
    import torch
    k = torch.cuda.device_count()
    return [f'cuda:{i % k}' for i in range(n)], k >= 2


def bits_equal(a, b):
    """Whether two outputs are equal bit for bit (NaN-free outputs)."""
    import torch
    return bool(a.shape == b.shape and a.dtype == b.dtype
                and torch.equal(a, b))


def mesh_small(fail):
    """The mesh at small size, before any timing: a (2, 2) mesh of cards
    against the same mesh of the CPU (the plain versions) on four channels
    of 16,384 samples in four buckets of 4,096 (the dense and worklist
    kernels hold two buckets a time shard, bucket0 = 2 on the second) and
    on one bucket (the panel kernel's narrowed stores): each sharded route
    in f32, int16, bf16 and pair mode, within TOL_PLAIN (int16 within
    TOL_CODES) of the CPU mesh and bit-equal to the same kernel on the
    whole schedule on the card; bf16 equal to the f32 plane rounded once;
    the stacked-table route (K6) and play_packed_sharded; and K1 with
    bucket0 and K6 with chunk0 launched directly against their plain
    versions."""
    import numpy as np
    import torch

    import waveforms_tpu_torch as wt
    from waveforms_tpu_torch import kernels
    from waveforms_tpu_torch.ops import sparse_synth as sp
    from waveforms_tpu_torch.ops.lowering import lower_schedule
    from waveforms_tpu_torch.ops.stack_seq import (StackSequencer,
                                                   synthesize_stack_sharded)
    from waveforms_tpu_torch.ops.synth import (DeviceSchedule,
                                               synthesize_device)
    from waveforms_tpu_torch.parallel.mesh import (channel_mesh,
                                                   shard_schedule,
                                                   synthesize_sharded)
    from waveforms_tpu_torch.schedules import FS

    devices, _ = mesh_devices(4)
    card, cpu = channel_mesh(2, 2, devices), channel_mesh(2, 2, ['cpu'] * 4)
    rng = np.random.default_rng(5)
    stacks = [wt.WaveVStack([(0.3 * wt.cosPulse(40e-9) >> o)
                             for o in rng.uniform(0, 8e-6, 80)])
              for _ in range(4)]
    lows = {(b, part): lower_schedule(
        stacks if part == 'real' else [(0.4 + 0.6j) * w for w in stacks],
        0.0, 8.192e-6, FS, part=part, bucket_samples=b)
        for b in (4096, None) for part in ('real', 'complex')}
    whole = {
        'dense': lambda low, **kw: synthesize_device(
            DeviceSchedule(low, 'cuda'), **kw),
        'panel': lambda low, **kw: sp.synthesize_panels(
            DeviceSchedule(low, 'cuda'), low, Rs=8, **kw),
        'sparse': lambda low, **kw: sp.synthesize_sparse(
            DeviceSchedule(low, 'cuda'), low, Rs=8, **kw)}
    sharded = {
        'dense': lambda low, mesh, **kw: synthesize_sharded(
            low, mesh, rows_per_tile=8, **kw),
        'panel': lambda low, mesh, **kw: sp.synthesize_panels_sharded(
            low, mesh, Rs=8, **kw),
        'sparse': lambda low, mesh, **kw: sp.synthesize_sparse_sharded(
            low, mesh, Rs=8, **kw)}
    rec = {'phase': 'mesh_small', 'devices': devices}
    ok = True
    for route in ('dense', 'panel', 'sparse'):
        for mode in ('float32', 'int16', 'bfloat16', 'pair'):
            # the panel kernel narrows one bucket's stores only
            b = None if route == 'panel' and mode in ('int16',
                                                      'bfloat16') else 4096
            low = lows[b, 'complex' if mode == 'pair' else 'real']
            kw = {} if mode in ('float32', 'pair') else {
                'out_dtype': getattr(torch, mode), 'dac_scale': 20000.0}
            got = sharded[route](low, card, **kw).gather()
            plain = sharded[route](low, cpu, **kw).gather()
            one = whole[route](low, **kw)
            check = {'buckets': low.shape[1],
                     'vs_whole_bits': bits_equal(got, one)}
            if mode == 'int16':
                check['vs_plain'] = code_err(got.cpu().numpy(),
                                             plain.numpy())
                check['ok'] = check['vs_plain'] <= TOL_CODES
            elif mode == 'bfloat16':
                f32 = sharded[route](low, card).gather()
                check['vs_f32_rounded'] = bits_equal(got,
                                                     f32.to(torch.bfloat16))
                check['vs_plain'] = rel_err(f32.cpu().numpy(),
                                            sharded[route](low, cpu)
                                            .gather().numpy())
                check['ok'] = (check['vs_f32_rounded']
                               and check['vs_plain'] <= TOL_PLAIN)
            else:
                check['vs_plain'] = rel_err(got.cpu().numpy(),
                                            plain.numpy())
                check['ok'] = check['vs_plain'] <= TOL_PLAIN
            check['ok'] = bool(check['ok'] and check['vs_whole_bits'])
            rec[f'{route}_{mode}'] = check
            ok &= check['ok']
    # K1 over each time shard's slice of the bucket axis, launched directly
    low = lows[4096, 'real']
    grid, _ = shard_schedule(low, card, nb_pad=low.shape[1])
    cgrid, _ = shard_schedule(low, cpu, nb_pad=low.shape[1])
    nbl = low.shape[1] // 2
    errs = []
    for j in range(2):
        a, n = j * nbl * low.bucket_samples, nbl * low.bucket_samples
        got = kernels.synth_dense(grid[0][j], torch.empty(
            2, n, device=grid[0][j].device), None, a, n, j * nbl)
        plain = kernels.synth_dense.plain(cgrid[0][j], torch.empty(2, n),
                                          None, a, n, j * nbl)
        errs.append(rel_err(got.cpu().numpy(), plain.numpy()))
        # the plain version on the card too
        on_card = kernels.synth_dense.plain(
            grid[0][j], torch.empty_like(got), None, a, n, j * nbl)
        errs.append(rel_err_t(got, on_card))
    rec['k1_bucket0'] = {'bucket0': [0, nbl], 'vs_plain': max(errs),
                         'ok': max(errs) <= TOL_PLAIN}
    ok &= rec['k1_bucket0']['ok']
    # K6: the stacked-table route on the mesh, play_packed_sharded, and a
    # window of chunks launched directly
    rng = np.random.default_rng(33)
    chans = [wt.WaveVStack([(0.5 * wt.cosPulse(50e-9) >> o)
                            for o in rng.uniform(0, 60e-6, 50)])
             for _ in range(4)]
    for mode in ('float32', 'int16'):
        kw = {} if mode == 'float32' else {'out_dtype': torch.int16,
                                           'dac_scale': 20000.0}
        got = synthesize_stack_sharded(chans, 0.0, 65.536e-6, FS, card,
                                       **kw).gather()
        plain = synthesize_stack_sharded(chans, 0.0, 65.536e-6, FS, cpu,
                                         **kw).gather()
        err = (code_err(got.cpu().numpy(), plain.numpy()) if kw
               else rel_err(got.cpu().numpy(), plain.numpy()))
        rec[f'stack_{mode}'] = {'vs_plain': err, 'ok': err <= (
            TOL_CODES if kw else TOL_PLAIN)}
        ok &= rec[f'stack_{mode}']['ok']
    lows_s = [lower_schedule(chans[i:i + 2], 0.0, 65.536e-6, FS,
                             bucket_samples=None) for i in (0, 2)]
    seq = StackSequencer(lows_s, device='cuda')
    ks = [1, 0, 7, -2, 1]
    packed = seq.play_packed_sharded(ks, card).gather()
    plain_seq = StackSequencer(lows_s, device='cpu')
    t, n = seq.tables, seq.n_samples
    ks_dev = torch.tensor(ks, dtype=torch.int32, device='cuda')
    win = kernels.synth_stack_seq(t, ks_dev, torch.empty(
        (5, 2, n - 8192), device='cuda'), None, 1, t.n_chunks - 1)
    win_plain = kernels.synth_stack_seq.plain(
        plain_seq.tables, ks_dev.cpu(), torch.empty((5, 2, n - 8192)), None,
        1, t.n_chunks - 1)
    rec['play_packed_sharded'] = {
        'vs_play_packed_bits': bits_equal(packed, seq.play_packed(ks)),
        'vs_plain': rel_err(packed.cpu().numpy().reshape(-1, n),
                            plain_seq.play_packed(ks).numpy()
                            .reshape(-1, n))}
    rec['play_packed_sharded']['ok'] = bool(
        rec['play_packed_sharded']['vs_play_packed_bits']
        and rec['play_packed_sharded']['vs_plain'] <= TOL_PLAIN)
    win_card = kernels.synth_stack_seq.plain(
        t, ks_dev, torch.empty_like(win), None, 1, t.n_chunks - 1)
    rec['k6_chunk0'] = {'chunk0': 1, 'vs_plain': max(rel_err(
        win.cpu().numpy().reshape(-1, n - 8192), w.cpu().numpy().reshape(
            -1, n - 8192)) for w in (win_plain, win_card))}
    rec['k6_chunk0']['ok'] = rec['k6_chunk0']['vs_plain'] <= TOL_PLAIN
    ok &= rec['play_packed_sharded']['ok'] and rec['k6_chunk0']['ok']
    rec['ok'] = bool(ok)
    checks = {k: v for k, v in rec.items() if isinstance(v, dict)}
    log(rec, {'phase': 'mesh_small', 'checks': len(checks), 'ok': rec['ok'],
              'worst_vs_plain': max(v['vs_plain'] for v in checks.values()
                                    if isinstance(v['vs_plain'], float)),
              'failed': [k for k, v in checks.items() if not v['ok']]})
    if not rec['ok']:
        fail.append('mesh_small')


def mesh_cell(label, call, fail, must, absent=(), windowed=None):
    """One mesh main path through ``call`` -> (its result, its record with
    the route's launches and wall time); ``windowed`` is K1's count of
    launches with row0 != 0 that the path must make."""
    from waveforms_tpu_torch import kernels
    out, wall, cnt = main_path(label, call, fail, must, absent)
    rec = {'phase': label, 'launches': cnt, 'wall_s': wall}
    if windowed is not None:
        rec['windowed_launches'] = kernels.synth_dense.windowed_launches
        if rec['windowed_launches'] != windowed:
            fail.append(f"{label}: {rec['windowed_launches']} windowed K1 "
                        f"launches, expected {windowed}")
    return out, rec


def mesh_times(rec, run, whole):
    """The shards' summed kernel time (``run``, a ShardRun, relaunched) and
    the same kernel's on the whole schedule (``whole``), CUDA events."""
    rec['kernel_ms'] = cuda_ms(run.run)
    rec['unsharded_ms'] = cuda_ms(whole)
    rec['per_shard_extra_ms'] = ((rec['kernel_ms'] - rec['unsharded_ms'])
                                 / (len(run.calls) - 1))


def run_mesh(fail):
    """The mesh phase at full width (128 channels, 2 GS/s): mesh_small
    first, then each cell a main path on a (4, 2) mesh with its counts read
    right after it, its result against the single-device one, and the
    shards' summed kernel time beside the unsharded kernel's."""
    import numpy as np
    import scipy.signal as sps
    import torch

    import waveforms_tpu_torch as wt
    from waveforms_tpu_torch import kernels
    from waveforms_tpu_torch.distortion import exp_decay_filter
    from waveforms_tpu_torch.ops import fft_convolve_sharded, iir_cases
    from waveforms_tpu_torch.ops import sparse_synth as sp
    from waveforms_tpu_torch.ops import stack_seq
    from waveforms_tpu_torch.ops.lowering import lower_schedule
    from waveforms_tpu_torch.ops.stack_synth import (build_stack_plan,
                                                     build_stack_tables)
    from waveforms_tpu_torch.distortion import combine_filters
    from waveforms_tpu_torch.ops.synth import (DeviceSchedule,
                                               dac_scale_tensor,
                                               synthesize_device)
    from waveforms_tpu_torch.parallel import (channel_mesh, make_step,
                                              synthesize_on_mesh)
    from waveforms_tpu_torch.parallel.mesh import (dense_shards,
                                                   synthesize_sharded)
    from waveforms_tpu_torch.schedules import FS, STRATA
    from waveforms_tpu_torch.utils.signal import getFTMatrix

    mesh_small(fail)
    devices, distinct = mesh_devices(MESH[0] * MESH[1])
    mesh = channel_mesh(*MESH, devices=devices)
    chans = STASH.get('chans') or {n: STRATA[n][0]() for n in STRATA}
    base = {'mesh': list(MESH), 'devices': devices,
            'distinct_devices': distinct}

    def finish(rec, ok):
        rec.update(base, ok=bool(ok))
        log(rec, {k: v for k, v in rec.items() if k != 'devices'})
        if not rec['ok']:
            fail.append(rec['phase'])
        torch.cuda.empty_cache()

    def scale_of(dt, C):
        return dac_scale_tensor(dt, 32767.0, C, 'cuda')

    # ---- K2 on the flagship (f32, int16) and mid, by name (the card's
    # router takes them to K7 and K1); K1 on dense, routed
    for label, stratum, dt, kernel in (
            ('mesh_flagship', 'flagship', torch.float32, 'synth_panel'),
            ('mesh_flagship', 'flagship', torch.int16, 'synth_panel'),
            ('mesh_mid', 'mid', torch.float32, 'synth_panel'),
            ('mesh_dense', 'dense', torch.float32, 'synth_dense')):
        stop = STRATA[stratum][1]
        low = lower_schedule(chans[stratum], 0.0, stop, FS)
        panel = kernel == 'synth_panel'
        out, rec = mesh_cell(label, lambda: (
            sp.synthesize_panels_sharded(low, mesh, out_dtype=dt) if panel
            else synthesize_on_mesh(chans[stratum], 0.0, stop, FS, mesh,
                                    out_dtype=dt)), fail,
            {kernel: 8}, windowed=None if panel else 4)
        got = out.gather()
        del out
        dev = DeviceSchedule(low, 'cuda')
        one = wt.synthesize(chans[stratum], 0.0, stop, FS, out_dtype=dt,
                            engine='cuda-panel' if panel else 'auto',
                            device='cuda')
        rec.update(dtype=str(dt)[6:], route=kernel,
                   vs_single_device_bits=bits_equal(got, one))
        del got
        scale = scale_of(dt, low.shape[0])
        if kernel == 'synth_panel':
            run = sp.panel_shards(low, mesh, out_dtype=dt)
            work = sp.PanelWork.upload(sp.build_panel_plan(low), 'cuda')
            mesh_times(rec, run, lambda: kernels.synth_panel(
                dev, work, one, scale))
        else:
            run = dense_shards(low, mesh, out_dtype=dt)
            mesh_times(rec, run, lambda: kernels.synth_dense(dev, one,
                                                             scale))
        del run, one
        finish(rec, rec['vs_single_device_bits'])

    # ---- K1 on a bucketed dense schedule: bucket0 = 31 on time shard 1
    low = lower_schedule(chans['dense'], 0.0, 1e-3, FS, bucket_samples=32768)
    out, rec = mesh_cell('mesh_dense_bucketed',
                         lambda: synthesize_sharded(low, mesh), fail,
                         {'synth_dense': 8}, windowed=4)
    dev = DeviceSchedule(low, 'cuda')
    one = synthesize_device(dev)
    rec.update(buckets=low.shape[1], bucket0=[0, -(-low.shape[1] // 2)],
               route='synth_dense',
               vs_single_device_bits=bits_equal(out.gather(), one))
    del out
    mesh_times(rec, dense_shards(low, mesh),
               lambda: kernels.synth_dense(dev, one, None))
    del one, dev
    finish(rec, rec['vs_single_device_bits'])

    # ---- K7 on the flagship, routed (the card's route for it)
    low = lower_schedule(chans['flagship'], 0.0, 1e-3, FS)
    out, rec = mesh_cell('mesh_sparse', lambda: synthesize_on_mesh(
        chans['flagship'], 0.0, 1e-3, FS, mesh), fail, {'synth_sparse': 8})
    dev = DeviceSchedule(low, 'cuda')
    one = sp.synthesize_sparse(dev, low)
    rec.update(route='synth_sparse',
               vs_single_device_bits=bits_equal(out.gather(), one))
    del out
    work = sp.SparseWork.upload(sp.build_sparse_plan(low), 'cuda')

    def sparse_whole():
        one.zero_()
        kernels.synth_sparse(dev, work, one, None)
    mesh_times(rec, sp.sparse_shards(low, mesh), sparse_whole)
    del one, dev, work
    finish(rec, rec['vs_single_device_bits'])

    # ---- K2 in pair mode on the flagship, by name, combined and as two
    # planes
    low = lower_schedule(chans['flagship'], 0.0, 1e-3, FS, part='complex')
    out, rec = mesh_cell('mesh_complex', lambda: sp.synthesize_panels_sharded(
        low, mesh), fail, {'synth_panel': 8})
    got = out.gather()
    del out
    dev = DeviceSchedule(low, 'cuda')
    one = sp.synthesize_panels(dev, low)
    re, im = sp.synthesize_panels_sharded(low, mesh, combine_pair=False)
    rec.update(route='synth_panel', dtype='complex64',
               vs_single_device_bits=bits_equal(got, one),
               planes_bits=bits_equal(re.gather(), one.real.contiguous())
               and bits_equal(im.gather(), one.imag.contiguous()))
    del got, re, im
    work = sp.PanelWork.upload(sp.build_panel_plan(low), 'cuda')
    mesh_times(rec, sp.panel_shards(low, mesh),
               lambda: kernels.synth_panel(dev, work, one, None))
    del one, dev, work
    finish(rec, rec['vs_single_device_bits'] and rec['planes_bits'])

    # ---- K6 on ladder120 (the stack route on the mesh; K5 never)
    stop = STRATA['ladder120'][1]
    lad = chans['ladder120']
    out, rec = mesh_cell('mesh_ladder120', lambda: synthesize_on_mesh(
        lad, 0.0, stop, FS, mesh), fail, {'synth_stack_seq': 8},
        absent=('synth_stack',))
    got = out.gather()
    del out
    one = wt.synthesize(lad, 0.0, stop, FS, device='cuda')      # K5
    run = stack_seq.stack_shards(lad, 0.0, stop, FS, mesh)
    # K6's plain version on each channel shard's whole table, on the card
    ks0 = torch.zeros(1, dtype=torch.int32, device='cuda')
    plain = torch.cat([kernels.synth_stack_seq.plain(
        s.tables, ks0, torch.empty((1, s.n_channels, s.n_samples),
                                   device='cuda'))[0] for s in run.seqs])
    picks = [0, 61, 127]
    want = wt.synthesize([lad[c] for c in picks], 0.0, stop, FS,
                         engine='numpy')
    rec.update(route='synth_stack_seq', vs_k5=rel_err_t(got, one),
               vs_plain=rel_err_t(got, plain),
               vs_oracle=rel_err(got[picks].cpu().numpy(), want))
    del plain
    low = lower_schedule(lad, 0.0, stop, FS, bucket_samples=None)
    t5 = build_stack_tables(build_stack_plan(low), low, 'cuda')
    mesh_times(rec, run, lambda: kernels.synth_stack(t5, one, None))
    rec['unsharded_kernel'] = 'synth_stack'
    del got, one, t5, run
    finish(rec, rec['vs_k5'] <= TOL_PLAIN and rec['vs_plain'] <= TOL_PLAIN
           and rec['vs_oracle'] <= TOL_ORACLE)

    # ---- stackseq_ladder's table through play_packed_sharded, 16 shots
    seq, order = STASH['stackseq_ladder']
    out, rec = mesh_cell('mesh_play_packed',
                         lambda: seq.play_packed_sharded(order, mesh), fail,
                         {'synth_stack_seq': 8}, absent=('synth_stack',))
    one = seq.play_packed(order)
    rec.update(route='synth_stack_seq', shots=len(order),
               vs_play_packed_bits=bits_equal(out.gather(), one))
    del out
    ks_dev = torch.as_tensor(order, dtype=torch.int32, device='cuda')
    mesh_times(rec, seq.packed_shards(order, mesh),
               lambda: kernels.synth_stack_seq(seq.tables, ks_dev, one,
                                               None))
    del one
    finish(rec, rec['vs_play_packed_bits'])
    STASH.pop('stackseq_ladder')

    # ---- the production step on the flagship: K1 on the mesh, a filter
    # with its state carried across the time shards, the two tones
    low = lower_schedule(chans['flagship'], 0.0, 1e-3, FS)
    N = low.n_samples
    rows = seeded_rows(low.shape[0], 4, 9)
    raw = synthesize_device(DeviceSchedule(low, 'cuda'))
    host = raw[rows].double().cpu().numpy()
    del raw
    ft = getFTMatrix(TONES, N, sampleRate=FS)
    # each on S1, one call a shard
    for name, ba, tol in (
            ('z_settle', [exp_decay_filter(a, t, FS, inv=True)
                          for a, t in zip(*Z_SETTLE)], TOL_DOUBLING),
            ('clustered', [exp_decay_filter(*iir_cases.CLUSTERED, FS,
                                            output='ba')], TOL_DIRECT_FORM)):
        step = make_step(low, mesh, ba_filters=ba, demod_freqs=TONES)
        (sig, iq), rec = mesh_cell(
            'mesh_step', step, fail, {'synth_dense': 8, 'iir_df2t': 8},
            windowed=4)
        got = sig.gather()[rows].cpu().numpy()
        del sig
        b, a = combine_filters(ba)
        want = [sps.lfilter(b, a, h) for h in host]
        ref_iq = np.stack(want) @ ft
        rec.update(filter=name, route='S1', rows=rows,
                   vs_scipy=rows_err(got, want), tol=tol,
                   iq_shape=list(iq.shape),
                   iq_vs_host=float(np.abs(iq[rows].cpu().numpy() - ref_iq)
                                    .max() / np.abs(ref_iq).max()),
                   iq_tol=TOL_DEMOD,
                   step_ms=cuda_ms(step, reps=3))
        del iq
        finish(rec, rec['vs_scipy'] <= tol and rec['iq_vs_host'] <= TOL_DEMOD
               and rec['iq_shape'] == [low.shape[0], len(TONES)])

    # ---- the distributed FFT: 4 flagship rows over the 2 time shards
    x = torch.from_numpy(np.stack(host)).cuda()
    hann = sps.windows.hann(31)
    hann /= hann.sum()
    out, rec = mesh_cell('mesh_fft', lambda: fft_convolve_sharded(
        x, hann, mesh, centered=True), fail, {})
    rolled = np.roll(np.concatenate([hann, np.zeros(N - 31)]), -15)
    want = np.real(np.fft.ifft(np.fft.fft(np.stack(host))
                               * np.fft.fft(rolled)))
    rec.update(rows=rows, P=MESH[1], N=N,
               vs_numpy=rows_err(out.gather().cpu().numpy(), want),
               tol=TOL_FFT, ms=cuda_ms(lambda: fft_convolve_sharded(
                   x, hann, mesh, centered=True), reps=3))
    finish(rec, rec['vs_numpy'] <= TOL_FFT)


MP_TIMEOUT = 420.0     # seconds the workers of run_multiproc may take


def mp_cells(layout, reports):
    """Each worker cell's launch counts as a main path of its own (both
    workers' summed) -> {cell: counts}; ``MAIN_COUNTS`` and
    ``MAIN_WINDOWED`` take them."""
    from waveforms_tpu_torch import kernels
    cells = {}
    for rep in reports:
        for lay in rep.get('layouts', []):
            if lay['layout'] != layout:
                continue
            for cell, rec in lay['cells'].items():
                c = cells.setdefault(cell, {'counts': {
                    k.name: 0 for k in kernels.KERNELS}, 'windowed': 0,
                    'state': 0})
                for k, n in rec.get('launches', {}).items():
                    c['counts'][k] += n
                c['windowed'] += rec.get('windowed_launches', 0)
                c['state'] += rec.get('state_launches', 0)
    for cell, c in cells.items():
        label = f"multiproc_{layout}_{cell}"
        MAIN_COUNTS.append((label, c['counts']))
        MAIN_WINDOWED.append((label, c['windowed']))
    return cells


#: the kernels each cell must launch and how often, both processes
#: together (S1: a full call a shard, and the state-only calls of MP_STATE)
MP_MUST = {'dense': {'synth_dense': 8}, 'panel': {'synth_panel': 8},
           'sparse': {'synth_sparse': 8}, 'routed': {'synth_sparse': 8},
           'step_clustered': {'synth_dense': 8, 'iir_df2t': 8},
           'step_clustered_t8': {'synth_dense': 8, 'iir_df2t': 8},
           'step_z_settle': {'synth_dense': 8, 'iir_df2t': 8},
           'step_exp_decay': {'synth_dense': 8, 'iir_df2t': 8},
           'stack': {'synth_stack_seq': 8},
           'play_packed': {'synth_stack_seq': 8}}
#: S1's state-only calls of each step cell, both processes together: one a
#: shard of a run of one process's shards before its row's last.  None in
#: JAX's layout (no row crosses processes); rank 0's 4 shards in the time
#: split (time shard 0 of each row) and on the 8-shard 'time' mesh (its
#: run of shards 0-3).  Every filter runs on S1 on the card
MP_STATE = {'jax': {'step_clustered': 0, 'step_clustered_t8': 4,
                    'step_z_settle': 0, 'step_exp_decay': 0},
            'time': {'step_clustered': 4, 'step_clustered_t8': 4,
                     'step_z_settle': 4, 'step_exp_decay': 4}}


def run_multiproc(fail, summary):
    """The multi-process runtime (``waveforms_tpu_torch.parallel.
    multiproc_smoke``): 2 spawned worker processes share the card, each
    owning 4 shards of one (4, 2) ('channel', 'time') mesh of ``cuda:0``,
    the process group on gloo (the exchanged tensors staged through the
    host), in both layouts (JAX's, and the time split: rank r owns time
    shard r), at full size: the flagship, the dense stratum for K1, the
    filters of the step (the clustered one, the Z-settle pair and a single
    exponential, each on S1; the clustered one again over an 8-shard
    'time' mesh), K6 on small tables.  The parent built the
    libraries before, so the workers load them.  Each
    worker checks itself (blocks bit-equal to the single-device call and to
    the mesh in one process; the mean, the IQ points, the filter with its
    state carried in parallel against scipy, the long double and the step
    in one process; S1's state-only call on its blocks of the step against
    the full call's zf and the plain model's, bit for bit; the FFT against
    numpy; the step's bytes) and times its cells in turns with the other.
    A worker that fails a check, raises, dies or outlives its time fails
    the run.  Each worker cell is a main path: its launch counts, summed
    over both workers, join the kernel summary; S1's row takes the
    state-only calls' launches and the state-only call's distances."""
    import torch

    from waveforms_tpu_torch.parallel import multiproc_smoke as mp
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ok, reports = mp.run('gloo', device='cuda', layouts=tuple(mp.LAYOUTS),
                         size='full', timeout=MP_TIMEOUT)
    wall = time.perf_counter() - t0
    if not ok:
        fail.append("multiproc: " + "; ".join(
            str(r.get('error') or [lay['failures'] for lay in
                                   r.get('layouts', [])])[-600:]
            for r in reports if not r['ok'] or r['exitcode'] != 0))
    state, state_only = 0, []
    for layout in mp.LAYOUTS:
        cells = mp_cells(layout, reports)
        state += sum(c['state'] for c in cells.values())
        rec = {'phase': 'multiproc', 'layout': layout, 'backend': 'gloo',
               'processes': mp.N_PROC, 'shards_a_process': mp.LOCAL_SHARDS,
               'mesh': list(mp.MESH), 'run_wall_s': wall, 'workers': []}
        for rep in reports:
            lay = next((x for x in rep.get('layouts', [])
                        if x['layout'] == layout), None)
            if lay is None:
                rec['workers'].append({'rank': rep['rank'], 'ok': False,
                                       'exitcode': rep['exitcode']})
                continue
            w = {'rank': rep['rank'], 'ok': lay['ok'],
                 'exitcode': rep['exitcode'], 'wall_s': lay['wall_s'],
                 'local': lay['local'], 'failures': lay['failures']}
            for cell, c in lay['cells'].items():
                keep = {k: v for k, v in c.items()
                        if k not in ('checks', 'rows', 'tol')}
                keep['checks_ok'] = all(c.get('checks', {}).values())
                w[cell] = keep
            for cell in MP_STATE[layout]:
                got = lay['cells'].get(cell, {}).get('state_only')
                if got is None or got['vs_model'] is None:
                    fail.append(f"multiproc {layout} rank{rep['rank']} "
                                f"{cell}: S1's state-only call not checked")
                else:
                    state_only.append(got)
            rec['workers'].append(w)
        for cell, must in MP_MUST.items():
            if cell not in cells:
                fail.append(f"multiproc {layout}: no {cell} cell")
                continue
            for k, n in must.items():
                n += MP_STATE[layout].get(cell, 0) * (k == 'iir_df2t')
                got = cells[cell]['counts'][k]
                if got != n:
                    fail.append(f"multiproc {layout} {cell}: {k} launched "
                                f"{got}, expected {n}")
        for cell, n in MP_STATE[layout].items():
            if cells.get(cell, {}).get('state') != n:
                fail.append(f"multiproc {layout} {cell}: S1 state-only "
                            f"calls {cells.get(cell, {}).get('state')}, "
                            f"expected {n}")
        rec['ok'] = ok
        log(rec, brief_multiproc(rec))
    s1 = summary['iir_df2t']
    s1['state_launches'] = state
    # S1's state-only call on every worker's blocks of the step cells: its
    # zf against the full call's and the plain model's (df2t_blocked)
    if state_only:
        s1['state_only_max_abs_err_vs_full_call'] = max(
            r['vs_full_call'] for r in state_only)
        s1['state_only_max_abs_err_vs_model'] = max(
            r['vs_model'] for r in state_only)
        s1['state_only_shapes'] = sorted({tuple(x) for r in state_only
                                          for x in r['shapes']})
        s1['max_abs_err_vs_model'] = max(
            s1.get('max_abs_err_vs_model', 0.0),
            s1['state_only_max_abs_err_vs_model'])


def brief_multiproc(rec):
    """The phase line: each worker's wall, its cells' kernel ms, the step's
    exchange (ms, bytes, bound) and S1 parallel against sequential."""
    out = {k: rec[k] for k in ('phase', 'layout', 'backend', 'ok',
                               'run_wall_s')}
    for w in rec['workers']:
        b = {'wall_s': w.get('wall_s'), 'ok': w['ok']}
        for cell in ('dense', 'panel', 'sparse', 'fft', 'stack'):
            if isinstance(w.get(cell), dict) and (
                    'kernel_ms' in w[cell] or 'ms' in w[cell]):
                b[f'{cell}_ms'] = w[cell].get('kernel_ms', w[cell].get('ms'))
        for cell in ('step_clustered', 'step_clustered_t8', 'step_z_settle',
                     'step_exp_decay'):
            st = w.get(cell)
            if not isinstance(st, dict) or 'sent' not in st:
                continue
            b[cell] = {'exchange_ms': st.get('exchange_ms'),
                       'exchange_host_ms': st.get('exchange_host_ms'),
                       'bytes': st['sent']['bytes'],
                       'bound': st['bytes_bound']}
            for k in ('s1_parallel_ms', 's1_sequential_ms',
                      's1_state_only_ms', 'vs_scipy', 'vs_one_process',
                      'parallel_vs_ld', 'scipy_vs_ld', 'state_only'):
                if k in st:
                    b[cell][k] = st[k]
        if w.get('failures'):
            b['failures'] = w['failures']
        out[f"rank{w['rank']}"] = b
    return out


PROFILE_TOL = 0.10     # K1's measure_device against probes.cuda_ms
PROFILE_REPS = 5
# the five kernels of a full S1 call (signal_flagship's traced_kernels)
S1_KERNELS = ('iir_chunk_ends_kernel', 'iir_group_ends_kernel',
              'iir_group_starts_kernel', 'iir_chunk_starts_kernel',
              'iir_output_kernel')


def profiling(fail):
    """``waveforms_tpu_torch.utils.profiling`` on the card:
    ``measure_device`` (the median duration of a kernel's events, by name,
    in torch.profiler's trace) beside ``probes.cuda_ms`` (CUDA events, the
    card's queue pre-filled) for the same call: K1 on the dense stratum
    (the phase fails where the two differ by more than PROFILE_TOL: at
    1.36 ms either clock holds), K7 alone on the flagship's worklist, and
    each of S1's kernels on the clustered filter over the flagship's f64
    rows, their sum beside the call's events (K7's and S1's ratios
    recorded, not failed on); then one ``synthesize`` call traced inside
    ``annotate``, whose trace must hold the annotation on the host's
    timeline and, inside its span on the card's, the call's kernel.  Where
    ``utils.profiling.ATTEMPTS`` traces hold no matching device event the
    phase fails; ``events_of_launches`` counts one further trace's."""
    import glob
    import tempfile

    import torch

    import waveforms_tpu_torch as wt
    from waveforms_tpu_torch import kernels
    from waveforms_tpu_torch.ops import iir_cases
    from waveforms_tpu_torch.ops.lowering import lower_schedule
    from waveforms_tpu_torch.ops.sparse_synth import (SparseWork,
                                                      build_sparse_plan)
    from waveforms_tpu_torch.ops.synth import DeviceSchedule
    from waveforms_tpu_torch.schedules import FS, STRATA
    from waveforms_tpu_torch.utils import profiling as prof

    chans = STASH.get('chans', {})        # run_strata's, where it ran

    def stratum(name):
        return chans[name] if name in chans else STRATA[name][0]()
    rec = {'phase': 'profiling', 'reps': PROFILE_REPS}

    def both(label, fn, prefix):
        events_ms = cuda_ms(fn)
        try:
            traced_ms = prof.measure_device(fn, prefix,
                                            reps=PROFILE_REPS) * 1e3
        except RuntimeError as exc:
            rec[label] = {'prefix': prefix, 'error': str(exc)}
            return None
        with tempfile.TemporaryDirectory() as log_dir:
            with prof.trace(log_dir):
                for _ in range(PROFILE_REPS):
                    fn()
            found = len(prof.device_event_times(log_dir, prefix))
        rec[label] = {'prefix': prefix, 'measure_device_ms': traced_ms,
                      'cuda_ms': events_ms, 'ratio': traced_ms / events_ms,
                      'events_of_launches': [found, PROFILE_REPS]}
        return rec[label]['ratio']

    low = lower_schedule(stratum('dense'), 0.0, STRATA['dense'][1], FS)
    dev = DeviceSchedule(low, 'cuda')
    out = torch.empty((low.shape[0], low.n_samples), device='cuda')
    k1 = both('k1_dense', lambda: kernels.synth_dense(dev, out),
              'synth_dense_kernel')
    ok = k1 is not None and abs(k1 - 1) <= PROFILE_TOL
    del dev, out

    flagship, stop = stratum('flagship'), STRATA['flagship'][1]
    low = lower_schedule(flagship, 0.0, stop, FS)
    dev = DeviceSchedule(low, 'cuda')
    plan = build_sparse_plan(low)
    work = SparseWork.upload(plan, 'cuda')
    out = torch.zeros((low.shape[0], plan.window_samples), device='cuda')
    ok &= both('k7_flagship', lambda: kernels.synth_sparse(dev, work, out,
                                                          None),
               'synth_sparse_kernel') is not None
    del dev, work

    x = out.double()
    del out
    coef, zi = s1_rows(*iir_cases.filters()['clustered'], x)
    y, zf = torch.empty_like(x), torch.empty_like(zi)

    def s1():
        kernels.iir_df2t(x, coef, zi, y, zf)
    s1_rec = {'filter': 'clustered', 'shape': list(x.shape),
              'cuda_ms': cuda_ms(s1, reps=5), 'kernels': {}}
    for name in S1_KERNELS:
        try:
            s1_rec['kernels'][name] = prof.measure_device(
                s1, name, reps=PROFILE_REPS) * 1e3
        except RuntimeError as exc:
            s1_rec['kernels'][name] = None
            s1_rec.setdefault('errors', []).append(str(exc))
    found = [v for v in s1_rec['kernels'].values() if v is not None]
    s1_rec['measure_device_sum_ms'] = sum(found)
    s1_rec['ratio'] = s1_rec['measure_device_sum_ms'] / s1_rec['cuda_ms']
    rec['s1_clustered'] = s1_rec
    ok &= len(found) == len(S1_KERNELS)
    del x, y, zf
    torch.cuda.empty_cache()

    # a synthesize call inside annotate: the annotation in the trace, and
    # the call's kernel inside the annotation's span on the card's timeline
    # (traced again, as measure_device does, where a trace lost them)
    label = 'chip_smoke.synthesize'
    for attempt in range(1, prof.ATTEMPTS + 1):
        with tempfile.TemporaryDirectory() as log_dir:
            with prof.trace(log_dir):
                with prof.annotate(label):
                    wt.synthesize(flagship, 0.0, stop, FS, device='cuda')
            host = []
            for path in glob.glob(os.path.join(log_dir, '*.pt.trace.json')):
                with open(path) as f:
                    host += [e for e in json.load(f)['traceEvents']
                             if e.get('cat') == 'user_annotation'
                             and e.get('name') == label]
            spans = [e for e in prof.device_events(
                log_dir, ('gpu_user_annotation',)) if e['name'] == label]
            inside = [prof.kernel_name(e['name'])[:40]
                      for e in prof.device_events(log_dir) for a in spans
                      if a['ts'] <= e['ts']
                      and e['ts'] + e['dur'] <= a['ts'] + a['dur']]
        held = bool(host) and any(k.startswith('synth_sparse_kernel')
                                  for k in inside)
        if held:
            break
    rec['annotate'] = {'label': label, 'host_spans': len(host),
                       'device_spans': len(spans), 'kernels_inside': inside,
                       'traces': attempt}
    ok &= held
    rec['ok'] = bool(ok)
    log(rec)
    if not ok:
        fail.append('profiling')


#: the cross_engine phase's cases: the JAX fuzz file's two Pallas seeds,
#: a native, a sparse, a stack and a complex seed, and the station
CROSS_CASES = ('kernel0', 'kernel1', 'native1', 'sparse0', 'stack0',
               'complex0', 'station')
CROSS_MUST = ('synth_dense', 'synth_panel', 'synth_sparse', 'synth_stack',
              'synth_dense_hi')


def cross_engine(fail):
    """The JAX suite's cross-engine nets on the card (a main path,
    ``waveforms_tpu_torch.cross_engine``): CROSS_CASES through
    ``engine='auto'`` on the card's router and each forced kernel (K1, K2,
    K7, K5) in f32 and int16, pair mode on the complex seed and the double
    tier (K3), each against its route's plain version on the CPU and the
    oracle (f32 1e-6 and 2e-6 of each channel's peak, int16 one code,
    float64 1e-12 and 1e-9); a refusal must be the plain version's too.
    Fails on a failed check or where one of K1, K2, K7, K5, K3 did not
    launch."""
    from waveforms_tpu_torch import cross_engine as ce
    checks = ce.checks(CROSS_CASES)
    recs, wall, counts = main_path(
        'cross_engine', lambda: [ce.check(*c, device='cuda')
                                 for c in checks],
        fail, {k: None for k in CROSS_MUST})
    bad = [r for r in recs if not r['ok']]
    worst = {}
    for r in recs:
        if 'vs_plain' in r:
            w = worst.setdefault(r['mode'], {'vs_plain': 0, 'vs_oracle': 0})
            for key in w:
                w[key] = max(w[key], r[key])
    rec = {'phase': 'cross_engine', 'cases': list(CROSS_CASES),
           'checks': len(recs), 'refused': sum('refused' in r for r in recs),
           'failed': bad, 'worst': worst, 'wall_s': wall,
           'launches': counts, 'records': recs, 'ok': not bad}
    log(rec, {k: v for k, v in rec.items() if k != 'records'})
    if bad:
        fail.append(f"cross_engine: {len(bad)} checks")


EXAMPLES = ('torch_full_pipeline', 'torch_multichip_mesh',
            'torch_precision_tiers', 'torch_precompensation',
            'torch_sequence_table')


def examples(fail):
    """Each of ``examples/torch_*.py`` run on the card (``main('cuda')``,
    a main path each): its seconds, its launches and the last line of its
    report.  Fails where one raises or launches nothing."""
    import contextlib
    import importlib.util
    import io

    here = os.path.dirname(os.path.abspath(__file__))
    rec = {'phase': 'examples', 'runs': {}}
    for name in EXAMPLES:
        spec = importlib.util.spec_from_file_location(
            name, os.path.join(here, 'examples', name + '.py'))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        report = io.StringIO()
        run = {}
        try:
            with contextlib.redirect_stdout(report):
                _, run['seconds'], run['launches'] = main_path(
                    f'example {name}', lambda: mod.main('cuda'), fail, {})
            run['ok'] = bool(run['launches'])
        except Exception as exc:          # an example that raises fails
            run.update(ok=False, error=f"{type(exc).__name__}: {exc}")
        lines = report.getvalue().strip().splitlines()
        run['last_line'] = lines[-1][:160] if lines else ''
        rec['runs'][name] = run
        if not run['ok']:
            fail.append(f"example {name}")
    rec['ok'] = all(r['ok'] for r in rec['runs'].values())
    log(rec)


def ptxas_entries(lines):
    """{entry function (mangled): [registers, spill store bytes, spill
    load bytes, shared memory bytes]} from nvcc's ``-Xptxas -v`` lines, in
    build order."""
    out, name = {}, None
    for ln in lines:
        m = re.search(r"entry function '([^']+)'", ln)
        if m:
            name = m.group(1)
            out[name] = [None, 0, 0, 0]
            continue
        if name is None:
            continue
        m = re.search(r'(\d+) bytes spill stores, (\d+) bytes spill loads',
                      ln)
        if m:
            out[name][1:3] = [int(m.group(1)), int(m.group(2))]
        m = re.search(r'Used (\d+) registers', ln)
        if m:
            out[name][0] = int(m.group(1))
            m = re.search(r'(\d+) bytes smem', ln)
            out[name][3] = int(m.group(1)) if m else 0
            name = None
    return out


def ptxas_resources(entries, name):
    """Registers and static shared memory bytes per thread block of the
    kernel wrapper ``name``'s entry functions (ptxas_entries; the largest
    over its instances), or None where the build log names none."""
    mine = [v for k, v in entries.items() if f'{name}_kernel' in k]
    return {'registers': max((v[0] for v in mine), default=None),
            'smem_bytes': max((v[3] for v in mine), default=None)}


_S1_ENTRY = re.compile(r'(iir_\w+?_kernel)I([df])Li(\d+)EE')


def s1_resources(entries):
    """{kernel: {dtype: {d: [registers, spill stores, spill loads, static
    shared bytes]}}} of S1's entry functions among ptxas_entries'."""
    out = {}
    for name, v in entries.items():
        m = _S1_ENTRY.search(name)
        if m:
            out.setdefault(m.group(1), {}).setdefault(
                'f64' if m.group(2) == 'd' else 'f32', {})[int(m.group(3))] = v
    return out


def s1_entry(entries):
    """S1's registers and static shared memory bytes for the kernels line:
    the largest over its kernels at the flagship's state, float64 and d =
    3, each also apart in ``s1_kernels`` (s1_resources)."""
    s1 = {k: v['f64'][3] for k, v in s1_resources(entries).items()
          if 3 in v.get('f64', {})}
    return {'registers': max((v[0] for v in s1.values()), default=None),
            'smem_bytes': max((v[3] for v in s1.values()), default=None),
            's1_kernels': s1}


def write_record(path):
    """Every record of the run, in full, to the JSON file ``path``."""
    if path:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, 'w') as f:
            json.dump(RECORDS, f, indent=1)


def main():
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--record', help="write every phase's record to this "
                    "JSON file")
    args = ap.parse_args()
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

    from waveforms_tpu_torch.probes import QUEUE, health_probe, nvidia_smi
    fail = []
    smi = nvidia_smi()
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
             if 'registers' in ln or 'spill' in ln or 'Compiling' in ln]
    rec = {'phase': 'build', 'ok': True, 'seconds': time.perf_counter() - t0,
           'library': str(kernels.library_path().name), 'ptxas': ptxas}
    spills = [ln for ln in ptxas if re.search(r'[1-9][0-9]* bytes spill', ln)]
    rec['entries'] = ptxas_entries(ptxas)
    walkers = {k: v for k, v in rec['entries'].items()
               if any(w in k for w in WALKERS)}
    log(rec, {k: rec[k] for k in ('phase', 'ok', 'seconds', 'library')}
        | {'ptxas_lines': len(ptxas), 'spilling': spills,
           'walker_kernels': walkers})
    # the tile walkers (K1, K3, K7, P1) and the row walkers (K5, K6) are
    # held to no spill
    fail += [f"{k} spills {v[1]} bytes" for k, v in walkers.items() if v[1]]

    # the C++ host layer (the lowering walker and the host engine), built
    # with g++ at first use: every main path below lowers through the walker
    from waveforms_tpu_torch import native
    t0 = time.perf_counter()
    built = native.available() and native.lower_available()
    native_rec = {'phase': 'native_build', 'ok': built,
                  'seconds': time.perf_counter() - t0,
                  'host_cpu': host_cpu(), 'cpus': os.cpu_count()}
    try:
        native_rec['cxx'] = subprocess.run(
            [native.CXX, '--version'], capture_output=True, text=True,
            timeout=60).stdout.splitlines()[0]
    except (OSError, IndexError) as exc:
        native_rec['cxx'] = f"unavailable: {exc}"
    if built:
        native_rec['libraries'] = {
            k: p.name for k, p in native.library_paths().items()}
    else:
        native_rec['error'] = (native.build_error() or '')[-4000:]
    log(native_rec)
    if not built:
        print(json.dumps({'ok': False, 'failures': ['native build']}),
              flush=True)
        return 1

    # P4, the health probe, before every other phase (as the TPU capture
    # script's main): a card that cannot double (8, 128) floats ends the run
    try:
        health = health_probe()
    except Exception as exc:
        health = {'ok': False, 'error': f"{type(exc).__name__}: {exc}"}
    log(dict(health, phase='health'))
    if not health['ok']:
        print(json.dumps({'ok': False, 'failures': ['health probe']}),
              flush=True)
        return 1
    summary = {k.name: {'name': k.name, 'route': 'cuda', 'source': k.source,
                        'replaces': k.replaces, 'launches': 0,
                        'max_abs_err': None, 'ms': None, 'plain_ms': None,
                        'bound_ms': None, 'bound_by': None,
                        'library_ms': None,
                        **ptxas_resources(rec['entries'], k.name)}
               for k in kernels.KERNELS}
    summary['iir_df2t'].update(s1_entry(rec['entries']))
    pool = start_builds()
    try:
        for phase in (check_small, check_small_hi, check_small_seq,
                      check_small_narrow, check_probes, run_strata,
                      engine_native, engine_torch, run_sequences,
                      signal_flagship, stream_flagship, seq_station_chain,
                      iir_routes, route_ladder, run_mesh, run_multiproc,
                      run_probes, profiling, cross_engine, examples):
            t0 = time.perf_counter()
            try:
                if phase in (run_strata, run_sequences, signal_flagship,
                             stream_flagship, seq_station_chain,
                             run_multiproc, run_probes):
                    phase(fail, summary)
                else:
                    phase(fail)
            except Exception as exc:     # a phase that raises fails the run
                import traceback
                log({'phase': phase.__name__, 'ok': False,
                     'error': traceback.format_exc()[-4000:]})
                fail.append(f"{phase.__name__}: {exc!r}")
            log({'phase': f'{phase.__name__}_done',
                 'seconds': time.perf_counter() - t0})
    finally:
        pool.shutdown(cancel_futures=True)

    # the queued timings: every time above is device time only if the host
    # queued each run before the card's sleep ended (late runs were redone)
    log(dict(QUEUE, phase='timing'))

    # each kernel's launches on the user paths apart from the probes path's
    # (whose counts are timing loops); a probe kernel, which no user path
    # runs, counts its own path's launches
    for name, entry in summary.items():
        entry['probe_launches'] = sum(c[name] for path, c in MAIN_COUNTS
                                      if path == 'probes')
        entry['launches'] = sum(c[name] for path, c in MAIN_COUNTS
                                if path != 'probes')
        if name.startswith('probe_'):
            entry['launches'] = entry['probe_launches']
        if name == 'synth_dense':     # of them, the windowed (row0 != 0)
            entry['windowed_launches'] = sum(n for _, n in MAIN_WINDOWED)
        if entry['launches'] == 0:
            fail.append(f"{name} never launched on the main paths")
        if None in (entry['ms'], entry['plain_ms'], entry['bound_ms'],
                    entry['max_abs_err']):
            fail.append(f"{name}: a summary number was not measured")
    floor = launch_floor_ms()
    for name in FLOOR_ROWS:
        summary[name]['launch_floor_ms'] = floor
    summary = list(summary.values())
    RECORDS.append({'phase': 'kernels', 'kernels': summary,
                    'launch_floor_ms': floor})
    write_record(args.record)
    if fail:
        print(json.dumps({'ok': False, 'failures': fail}), flush=True)
        return 1
    keys = ('name', 'route', 'source', 'replaces', 'launches',
            'probe_launches', 'windowed_launches', 'state_launches',
            'cuda_launches_a_call',
            'max_abs_err', 'max_abs_err_vs_model',
            'state_only_max_abs_err_vs_full_call',
            'state_only_max_abs_err_vs_model', 'ms', 'plain_ms',
            'bound_ms', 'bound_by', 'library_ms', 'registers', 'smem_bytes',
            'dynamic_smem_bytes', 's1_kernels')
    print(smi, flush=True)
    print(json.dumps({'kernels': [
        {k: e[k] for k in keys + ('launch_floor_ms',) if k in e}
        for e in summary], 'launch_floor_ms': floor}), flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
