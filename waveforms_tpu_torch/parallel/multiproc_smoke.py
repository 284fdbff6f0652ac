"""Two-process smoke run of the sharded step on ``torch.distributed``.

The port of the JAX package's ``tools/multiproc_smoke.py``.  A mesh in one
process checks the sharded logic, but not the multi-process path: the
process group's start-up, shards that live in different processes, and
collectives that really cross process boundaries.  This script runs that
path with two OS processes, each owning 4 shards of one (4, 2) ('channel',
'time') mesh:

    python -m waveforms_tpu_torch.parallel.multiproc_smoke \\
        --device cpu|cuda --backend gloo|nccl --layout jax|time

``--device cpu`` runs the kernels' plain versions; ``--device cuda`` gives
rank r the card ``cuda:r`` (modulo the cards there are), so on a one-card
host both processes share ``cuda:0``, each launching only its own shards'
kernels.  ``--layout jax`` lays the mesh out as JAX does (every rank's
devices in rank order, row-major: rank 0 owns channel shards 0-1 with both
time shards); ``--layout time`` gives rank r time shard r of every channel
shard, so that the filter's carry and the demodulation's sums cross the
processes.  Both layouts may be named (``--layout jax time``).

The checks, on JAX's 8-channel schedule (seed 5, 4.096 us at 2 GS/s;
``--size full``: the flagship, 128 channels of 2,000,000 samples, and the
dense stratum for K1):

- ``dense``: :func:`.mesh.synthesize_sharded` (K1), each local block
  bit-equal to the same rows and columns of the single-device kernel and of
  the port's mesh in one process; the plane's global :meth:`mean
  <.mesh.ShardedPlane.mean>` (a sum over both processes) within 1e-6 of the
  float64 oracle's;
- ``panel``: :func:`..ops.sparse_synth.synthesize_panels_sharded` (K2 on
  the flagship, which JAX's smoke reaches through ``synthesize_on_mesh``
  and the card's router sends to K7; the
  plane then assembled on rank 0, :meth:`.mesh.ShardedPlane.gather`, bit
  for bit against the one-process mesh's; None on rank 1),
  ``sparse``: :func:`..ops.sparse_synth.synthesize_sparse_sharded` (K7),
  likewise bit for bit, the sparse plane within 2e-6 of the dense one,
  and ``routed``: :func:`.mesh.synthesize_on_mesh`, the router each rank
  runs alone (on the card the flagship's route is K7; on CPU devices the
  JAX rule's), bit for bit against the one-process mesh's and, at full
  size, the single-device ``synthesize`` on the same device;
- ``demod``: :func:`.pipeline.make_step` with two tones and no filter, the
  IQ points summed over the processes, against the oracle's (rtol 2e-4,
  atol 1e-6, JAX's);
- ``step_clustered``, ``step_z_settle`` and ``step_exp_decay`` (all
  three on the recurrence kernel S1 on the card; on the CPU the last two
  on the doubling scan, as in JAX): ``make_step`` with the filter
  carried across the processes in parallel (S1's state-only call on the
  shards of a run of one process's shards before its row's last; none in
  JAX's layout, where no row crosses processes), against scipy's float64
  ``lfilter`` of the whole row (1e-5, Z-settle 2e-8, the single
  exponential 1e-9, of each row's peak), S1's contract against the long
  double (no farther than twice scipy), the port's step in one process
  (its sequential carry; 1e-9 of the peak, the IQ points 1e-4), and the
  bytes the step sent between the processes at most the (C, d) boundary
  states plus the (C, n_tones) IQ points; ``step_clustered_t8`` the same
  on an 8-shard 'time' mesh over both processes, held to the step in one
  process by S1's rule (no farther from the long double than twice it);
  with S1, its state-only call on every local block of the step's plane
  (from a seeded state) bit-equal to its full call's final state and, on
  the card, to the plain model of its blocked arithmetic;
- ``stack`` and ``play_packed``: the stacked-table kernel K6 through
  ``synthesize_stack_sharded`` and ``StackSequencer.play_packed_sharded``
  on small tables, bit for bit against the same calls in one process;
- ``fft``: :func:`..ops.fft_sharded.fft_convolve_sharded` on an 8-shard
  'time' mesh over both processes, within 1e-9 of numpy's circular
  convolution.

Exit 0 and a last line ``MULTIPROC OK`` mean both workers ran every check
and passed; a worker that fails a check, raises, dies or outlives
``--timeout`` makes the script exit 1.  Workers start with ``spawn`` (CUDA
cannot be forked) and destroy the process group in a ``finally``.
``--out DIR`` writes each worker's local blocks and results to
``DIR/<layout>_rank<r>.npz``.  Each worker prints one JSON report line.
"""

from __future__ import annotations

import argparse
import json
import os
import queue as queue_mod
import socket
import sys
import time
import traceback

import numpy as np

N_PROC = 2
LOCAL_SHARDS = 4
MESH = (4, 2)
FS = 2e9
TONES = [-100e6, -110e6]            # JAX's smoke's two tones
STOP_SMALL = 4.096e-6
RS = 8                              # the worklist's subtile rows (JAX's)
Z_SETTLE = ([0.02, 0.005], [3e-6, 20e-6])
FULL_TONES = [6.87836e9 - 6.99e9, 6.92248e9 - 6.99e9]
TOL_MEAN = 1e-6
TOL_SPARSE = 2e-6
TOL_IQ = (2e-4, 1e-6)               # rtol, atol against the oracle
TOL_IQ_STEP = 1e-4                  # of the peak, against the one-process step
TOL_SCIPY = {'clustered': 1e-5, 'z_settle': 2e-8, 'exp_decay': 1e-9}
TOL_ONE_PROCESS = 1e-9
TOL_FFT = 1e-9
TOL_S1_LD = 2.0                     # S1's contract against the long double
TOL_S1_FLOOR = 1e-13

#: the mesh's device order (flat indices of the rank-ordered device list,
#: row-major over the mesh) for each layout
LAYOUTS = {'jax': None,
           'time': [j * MESH[0] + i for i in range(MESH[0])
                    for j in range(MESH[1])]}


def small_channels():
    """JAX's smoke schedule (``tools/multiproc_smoke.py``): 8 channels,
    DRAG-mixed 50 ns cosPulses on the even ones and edge-smoothed 200 ns
    squares on the odd ones, drawn from seed 5."""
    from .. import cosPulse, mixing, square, zero
    rng = np.random.default_rng(5)
    chans = []
    for c in range(8):
        x = zero()
        if c % 2 == 0:
            I, _ = mixing(0.5 * cosPulse(50e-9) >> rng.uniform(0, 3e-6),
                          freq=-100e6 - 5e6 * c, DRAGScaling=1e-10)
            x += I
        else:
            x += 0.3 * (square(200e-9, edge=20e-9) >> rng.uniform(0, 3e-6))
        chans.append(x)
    return chans


def filters(device='cuda'):
    """{name: (the filters, their route on ``device``)} of the filtered
    steps: the clustered three-pole filter, the station's Z-settle pair
    and a single exponential whose pole f32 holds.  On the card all three
    run the recurrence kernel S1; on the CPU the clustered filter runs S1
    and the other two the doubling scan, as in JAX
    (:func:`..ops.iir._route`)."""
    import torch

    from ..distortion import exp_decay_filter
    from ..ops import iir_cases
    card = torch.device(device).type == 'cuda'
    return {'clustered': ([exp_decay_filter(*iir_cases.CLUSTERED, FS,
                                            output='ba')], 'S1'),
            'z_settle': ([exp_decay_filter(a, t, FS, inv=True)
                          for a, t in zip(*Z_SETTLE)],
                         'S1' if card else 'doubling'),
            'exp_decay': ([exp_decay_filter(0.05, 100e-9, FS, inv=True)],
                          'S1' if card else 'doubling')}


def rows_err(got, want, peak):
    """max over rows of max|got - want| / the row's ``peak``."""
    return float((np.abs(np.asarray(got) - np.asarray(want)).max(-1)
                  / np.maximum(peak, 1e-300)).max()) if np.size(got) else 0.0


class Worker:
    """One process's side of the checks: its mesh, its records."""

    def __init__(self, rank, device, size, out_dir):
        import torch

        from .. import kernels
        self.rank, self.size, self.out_dir = rank, size, out_dir
        self.device = torch.device(device)
        self.kernels = kernels
        self.failures, self.cells, self.saved = [], {}, {}

    def check(self, cell, name, ok, **values):
        rec = self.cells.setdefault(cell, {})
        rec.update(values)
        rec.setdefault('checks', {})[name] = bool(ok)
        if not ok:
            self.failures.append(f"{cell}: {name} {values}")

    def main_path(self, cell, fn):
        """``fn()`` with the launch counts set to 0 just before it and read
        just after -> its result; the counts and the wall go in the cell's
        record."""
        import torch
        self.kernels.reset_launch_counts()
        t0 = time.perf_counter()
        out = fn()
        if self.device.type == 'cuda':
            torch.cuda.synchronize(self.device)
        rec = self.cells.setdefault(cell, {})
        rec['wall_s'] = time.perf_counter() - t0
        rec['launches'] = {k: n for k, n in
                           self.kernels.launch_counts().items() if n}
        rec['state_launches'] = self.kernels.iir_df2t.state_launches
        rec['windowed_launches'] = self.kernels.synth_dense.windowed_launches
        return out

    def timed(self, cell, key, fn):
        """Card time of ``fn`` (ms, CUDA events, the card's queue filled);
        the workers take turns, so the other process's kernels do not run
        meanwhile.  Nothing on the CPU."""
        if self.device.type != 'cuda':
            return
        import torch.distributed as dist

        from ..probes import cuda_ms
        for r in range(N_PROC):
            dist.barrier()
            if r == self.rank:
                self.cells.setdefault(cell, {})[key] = cuda_ms(fn, reps=5)
        dist.barrier()

    def timed_together(self, cell, key, fn, reps=3):
        """Host wall time (ms) of ``fn`` a call, over ``reps`` calls that
        both workers make together after a barrier (``fn`` runs
        collectives, so it cannot be timed in turns); nothing on the
        CPU."""
        if self.device.type != 'cuda':
            return
        import torch
        import torch.distributed as dist
        fn()
        torch.cuda.synchronize(self.device)
        dist.barrier()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize(self.device)
        self.cells.setdefault(cell, {})[key] = (
            (time.perf_counter() - t0) * 1e3 / reps)

    def save(self, key, t):
        if self.out_dir is not None:
            self.saved[key] = np.asarray(t.cpu() if hasattr(t, 'cpu') else t)

    def save_blocks(self, cell, plane, mesh):
        """Every local block of ``plane``, with its first row and column."""
        for i, j in mesh.local:
            rr, cc = _region(plane, i, j)
            self.save(f'{cell}_{i}_{j}', plane.blocks[i][j])
            self.save(f'{cell}_{i}_{j}_at', [rr.start, cc.start])


def _region(plane, i, j):
    """Block (i, j)'s rows and columns of the whole plane."""
    cs = max(s[0][0] for s in plane.block_shapes)
    rows, width = plane.block_shapes[i][j]
    a = sum(s[1] for s in plane.block_shapes[0][:j])
    return slice(i * cs, i * cs + rows), slice(a, a + width)


def _blocks_equal(w, cell, plane, whole, mesh, name='vs_single_device'):
    """Each local block of ``plane`` against the same rows and columns of
    ``whole`` (one tensor), bit for bit."""
    import torch
    ok = all(torch.equal(plane.blocks[i][j],
                         whole[_region(plane, i, j)].to(w.device))
             for i, j in mesh.local)
    w.check(cell, name, ok)


def _planes_equal(w, cell, plane, other, mesh, name='vs_one_process'):
    """Each local block of ``plane`` against the same block of ``other``
    (a plane of the same layout in one process), bit for bit."""
    import torch
    ok = all(torch.equal(plane.blocks[i][j], other.blocks[i][j])
             for i, j in mesh.local)
    w.check(cell, name, ok)


def layout_digest(low, mesh, rows_per_tile) -> str:
    """sha256 of a lowering's descriptors and of its shards' layout on
    ``mesh`` (owners, the dense route's time windows)."""
    import hashlib

    from .mesh import dense_shards
    h = hashlib.sha256()
    for name in ('seg_lo', 'seg_hi', 'nterm', 'amp', 'nfac', 'op', 'power',
                 'shift_hi', 'q32', 'args', 'clip_min', 'clip_max', 'ext'):
        if getattr(low, name) is not None:
            h.update(np.ascontiguousarray(getattr(low, name)).tobytes())
    h.update(np.ascontiguousarray(mesh.owners).tobytes())
    run = dense_shards(low, mesh, rows_per_tile=rows_per_tile)
    h.update(repr((run.widths, run.cs, low.shape, low.n_samples)).encode())
    return h.hexdigest()


def run_layout(w, layout, backend):
    """Every check of one layout -> the worker's record of it."""
    import torch

    from .. import synthesize
    from ..ops import sparse_synth as sp
    from ..ops.fft_sharded import fft_convolve_sharded
    from ..ops.lowering import lower_schedule
    from ..ops.reference import warm_cpu_math
    from ..ops.synth import DeviceSchedule, synthesize_device
    from ..schedules import STRATA
    from . import distributed
    from .mesh import (Mesh, channel_mesh, dense_shards, synthesize_on_mesh,
                       synthesize_sharded)
    from .pipeline import make_step

    warm_cpu_math()
    t_start = time.perf_counter()
    w.failures, w.cells, w.saved = [], {}, {}
    dev = w.device
    full = w.size == 'full'
    mesh = channel_mesh(*MESH, devices=[dev] * LOCAL_SHARDS,
                        order=LAYOUTS[layout])
    one = Mesh(np.array([dev] * (MESH[0] * MESH[1]),
                        dtype=object).reshape(MESH), rank=w.rank)
    if full:
        chans, stop = STRATA['flagship'][0](), STRATA['flagship'][1]
        dense_chans, dense_stop = STRATA['dense'][0](), STRATA['dense'][1]
        tones, rpt = FULL_TONES, None
    else:
        chans, stop = small_channels(), STOP_SMALL
        dense_chans, dense_stop = chans, stop
        tones, rpt = TONES, 8
    low = lower_schedule(chans, 0.0, stop, FS)
    low_dense = (low if dense_chans is chans
                 else lower_schedule(dense_chans, 0.0, dense_stop, FS))
    C, N = low.shape[0], low.n_samples
    rec = {'layout': layout, 'rank': w.rank, 'backend': backend,
           'device': str(dev), 'size': w.size,
           'owners': mesh.owners.tolist(), 'local': mesh.local}
    # every process lowers the whole schedule and shards it alike: the
    # lowerings' and the layouts' digests agree across the ranks
    digest = layout_digest(low, mesh, rpt)
    digests = distributed.all_gather(torch.frombuffer(
        bytearray(bytes.fromhex(digest)), dtype=torch.uint8).to(
            dev if backend == 'nccl' else 'cpu'))
    w.check('layout', 'ranks_agree', len({bytes(d.cpu().numpy())
                                          for d in digests}) == 1,
            digest=digest)

    # ---- K1: synthesize_sharded
    plane = w.main_path('dense', lambda: synthesize_sharded(
        low_dense, mesh, rows_per_tile=rpt))
    whole = synthesize_device(DeviceSchedule(low_dense, dev))
    _blocks_equal(w, 'dense', plane, whole, mesh)
    _planes_equal(w, 'dense', plane, synthesize_sharded(
        low_dense, one, rows_per_tile=rpt), mesh)
    w.save_blocks('dense', plane, mesh)
    w.timed('dense', 'kernel_ms', dense_shards(low_dense, mesh,
                                               rows_per_tile=rpt).run)
    dense_local = plane
    del whole

    # ---- K2 (named: on the card the router takes the flagship to K7 and
    # the small schedule to K1) and K7
    plane = w.main_path('panel', lambda: sp.synthesize_panels_sharded(
        low, mesh))
    whole = synthesize(chans, 0.0, stop, FS, engine='cuda-panel', device=dev)
    if full:
        _blocks_equal(w, 'panel', plane, whole, mesh)
    one_plane = sp.synthesize_panels_sharded(low, one)
    _planes_equal(w, 'panel', plane, one_plane, mesh)
    w.save_blocks('panel', plane, mesh)
    if full:
        w.timed('panel', 'kernel_ms', sp.panel_shards(low, mesh).run)
    # the plane assembled on rank 0 from both processes' blocks
    distributed.reset_sent()
    got = w.main_path('gather', lambda: plane.gather(dst=0))
    w.check('gather', 'on_rank0' if w.rank == 0 else 'none_elsewhere',
            (w.rank != 0 and got is None) or (
                got is not None and torch.equal(got, one_plane.gather())),
            sent=dict(distributed.SENT))
    del got, one_plane
    mean_plane = plane if full else dense_local
    mean = w.main_path('mean', mean_plane.mean)
    w.save('mean', mean)

    sparse = w.main_path('sparse', lambda: sp.synthesize_sparse_sharded(
        low, mesh, Rs=RS))
    whole_sp = sp.synthesize_sparse(DeviceSchedule(low, dev), low, Rs=RS)
    _blocks_equal(w, 'sparse', sparse, whole_sp, mesh)
    _planes_equal(w, 'sparse', sparse, sp.synthesize_sparse_sharded(
        low, one, Rs=RS), mesh)
    err = max(float((sparse.blocks[i][j] - whole[_region(sparse, i, j)].to(
        dev)).abs().max()) for i, j in mesh.local)
    w.check('sparse', 'vs_dense', err <= TOL_SPARSE, vs_dense=err)
    w.save_blocks('sparse', sparse, mesh)
    w.timed('sparse', 'kernel_ms', sp.sparse_shards(low, mesh, Rs=RS).run)
    del sparse, whole_sp

    # ---- the router, each rank deciding alone: on the card the
    # flagship's route is K7 (the JAX rule's on CPU devices)
    routed = w.main_path('routed', lambda: synthesize_on_mesh(
        chans, 0.0, stop, FS, mesh))
    if full:
        _blocks_equal(w, 'routed', routed,
                      synthesize(chans, 0.0, stop, FS, device=dev), mesh)
    _planes_equal(w, 'routed', routed, synthesize_on_mesh(
        chans, 0.0, stop, FS, one), mesh)
    w.save_blocks('routed', routed, mesh)
    del routed

    # the oracle: the float64 host engine, 16 channels at a time
    t = np.arange(N) / FS
    ft = np.exp(-2j * np.pi * np.outer(t, tones)) * (2.0 / N)
    total, oracle_iq = 0.0, []
    for c0 in range(0, C, 16):
        o = synthesize(chans[c0:c0 + 16], 0.0, stop, FS, engine='numpy',
                       device='cpu')
        total += float(o.sum())
        oracle_iq.append(o @ ft)
        del o
    oracle_iq = np.concatenate(oracle_iq)
    w.check('mean', 'vs_oracle', abs(mean - total / (C * N)) <= TOL_MEAN,
            mean=mean, oracle_mean=total / (C * N))

    # ---- the step: demodulation alone, then each filter
    distributed.reset_sent()
    _, iq = w.main_path('demod', make_step(low, mesh, demod_freqs=tones,
                                           rows_per_tile=rpt))
    sent = dict(distributed.SENT)
    iq = iq.cpu().numpy()
    w.save('demod_iq', iq)
    w.check('demod', 'vs_oracle', np.allclose(iq, oracle_iq, rtol=TOL_IQ[0],
                                              atol=TOL_IQ[1]),
            vs_oracle=float(np.abs(iq - oracle_iq).max()), sent=sent)
    rows = (sorted(int(r) for r in np.random.default_rng(9).choice(
        C, 4, replace=False)) if full else list(range(C)))
    raw = synthesize_device(DeviceSchedule(low, dev))     # the step's K1
    host = raw[rows].double().cpu().numpy()
    del raw, whole
    for name, (ba, route) in filters(w.device).items():
        _step_cell(w, f'step_{name}', name, ba, route, low, mesh, one,
                   tones, rows, host, rpt)
    # the clustered filter over 8 time shards, 4 a process: rank 0's run
    # of 4 shards takes its end state by 4 state-only calls in turn, and
    # the carry crosses between the processes once
    fmesh = channel_mesh(1, MESH[0] * MESH[1], devices=[dev] * LOCAL_SHARDS)
    one8 = Mesh(np.array([dev] * fmesh.size, dtype=object).reshape(
        1, fmesh.size), rank=w.rank)
    ba, route = filters(w.device)['clustered']
    _step_cell(w, 'step_clustered_t8', 'clustered', ba, route, low, fmesh,
               one8, tones, rows, host, None if full else 1, strict=False)

    # ---- the stacked-table kernel K6: a schedule's windows of chunks, and
    # a table's shots split over the 8 shards (small tables at every size)
    _stack_cells(w, mesh, one)

    # ---- the distributed FFT on the 8-shard 'time' mesh
    if full:
        x = torch.from_numpy(host).to(dev)
        taps = np.hanning(33)[1:-1]
        ker = taps / taps.sum()
        centered = True
    else:
        n_fft = (MESH[0] * MESH[1]) ** 2 * 32
        x = torch.from_numpy(np.sin(np.arange(n_fft) * 0.01)[None]).to(dev)
        ker = np.exp(-0.5 * np.linspace(-3, 3, 21) ** 2)
        ker /= ker.sum()
        centered = False
    distributed.reset_sent()
    out = w.main_path('fft', lambda: fft_convolve_sharded(
        x, ker, fmesh, centered=centered))
    fft_sent = dict(distributed.SENT)
    n = x.shape[-1]
    k = np.zeros(n)
    k[:len(ker)] = ker
    if centered:
        k = np.roll(k, -(len(ker) // 2))
    xs = x.cpu().numpy()
    want = np.real(np.fft.ifft(np.fft.fft(xs) * np.fft.fft(k)))
    peak = np.abs(want).max(-1)
    L = n // fmesh.size
    err = max(rows_err(out.blocks[0][p].cpu().numpy(),
                       want[:, p * L:(p + 1) * L], peak)
              for p in range(fmesh.size) if out.blocks[0][p] is not None)
    w.check('fft', 'vs_numpy', err <= TOL_FFT, vs_numpy=err, N=n,
            rows=int(xs.shape[0]), sent=fft_sent)
    for p in range(fmesh.size):
        if out.blocks[0][p] is not None:
            w.save(f'fft_{p}', out.blocks[0][p])
    w.timed_together('fft', 'wall_ms', lambda: fft_convolve_sharded(
        x, ker, fmesh, centered=centered))

    rec.update(cells=w.cells, failures=list(w.failures),
               wall_s=time.perf_counter() - t_start,
               ok=not w.failures)
    if w.out_dir is not None:
        np.savez(os.path.join(w.out_dir, f'{layout}_rank{w.rank}.npz'),
                 owners=mesh.owners, **w.saved)
    return rec


def _stack_cells(w, mesh, one):
    """synthesize_stack_sharded (K6 over each time shard's window of
    chunks) on 4 channels of 50 narrow pulses over 65.536 us, and
    play_packed_sharded of a 4-schedule table, 12 shots: each local block
    bit-equal to the same call on the mesh in one process, and the shots to
    ``play_packed`` on one device."""
    import torch

    from .. import WaveVStack, cosPulse
    from ..ops.lowering import lower_schedule
    from ..ops.stack_seq import StackSequencer, synthesize_stack_sharded
    rng = np.random.default_rng(33)
    chans = [WaveVStack([(0.5 * cosPulse(50e-9) >> o)
                         for o in rng.uniform(0, 60e-6, 50)])
             for _ in range(MESH[0])]
    stop = 65.536e-6
    plane = w.main_path('stack', lambda: synthesize_stack_sharded(
        chans, 0.0, stop, FS, mesh))
    _planes_equal(w, 'stack', plane, synthesize_stack_sharded(
        chans, 0.0, stop, FS, one), mesh)
    w.save_blocks('stack', plane, mesh)
    tables = [[WaveVStack([(0.3 * cosPulse(40e-9) >> o)
                           for o in rng.uniform(0, 7e-6, 30)])
               for _ in range(2)] for _ in range(4)]
    seq = StackSequencer([lower_schedule(t, 0.0, 8.192e-6, FS,
                                         bucket_samples=None)
                          for t in tables], device=w.device)
    order = [2, 0, 3, 1, 1, 0, 2, 3, 0, 9, -1, 2]
    shots = w.main_path('play_packed', lambda: seq.play_packed_sharded(
        order, mesh))
    whole = seq.play_packed(order)
    n_local = -(-len(order) // mesh.size)
    ok = True
    for d, ((blk,), owner) in enumerate(zip(shots.blocks,
                                            mesh.owners.flat)):
        if owner == w.rank:
            ok &= bool(torch.equal(blk, whole[d * n_local:
                                              d * n_local + blk.shape[0]]))
    w.check('play_packed', 'vs_play_packed', ok)


def _step_cell(w, cell, name, ba, route, low, mesh, one, tones, rows, host,
               rpt, strict=True):
    """make_step with a filter, its state carried in parallel, against
    scipy, the long double (S1's contract), the step in one process
    (``one``, the same mesh in this process) and its byte bound; S1's
    launches and its state-only call; on the card, the exchange's time and
    S1's."""
    import scipy.signal as sps
    import torch

    from ..distortion import combine_filters
    from ..ops.iir_cases import coefficients
    from . import distributed
    from .pipeline import make_step
    step = make_step(low, mesh, ba_filters=ba, demod_freqs=tones,
                     rows_per_tile=rpt)
    distributed.reset_sent()
    plane, iq = w.main_path(cell, step)
    sent = dict(distributed.SENT)
    d = len(combine_filters(ba)[1]) - 1
    C, nc = low.shape[0], mesh.devices.shape[0]
    c_pad = -(-C // nc) * nc
    bound = c_pad * d * 8 + C * len(tones) * 8
    w.check(cell, 'bytes', sent['bytes'] <= bound, sent=sent,
            bytes_bound=bound, route=route, filter=name,
            mesh=list(mesh.devices.shape))
    _time_exchange(w, cell, sent['bytes'], C, len(tones))
    launched = w.cells[cell]['launches']
    if w.device.type == 'cuda' and route == 'S1':
        # a full call a shard, and a state-only call a shard of a run
        # before its row's last
        full = [(i, j) for i, j in mesh.local if plane.blocks[i][j].shape[1]]
        state = state_shards(plane, mesh)
        w.check(cell, 's1_launched', launched.get('iir_df2t') == len(
            full) + len(state) and w.cells[cell]['state_launches'] == len(
                state), expected_state_launches=len(state))
    elif w.device.type == 'cuda':
        w.check(cell, 'no_s1', not launched.get('iir_df2t'))
    ref_plane, ref_iq = make_step(low, one, ba_filters=ba,
                                  demod_freqs=tones, rows_per_tile=rpt)()
    b, a = combine_filters(ba)
    want = np.stack([sps.lfilter(b, a, h) for h in host])
    peak = np.abs(want).max(-1)
    err_scipy = err_one = 0.0
    s1 = {'parallel_vs_ld': 0.0, 'scipy_vs_ld': 0.0, 'one_process_vs_ld': 0.0}
    if route == 'S1':
        coef = coefficients(b, a)
        dd = len(coef) // 2 - 1
        c_ld = coef.numpy().astype(np.longdouble)
        ld = np.stack([sps.lfilter(c_ld[:dd + 1], c_ld[dd + 1:],
                                   h.astype(np.longdouble)) for h in host])
        s1['scipy_vs_ld'] = rows_err(want, ld.astype(float), peak)
    # each row's peak over the whole row, of the one-process step
    ref_peak = {i: torch.cat(ref_plane.blocks[i], -1).abs().amax(-1)
                for i in range(nc)}
    for i, j in mesh.local:
        blk = plane.blocks[i][j]
        rr, cc = _region(plane, i, j)
        ref = ref_plane.blocks[i][j]
        if blk.numel():
            err_one = max(err_one, float(((blk - ref).abs().amax(-1)
                                          / ref_peak[i].clamp_min(1e-300))
                                         .max()))
        for k, r in enumerate(rows):
            if rr.start <= r < rr.stop and blk.shape[1]:
                got = blk[r - rr.start].cpu().numpy()
                err_scipy = max(err_scipy, rows_err(
                    got, want[k, cc], peak[k]))
                if route == 'S1':
                    truth = ld[k, cc].astype(float)
                    s1['parallel_vs_ld'] = max(s1['parallel_vs_ld'], rows_err(
                        got, truth, peak[k]))
                    s1['one_process_vs_ld'] = max(
                        s1['one_process_vs_ld'], rows_err(
                            ref[r - rr.start].cpu().numpy(), truth, peak[k]))
    w.check(cell, 'vs_scipy', err_scipy <= TOL_SCIPY[name],
            vs_scipy=err_scipy, tol=TOL_SCIPY[name], rows=rows)
    # within 1e-9 of the one-process step; over more time shards than a
    # process holds, by S1's rule: no farther from the long double than
    # twice the one-process step
    w.check(cell, 'vs_one_process', err_one <= TOL_ONE_PROCESS if strict
            else s1['parallel_vs_ld'] <= max(
                TOL_S1_LD * s1['one_process_vs_ld'], TOL_S1_FLOOR),
            vs_one_process=err_one)
    if route == 'S1':
        w.check(cell, 's1_contract', s1['parallel_vs_ld'] <= max(
            TOL_S1_LD * s1['scipy_vs_ld'], TOL_S1_FLOOR), **s1)
    iq_err = float((iq - ref_iq.to(iq.device)).abs().max()
                   / ref_iq.abs().max())
    w.check(cell, 'iq_vs_one_process', iq_err <= TOL_IQ_STEP,
            iq_vs_one_process=iq_err)
    w.save_blocks(cell, plane, mesh)
    w.save(f'{cell}_iq', iq)
    w.save(f'{cell}_sent', sent['bytes'])
    w.save(f'{cell}_bound', bound)
    if route == 'S1':
        _check_state_only(w, cell, ba, plane, mesh)
    if w.device.type == 'cuda' and route == 'S1':
        _time_s1(w, cell, ba, plane, mesh)
    del plane, ref_plane
    if w.device.type == 'cuda':
        torch.cuda.empty_cache()


def _time_exchange(w, cell, sent, C, n_tones):
    """The step's collectives alone, both workers together: an all-gather
    of the boundary states (what the step sent beyond the IQ points) and
    the sum of the (C, n_tones) IQ points -> ``exchange_ms`` a step, of
    card tensors (staged through the host), and ``exchange_host_ms`` of
    the same on host tensors (gloo alone)."""
    import torch

    from . import distributed
    sides = [('exchange_ms', w.device)]
    if distributed.backend() == 'gloo':          # nccl takes card tensors
        sides.append(('exchange_host_ms', 'cpu'))
    for key, dev in sides:
        iq = torch.zeros((C, n_tones), dtype=torch.complex64, device=dev)
        states = torch.zeros((sent - iq.numel() * 8) // 8,
                             dtype=torch.float64, device=dev)

        def exchange(iq=iq, states=states):
            if states.numel():
                distributed.all_gather(states)
            distributed.all_reduce_sum(iq)
        w.timed_together(cell, key, exchange, reps=20)


def state_shards(plane, mesh) -> list:
    """The local shards (i, j), not empty, that the step's carry takes S1's
    state-only call on: those of a run of one process's shards that comes
    before its row's last run (:func:`.pipeline.make_step`)."""
    from .pipeline import _runs
    out = []
    for i in sorted({i for i, _ in mesh.local}):
        runs = _runs(mesh.owners[i])
        out += [(i, j) for o, js in runs[:-1] if o == mesh.rank for j in js
                if plane.blocks[i][j].shape[1]]
    return out


def _check_state_only(w, cell, ba, plane, mesh):
    """S1's state-only call on every local block of the step's plane (its
    shapes), from a seeded start state: its zf bit-equal to the full call's
    on the same block and state and, on the card, to the plain model of the
    kernel's blocked arithmetic (``reference_iir.df2t_blocked``, its
    state-only call) on the same inputs."""
    import torch

    from ..distortion import combine_filters
    from ..ops import reference_iir
    from ..ops.iir_cases import coefficients
    b, a = combine_filters(ba)
    coef = coefficients(b, a, device=w.device)
    d = len(coef) // 2 - 1
    k = w.kernels.iir_df2t
    rng = np.random.default_rng(21)
    rec = {'shapes': [], 'vs_full_call': 0.0,
           'vs_model': 0.0 if w.device.type == 'cuda' else None}
    for i, j in mesh.local:
        x = plane.blocks[i][j].contiguous()
        if not x.shape[1]:
            continue
        zi = torch.from_numpy(rng.standard_normal((x.shape[0], d))).to(
            w.device)
        zf, zf_full = torch.empty_like(zi), torch.empty_like(zi)
        k(x, coef, zi, None, zf)
        k(x, coef, zi, torch.empty_like(x), zf_full)
        rec['vs_full_call'] = max(rec['vs_full_call'],
                                  float((zf - zf_full).abs().max()))
        if w.device.type == 'cuda':
            zb = torch.empty_like(zi)
            reference_iir.df2t_blocked(x, coef, zi, None, zb)
            rec['vs_model'] = max(rec['vs_model'],
                                  float((zf - zb).abs().max()))
        rec['shapes'].append(list(x.shape))
    w.check(cell, 'state_only', rec['vs_full_call'] == 0.0
            and not rec['vs_model'], state_only=rec)


def _time_s1(w, cell, ba, plane, mesh):
    """S1's card time on this process's shards: the step's carry (a
    state-only call on each shard of a run before its row's last, then a
    full call a shard from its carried state) against one full call a
    shard, and the state-only calls alone."""
    import torch

    from ..distortion import combine_filters
    from ..ops.iir_cases import coefficients
    b, a = combine_filters(ba)
    coef = coefficients(b, a, device=w.device)
    d = len(coef) // 2 - 1
    blocks = [plane.blocks[i][j].contiguous() for i, j in mesh.local
              if plane.blocks[i][j].shape[1]]
    state = [plane.blocks[i][j].contiguous()
             for i, j in state_shards(plane, mesh)]
    k = w.kernels.iir_df2t

    def zeros(xs):
        return [torch.zeros((x.shape[0], d), dtype=torch.float64,
                            device=w.device) for x in xs]
    zero, zfs, ys = zeros(blocks), zeros(blocks), [torch.empty_like(x)
                                                   for x in blocks]
    zero_s, zfs_s = zeros(state), zeros(state)

    def state_only():
        for x, z, zf in zip(state, zero_s, zfs_s):
            k(x, coef, z, None, zf)

    def sequential():
        for x, z, y, zf in zip(blocks, zero, ys, zfs):
            k(x, coef, z, y, zf)

    def parallel():
        state_only()
        sequential()
    w.timed(cell, 's1_parallel_ms', parallel)
    w.timed(cell, 's1_sequential_ms', sequential)
    w.timed(cell, 's1_state_only_ms', state_only)


def worker(rank, port, cfg, results):
    """One spawned process: join the group, run every layout, report (a
    layout that raised with the cells it finished)."""
    import datetime

    import torch

    from . import distributed
    report = {'rank': rank, 'ok': False, 'layouts': []}
    w = None
    try:
        torch.set_num_threads(cfg['threads'])
        if cfg['device'] == 'cuda':
            device = f'cuda:{rank % torch.cuda.device_count()}'
            torch.cuda.set_device(device)
        else:
            device = 'cpu'
        distributed.init_distributed(
            f'tcp://localhost:{port}', N_PROC, rank, cfg['backend'],
            timeout=datetime.timedelta(seconds=cfg['collective_timeout']))
        try:
            w = Worker(rank, device, cfg['size'], cfg['out'])
            for layout in cfg['layouts']:
                report['layouts'].append(run_layout(w, layout,
                                                    cfg['backend']))
            report['ok'] = all(r['ok'] for r in report['layouts'])
        finally:
            distributed.shutdown()
    except Exception:          # reported, and the worker exits 1
        report['error'] = traceback.format_exc()[-4000:]
        if w is not None and len(report['layouts']) < len(cfg['layouts']):
            report['layouts'].append({
                'layout': cfg['layouts'][len(report['layouts'])],
                'ok': False, 'cells': w.cells, 'failures': w.failures,
                'wall_s': None, 'local': [], 'raised': True})
    results.put(report)
    if not report['ok']:
        sys.exit(1)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(('localhost', 0))
        return s.getsockname()[1]


def run(backend, device='cuda', layouts=('jax',), size='small',
        out=None, timeout=600.0, threads=None, collective_timeout=120.0):
    """Spawn the two workers and wait for them -> (ok, their reports, in
    rank order).  ``backend`` is 'gloo' or 'nccl', named by the caller;
    ``device`` 'cuda' (the default) or 'cpu', the plain versions.  A worker still running after ``timeout`` seconds is
    killed, and counts as failed; a collective that waits on a peer for
    ``collective_timeout`` seconds fails its worker."""
    import multiprocessing as mp

    # the module by its import name, so that the spawned workers import it
    # and not a copy of the caller's __main__
    from waveforms_tpu_torch.parallel import multiproc_smoke
    ctx = mp.get_context('spawn')
    results = ctx.Queue()
    cfg = {'device': device, 'backend': backend, 'layouts': list(layouts),
           'size': size, 'out': out, 'collective_timeout': collective_timeout,
           'threads': threads or (2 if device == 'cpu' else 4)}
    port = free_port()
    procs = [ctx.Process(target=multiproc_smoke.worker,
                         args=(r, port, cfg, results)) for r in range(N_PROC)]
    for p in procs:
        p.start()
    reports = {}
    deadline = time.monotonic() + timeout
    try:
        while len(reports) < N_PROC and time.monotonic() < deadline:
            try:
                rep = results.get(timeout=1.0)
                reports[rep['rank']] = rep
            except queue_mod.Empty:
                if any(p.exitcode not in (None, 0) for p in procs) and all(
                        p.exitcode is not None for p in procs):
                    break
        for p in procs:
            p.join(max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    ok = True
    out_reports = []
    for r, p in enumerate(procs):
        rep = reports.get(r, {'rank': r, 'ok': False,
                              'error': 'no report (died or timed out)'})
        rep['exitcode'] = p.exitcode
        ok &= bool(rep['ok']) and p.exitcode == 0
        out_reports.append(rep)
    return ok, out_reports


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--device', choices=('cpu', 'cuda'), default='cuda')
    ap.add_argument('--backend', choices=('gloo', 'nccl'), required=True)
    ap.add_argument('--layout', choices=tuple(LAYOUTS), nargs='+',
                    default=['jax'])
    ap.add_argument('--size', choices=('small', 'full'), default='small')
    ap.add_argument('--out', help="write each worker's blocks and results "
                    "to DIR/<layout>_rank<r>.npz")
    ap.add_argument('--timeout', type=float, default=600.0)
    args = ap.parse_args(argv)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
    ok, reports = run(args.backend, args.device, args.layout, args.size,
                      args.out, args.timeout)
    for rep in reports:
        print(json.dumps(rep, default=str), flush=True)
    print("MULTIPROC OK" if ok else "MULTIPROC FAILED", flush=True)
    return 0 if ok else 1


if __name__ == '__main__':
    sys.exit(main())
