"""Stacked-table sequence playback on the stack path (K6).

:class:`StackSequencer` is the JAX package's
``waveforms_tpu.ops.stack_seq.StackSequencer`` for one device: K schedules
made of many narrow pulses (randomized-benchmarking tables, sparse gate
trains) stay on the device as one stacked table, and a whole shot vector
plays in ONE launch of the sequenced stack kernel
(``csrc/synth_stack_seq.cu``; on the CPU its plain version
:func:`.reference.stack_seq_eval`), each shot evaluating only its own
schedule's pulse blocks.

The stacked table is the port's own K5 tables
(:func:`.stack_synth.build_stack_tables`, one per schedule) concatenated:
the instance arrays along M, padded to the table-wide term and factor
widths, with each schedule's instance base added to its ``blk_inst``; the
block lists one after another; ``chunk_start`` as a (K, C * n_chunks + 1)
table of absolute offsets into the concatenated block list; and the ext
buffers one after another, with each drag_sin factor's offset
(``args[..., 7]``) rewritten into the concatenated buffer -- as
:class:`.sequencer.Sequencer` rewrites its offsets -- so that the kernel's
walk is K5's, unchanged.  A schedule whose plan lacks a factor-structure
group simply has no instances of it, so the JAX group-key union and its
``KERNEL_MAX_GROUPS`` check have nothing to do here.

Not carried over, with the TPU table layout they guarded: the JAX
``_kernel_runner_viable`` limits (groups, ext per instance), the SMEM
budget on the stacked count tables, ``KERNEL_MAX_VMEM`` and
``KERNEL_MAX_HBM``, and the ``WFTPU_STACK_*`` levers.  The semantic
refusals stay, with the JAX messages: a multi-bucket table, a schedule with
no batchable instances (plan None), a plan with a wide residual ("wide"),
plans that do not pair 1:1 with the lows, and a per-channel ``dac_scale``
with int16.  Long schedules are lowered with ``bucket_samples=None`` (one
bucket), as the JAX ``synthesize_stack_sharded`` lowers them.

The multi-device paths: :meth:`StackSequencer.play_packed_sharded` splits
a shot vector over every device of a mesh (:mod:`..parallel.mesh`), each
device playing its slice on its own copy of the table, made once per
device; :func:`synthesize_stack_sharded` runs one schedule's channel blocks
as the K schedules of a table per channel shard and splits each one's
chunks over the time shards, K6 evaluating a window of chunks at their
global rows.  ``n_super_multiple`` rounds the table's count of thread-block
groups (CTA_CHUNKS chunks each, the port's counterpart of the TPU's
superchunk) up to a multiple, so that each time shard gets the same number
of whole groups.
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from .lowering import OP_DRAG_SIN, OP_DRAG_SINX, LoweredSchedule, \
    UnsupportedFactor
from .stack_synth import (CHUNK_ROWS, CTA_CHUNKS, StackPlan, StackTables,
                          build_stack_plan, build_stack_tables)
from .synth import dac_scale_tensor, normalize_out_dtype, resolve_device

__all__ = ['StackSequencer', 'synthesize_stack_sharded']

_TABLE_TENSORS = ('inst', 'amp', 'term_nfac', 'op', 'power', 'shift_hi',
                  'q32', 'args', 'ext', 'blk_inst', 'blk_row', 'chunk_start')


def _widen(a: torch.Tensor, width: int, fill=0) -> torch.Tensor:
    """Pad axis 1 of ``a`` to ``width`` with ``fill``."""
    extra = width - a.shape[1]
    if extra == 0:
        return a
    return torch.cat([a, a.new_full((a.shape[0], extra, *a.shape[2:]),
                                    fill)], 1)


class StackSequencer:
    """K narrow-pulse schedules stacked into one table on ``device``.

    All schedules must share channel count, sample count and sample rate,
    lower to one bucket, lower real (no pair mode) and have NO wide
    residual (every instance narrow, no finite clip rails).  ``plans`` may
    be passed pre-built (one :class:`.stack_synth.StackPlan` per lowering);
    otherwise they are built here.  ``device='cuda'`` without a GPU raises;
    ``device='cpu'`` plays through the kernel's plain version.
    ``n_super_multiple`` rounds :attr:`n_super`, the table's thread-block
    groups of CTA_CHUNKS chunks a channel, up to a multiple (a mesh's
    time shards).
    """

    def __init__(self, lows: list[LoweredSchedule],
                 plans: list[StackPlan] | None = None, device='cuda',
                 n_super_multiple: int = 1):
        if not lows:
            raise ValueError("empty sequence table")
        self.device = resolve_device(device)
        first = lows[0]
        for low in lows:
            if (low.shape[0], low.n_samples, low.sample_rate,
                    low.shape[1]) != (first.shape[0], first.n_samples,
                                      first.sample_rate, first.shape[1]):
                raise ValueError(
                    "sequence schedules must share channels, samples and "
                    "sample rate")
            if low.shape[1] != 1:
                raise UnsupportedFactor("stacked-table play is single-bucket")
        if plans is None:
            plans = [build_stack_plan(low) for low in lows]
        elif len(plans) != len(lows):
            raise ValueError(
                f"{len(plans)} pre-built plans for {len(lows)} schedules "
                "-- plans must pair 1:1 with lows")
        for k, plan in enumerate(plans):
            if plan is None:
                raise UnsupportedFactor(
                    f"schedule {k} has no batchable pulse instances "
                    "(complex, clipped, or empty) -- use Sequencer")
            if plan.wide is not None:
                raise UnsupportedFactor(
                    f"schedule {k} has wide instances (plateaus/carriers) "
                    "-- the stacked-table launch is narrow-pulse only; "
                    "use Sequencer.play_packed")
        n_rows = plans[0].n_rows
        for k, (p, low) in enumerate(zip(plans, lows)):
            if (p.n_rows != n_rows or p.n_channels != low.shape[0]
                    or p.n_samples != low.n_samples):
                raise ValueError(
                    f"plans[{k}] does not match lows[{k}] "
                    f"(rows {p.n_rows}/{n_rows}, ch {p.n_channels}/"
                    f"{low.shape[0]}, samples {p.n_samples}/"
                    f"{low.n_samples}) -- plans must pair 1:1 with lows")
        self.n_schedules = len(lows)
        self.n_channels = first.shape[0]
        self.n_samples = first.n_samples
        self.sample_rate = first.sample_rate
        self.tables = self._stack([build_stack_tables(p, low, 'cpu')
                                   for p, low in zip(plans, lows)])
        ns = -(-self.tables.n_chunks // CTA_CHUNKS)
        self.n_super = -(-ns // n_super_multiple) * n_super_multiple
        self._copies = {str(self.tables.inst.device): self.tables}

    def _stack(self, parts: list[StackTables]) -> StackTables:
        """Concatenate per-schedule tables (on the CPU), then upload."""
        NT = max(t.NT for t in parts)
        TF = max(t.TF for t in parts)
        inst_base = np.cumsum([0] + [t.inst.shape[0] for t in parts])
        blk_base = np.cumsum([0] + [t.n_blocks for t in parts])
        ext_base = np.cumsum([0] + [t.ext.shape[0] for t in parts])
        args = []
        for t, base in zip(parts, ext_base):
            a, op = _widen(t.args, TF).clone(), _widen(t.op, TF)
            drag = (op == OP_DRAG_SIN) | (op == OP_DRAG_SINX)
            a[..., 7] = torch.where(drag, a[..., 7] + float(base), a[..., 7])
            args.append(a)

        def cat(name, width=None, fill=0):
            return torch.cat([getattr(t, name) if width is None
                              else _widen(getattr(t, name), width, fill)
                              for t in parts])

        t0 = parts[0]
        tables = StackTables(
            n_channels=t0.n_channels, n_samples=t0.n_samples,
            n_chunks=t0.n_chunks, NT=NT, TF=TF,
            inst=cat('inst'), amp=cat('amp', NT),
            term_nfac=cat('term_nfac', NT), op=cat('op', TF),
            power=cat('power', TF, 1), shift_hi=cat('shift_hi', TF),
            q32=cat('q32', TF), args=torch.cat(args), ext=cat('ext'),
            blk_inst=torch.cat([t.blk_inst + int(b)
                                for t, b in zip(parts, inst_base)]),
            blk_row=cat('blk_row'),
            chunk_start=torch.stack([t.chunk_start + int(b)
                                     for t, b in zip(parts, blk_base)]))
        for name in _TABLE_TENSORS:
            setattr(tables, name,
                    getattr(tables, name).contiguous().to(self.device))
        return tables

    def tables_on(self, device) -> StackTables:
        """The table on ``device``: the one made at construction, or a copy
        made at the first call for that device and kept (the waveform
        memory is uploaded once per device, as the JAX package replicates
        it once per mesh)."""
        from ..parallel.mesh import canonical_device
        key = str(canonical_device(device))
        if key not in self._copies:
            t = copy.copy(self.tables)
            for name in _TABLE_TENSORS:
                setattr(t, name, getattr(t, name).to(key))
            self._copies[key] = t
        return self._copies[key]

    def describe(self) -> str:
        """One-line table summary (debugging / logging aid)."""
        t = self.tables
        nbytes = sum(getattr(t, n).numel() * getattr(t, n).element_size()
                     for n in _TABLE_TENSORS)
        return (f"{self.n_schedules} schedules x {self.n_channels} ch x "
                f"{self.n_samples} samples, {t.inst.shape[0]} instances, "
                f"{t.n_blocks} blocks, {t.n_chunks} chunks/channel, "
                f"{nbytes >> 10} KiB device tables")

    def play_packed(self, ks, out_dtype=None,
                    dac_scale: float = 32767.0) -> torch.Tensor:
        """Synthesize the shot sequence ``ks`` in ONE kernel launch
        -> (len(ks), C, N).

        ``ks`` goes to the device as int32 and the kernel clamps each
        index to [0, K-1] itself: the host never reads it, so a shot
        vector computed on the card needs no host sync.
        ``out_dtype=torch.int16`` emits DAC codes scaled by the scalar
        ``dac_scale`` (quantized in the kernel's store);
        ``torch.bfloat16`` / ``torch.float16`` round the f32 sum once in
        the store, with no scale."""
        out, launch = self._launch(ks, out_dtype, dac_scale, self.device)
        launch()
        return out

    def _launch(self, ks, out_dtype, dac_scale, device, chunk0=0,
                n_chunks=None):
        """The K6 launch that plays ``ks`` on ``device`` over chunks
        [chunk0, chunk0 + n_chunks) of every channel -> (its output,
        allocated here, and a call that launches into it)."""
        from .. import kernels
        from .reference import stack_window
        dt = normalize_out_dtype(out_dtype)
        if dt == torch.int16 and np.ndim(dac_scale) != 0:
            raise UnsupportedFactor(
                "stacked-table int16 supports a scalar dac_scale")
        tables = self.tables_on(device)
        device = tables.inst.device
        scale = dac_scale_tensor(dt, dac_scale, self.n_channels, device)
        ks = torch.as_tensor(ks, device=device)
        if ks.dim() != 1:
            raise ValueError("ks must be a 1-D vector of schedule indices")
        ks = ks.clamp(-2 ** 31, 2 ** 31 - 1).to(torch.int32).contiguous()
        chunk0, n_chunks, n_local = stack_window(tables, chunk0, n_chunks)
        out = torch.empty((ks.shape[0], self.n_channels, n_local), dtype=dt,
                          device=device)
        return out, lambda: kernels.synth_stack_seq(tables, ks, out, scale,
                                                    chunk0, n_chunks)

    def play(self, k, out_dtype=None,
             dac_scale: float = 32767.0) -> torch.Tensor:
        """Synthesize schedule ``k`` -> (C, N) (a one-shot launch)."""
        return self.play_packed(torch.as_tensor(k).reshape(1),
                                out_dtype=out_dtype, dac_scale=dac_scale)[0]

    def packed_shards(self, ks, mesh, out_dtype=None,
                      dac_scale: float = 32767.0):
        """The launches of :meth:`play_packed_sharded`, not yet run."""
        from ..parallel.mesh import ShardRun
        ks = np.asarray(ks.cpu() if isinstance(ks, torch.Tensor) else ks,
                        np.int64).reshape(-1)
        n_shots = len(ks)
        n_dev = mesh.size
        n_local = -(-n_shots // n_dev)
        # padding shots render schedule 0 and are cut off
        ks_pad = np.zeros(n_local * n_dev, np.int64)
        ks_pad[:n_shots] = ks
        run = ShardRun((n_dev, 1), n_dev, 1, normalize_out_dtype(out_dtype),
                       [self.n_samples],
                       None if mesh.plane_owners is None
                       else mesh.owners.reshape(n_dev, 1))
        for d, (device, owner) in enumerate(zip(mesh.devices.flat,
                                                mesh.owners.flat)):
            if owner == mesh.rank:           # another process's: its own
                run.add(d, 0, *self._launch(
                    ks_pad[d * n_local:(d + 1) * n_local], out_dtype,
                    dac_scale, device))
        run.n_shots, run.n_local = n_shots, n_local
        return run

    def play_packed_sharded(self, ks, mesh, out_dtype=None,
                            dac_scale: float = 32767.0):
        """Shot-parallel :meth:`play_packed` over every device of ``mesh``
        -> a :class:`..parallel.mesh.ShardedPlane` of the (len(ks), C, N)
        shots, one block of shots per device (``gather()`` for the tensor).

        The table is copied to each device once and kept (each device
        holds the whole waveform memory, the right trade for a shot
        fan-out, where the table is small and the shot batch scales), and
        the shot vector splits over the mesh's devices in mesh order: each
        plays its contiguous slice in one K6 launch (on a mesh that spans
        processes, each process its own devices' slices).  ``ks`` pads to a
        multiple of the device count; the padding shots render schedule 0
        and are cut off."""
        from ..parallel.mesh import ShardedPlane
        run = self.packed_shards(ks, mesh, out_dtype, dac_scale).run()
        keep = [max(0, min(run.n_local, run.n_shots - d * run.n_local))
                for d in range(len(run.blocks))]
        blocks = [[None if b is None else b[:k]]
                  for (b,), k in zip(run.blocks, keep)]
        shapes = [[(k, self.n_channels, self.n_samples)] for k in keep]
        return ShardedPlane(blocks, (run.n_shots, self.n_channels,
                                     self.n_samples), run.dtype, run.owners,
                            shapes)


def stack_shards(channels, start: float, stop: float, sample_rate: float,
                 mesh, out_dtype=None, dac_scale: float = 32767.0):
    """The launches of :func:`synthesize_stack_sharded`, not yet run; the
    channel shards' sequencers are its ``seqs``."""
    from ..parallel.mesh import ShardRun, time_windows
    from .lowering import lower_schedule
    nc, nt = mesh.devices.shape
    C = len(channels)
    if C % nc:
        raise UnsupportedFactor(
            f"{C} channels do not split over {nc} channel shards")
    cs = C // nc
    # bucket_samples=None: the stack tables are chunk-indexed directly,
    # so descriptor time-bucketing would only forbid the path.  A channel
    # shard's table lives on its first local shard's device; a process
    # builds none for a row it holds no shard of
    seqs = []
    for i in range(nc):
        js = [j for j in range(nt) if mesh.is_local(i, j)]
        seqs.append(StackSequencer(
            [lower_schedule(list(channels[i * cs:(i + 1) * cs]), start,
                            stop, sample_rate, bucket_samples=None)],
            device=mesh.device(i, js[0]), n_super_multiple=nt)
            if js else None)
    built = [s for s in seqs if s is not None]
    if not built:
        raise ValueError("this process owns no shard of the mesh")
    n = built[0].n_samples
    groups = built[0].n_super // nt            # thread-block groups a shard
    span = groups * CTA_CHUNKS * CHUNK_ROWS * 128
    run = ShardRun((nc, nt), C, cs, normalize_out_dtype(out_dtype),
                   [b - a for a, b in time_windows(n, span, nt)],
                   mesh.plane_owners)
    run.seqs = seqs
    for i, seq in enumerate(seqs):
        for j, (a, b) in enumerate(time_windows(n, span, nt)):
            if not mesh.is_local(i, j):
                continue
            chunk0 = j * groups * CTA_CHUNKS
            n_chunks = min(groups * CTA_CHUNKS, seq.tables.n_chunks - chunk0)
            if b == a:                          # wholly past the end
                run.add(i, j, torch.empty(
                    (cs, 0), dtype=run.dtype, device=mesh.device(i, j)))
                continue
            out, launch = seq._launch([0], out_dtype, dac_scale,
                                      mesh.device(i, j), chunk0, n_chunks)
            run.add(i, j, out[0], launch)
    return run


def synthesize_stack_sharded(channels, start: float, stop: float,
                             sample_rate: float, mesh, out_dtype=None,
                             dac_scale: float = 32767.0):
    """Stack-path synthesis over a ('channel', 'time') mesh, one K6 launch
    per shard -> :class:`..parallel.mesh.ShardedPlane`.

    The multi-device twin of :func:`.stack_synth.synthesize_stack` for
    vstack-class schedules (many narrow pulse instances): each channel
    shard's channels lower separately, with ``bucket_samples=None``, into a
    :class:`StackSequencer` of one schedule on its device, and each time
    shard plays that table's window of whole thread-block groups of chunks
    (``n_super_multiple`` = the time shards), evaluated at their global
    rows.  Per-shard table bytes scale as 1/nc and chunk counts as 1/P.

    Raises UnsupportedFactor as the JAX package does: a channel count that
    does not split over the channel shards, a schedule outside the
    stacked-table launch (wide instances; no pair mode: it lowers the real
    part), and int16 with a per-channel ``dac_scale``."""
    return stack_shards(channels, start, stop, sample_rate, mesh, out_dtype,
                        dac_scale).run().plane()
