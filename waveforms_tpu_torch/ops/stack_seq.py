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

``play_packed_sharded``, ``synthesize_stack_sharded`` and
``n_super_multiple`` (the multi-device paths) are not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from .lowering import OP_DRAG_SIN, OP_DRAG_SINX, LoweredSchedule, \
    UnsupportedFactor
from .stack_synth import (StackPlan, StackTables, build_stack_plan,
                          build_stack_tables)
from .synth import dac_scale_tensor, normalize_out_dtype, resolve_device

__all__ = ['StackSequencer']


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
    """

    def __init__(self, lows: list[LoweredSchedule],
                 plans: list[StackPlan] | None = None, device='cuda'):
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
        for name in ('inst', 'amp', 'term_nfac', 'op', 'power', 'shift_hi',
                     'q32', 'args', 'ext', 'blk_inst', 'blk_row',
                     'chunk_start'):
            setattr(tables, name,
                    getattr(tables, name).contiguous().to(self.device))
        return tables

    def describe(self) -> str:
        """One-line table summary (debugging / logging aid)."""
        t = self.tables
        nbytes = sum(getattr(t, n).numel() * getattr(t, n).element_size()
                     for n in ('inst', 'amp', 'term_nfac', 'op', 'power',
                               'shift_hi', 'q32', 'args', 'ext', 'blk_inst',
                               'blk_row', 'chunk_start'))
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
        from .. import kernels
        dt = normalize_out_dtype(out_dtype)
        if dt == torch.int16 and np.ndim(dac_scale) != 0:
            raise UnsupportedFactor(
                "stacked-table int16 supports a scalar dac_scale")
        scale = dac_scale_tensor(dt, dac_scale, self.n_channels, self.device)
        ks = torch.as_tensor(ks, device=self.device)
        if ks.dim() != 1:
            raise ValueError("ks must be a 1-D vector of schedule indices")
        ks = ks.clamp(-2 ** 31, 2 ** 31 - 1).to(torch.int32).contiguous()
        out = torch.empty((ks.shape[0], self.n_channels, self.n_samples),
                          dtype=dt, device=self.device)
        return kernels.synth_stack_seq(self.tables, ks, out, scale)

    def play(self, k, out_dtype=None,
             dac_scale: float = 32767.0) -> torch.Tensor:
        """Synthesize schedule ``k`` -> (C, N) (a one-shot launch)."""
        return self.play_packed(torch.as_tensor(k).reshape(1),
                                out_dtype=out_dtype, dac_scale=dac_scale)[0]
