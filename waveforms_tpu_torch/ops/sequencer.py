"""Sequence tables: K lowered schedules on the device, played by index.

Lab control stacks upload K compiled schedules once -- randomized-
benchmarking orders, parameter sweeps, feedback branches -- and then play
shots by index, as an AWG plays its waveform memory.  :class:`Sequencer`
is that table for the segment-walk kernels, as the JAX package's
``waveforms_tpu.ops.sequencer.Sequencer`` builds it: every schedule's
descriptor arrays pad to one ``(C, NB, Sb, T, F)`` and stack along a
leading schedule axis on the device, and

* :meth:`~Sequencer.play_many` runs the dense kernel (K1,
  ``csrc/synth_dense.cu``) ONCE for a whole shot vector through its shot
  entry, into one ``(n_shots, C, N)`` output, as JAX's ``vmap`` over the
  index makes one batched launch; :meth:`Sequencer.play` is one shot of
  it;
* :meth:`~Sequencer.play_sparse` (and ``play_many(sparse=True)``) runs the
  worklist kernel (K7, ``csrc/synth_sparse.cu``) the same way, over the
  table's stacked per-schedule live-subtile worklists;
* :meth:`~Sequencer.play_packed` runs the panel kernel (K2,
  ``csrc/synth_panel.cu``) ONCE for a whole shot vector, over the tables
  concatenated along the segment axis, with the per-shot segment ranges
  gathered on the device from ``ks``;
* :meth:`~Sequencer.play_replay` synthesizes the K schedules once into a
  ``(K, C, N)`` palette and gathers its rows (``index_select``).

The shot entries of K1 and K7 take the table's stacked tensors as they
are and read each shot's index on the device, and play_packed and
play_replay gather on the device: a shot index or vector may be an int, a
list, a numpy array or a tensor, and one that is a CUDA tensor (a shot
order computed from a measurement on the card) is never read on the host,
so it plays with no host sync.  A slice or concatenation reaches the
kernels as a :class:`.synth.DeviceSchedule` built by ``from_tensors``: no
copy through the host.  Opcodes stay the lowering's own numbers (the
kernels switch on them); the JAX table's compact opcode remap is kept only
as the ``ops_present`` attribute.  Indices clamp to the table's ends, as
JAX's ``mode='clip'`` gathers do: ``k = 99`` plays the last schedule,
``k = -3`` schedule 0 (never Python's wrap-around).

The TPU budgets are not carried over -- GPU descriptors, worklists and ext
buffers live in global memory: ``PALLAS_SMEM_BUDGET`` on the concatenated
table of ``play_packed``, ``PANEL_WORK_SMEM_BUDGET`` on its worklist,
``PALLAS_EXT_MAX`` on the merged ext buffer, and the byte half of
``LoweredSchedule.pallas_ok``.  The refusal that stays is what the kernels
can evaluate: a schedule with an opcode outside ``PALLAS_OPS`` raises
:class:`.lowering.UnsupportedFactor`.  The shot pipeline with filters and
demodulation over a table is
:func:`waveforms_tpu_torch.parallel.run_sequence`.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from types import SimpleNamespace

import numpy as np
import torch

from ..utils.profiling import annotate
from .lowering import (OP_DRAG_SIN, OP_DRAG_SINX, PALLAS_OPS, SEG_SENTINEL,
                       W_ARGS, LoweredSchedule, UnsupportedFactor)
from .sparse_synth import (PANEL_ROWS, PanelWork, SparseWork,
                           build_sparse_plan, next_pow2)
from .synth import (DeviceSchedule, default_rows_per_tile, resolve_device,
                    validate_out_mode)

__all__ = ['Sequencer']


def _pad_to(arr: np.ndarray, shape, fill=0) -> np.ndarray:
    widths = [(0, s - a) for a, s in zip(arr.shape, shape)]
    return np.pad(arr, widths, constant_values=fill)


class Sequencer:
    """Stack lowered schedules into one sequence table on ``device``.

    All schedules must share channel count, sample count, sample rate and
    bucketing (lower them with the same ``bucket_samples``); complex
    (pair-mode) tables need every schedule lowered with ``part='complex'``.
    ``device='cuda'`` without a GPU raises; ``device='cpu'`` plays through
    the kernels' plain versions.

    Tensors (on ``device``): ``seg_lo``, ``seg_hi``, ``seg_hmax``, ``nterm``
    (K, C, NB, Sb), segment slots padded with ``SEG_SENTINEL``; ``nfac``,
    ``amp`` (and ``amp_im``) (K, C, NB, Sb, T); ``op``, ``power``,
    ``shift_hi`` (K, C, NB, Sb, T, F); ``q32`` (..., 4); ``args``
    (..., W_ARGS) with the drag_sin ext offsets rewritten into ``ext``, ONE
    table-wide buffer of every schedule's ext blocks (identical blocks
    merged); ``clip`` (K, C, 2).
    """

    def __init__(self, schedules: list[LoweredSchedule], device='cuda'):
        if not schedules:
            raise ValueError("empty sequence table")
        self.device = resolve_device(device)
        # host views for the worklists: segment bounds and counts only
        self._plan_views = [SimpleNamespace(
            shape=low.shape, n_samples=low.n_samples,
            bucket_samples=low.bucket_samples,
            seg_lo=np.array(low.seg_lo), seg_hi=np.array(low.seg_hi),
            nterm=np.array(low.nterm)) for low in schedules]
        first = schedules[0]
        for low in schedules:
            if not np.all(np.isin(low.op, list(PALLAS_OPS))):
                raise UnsupportedFactor(
                    "schedule uses opcodes outside the kernels' set")
            if (low.shape[0], low.n_samples, low.sample_rate,
                    low.bucket_samples, low.shape[1]) != (
                    first.shape[0], first.n_samples, first.sample_rate,
                    first.bucket_samples, first.shape[1]):
                raise ValueError(
                    "sequence schedules must share channels, samples, "
                    "sample rate and bucketing")
        pair = [low.amp_im is not None for low in schedules]
        if any(pair) and not all(pair):
            raise ValueError("mix of real and complex (part='complex') "
                             "schedules in one table")
        self.pair = pair[0]

        C, NB = first.shape[0], first.shape[1]
        Sb = max(low.shape[2] for low in schedules)
        T = max(low.shape[3] for low in schedules)
        F = max(low.shape[4] for low in schedules)
        self.shape = (C, NB, Sb, T, F)
        self.n_samples = first.n_samples
        self.sample_rate = first.sample_rate
        self.bucket_samples = first.bucket_samples
        self.n_schedules = len(schedules)
        self.ops_present = tuple(int(o) for o in np.unique(np.concatenate(
            [np.unique(low.op) for low in schedules])))

        # merge the ext buffers into one table-wide buffer and point each
        # drag_sin factor's offset (args[..., 7]) into it
        ext_merged: list = []
        ext_seen: dict = {}
        args_rw = []
        for low in schedules:
            a = np.array(low.args, copy=True)
            src = np.asarray(low.ext if low.ext is not None else [],
                             np.float64)
            for pos in np.argwhere(
                    np.isin(low.op, (OP_DRAG_SIN, OP_DRAG_SINX))):
                p = tuple(pos)
                off, ln = int(a[p + (7,)]), int(a[p + (8,)])
                block = src[off:off + ln]
                key = block.tobytes()
                goff = ext_seen.get(key)
                if goff is None:
                    goff = len(ext_merged)
                    ext_merged.extend(block.tolist())
                    ext_seen[key] = goff
                a[p + (7,)] = goff
            args_rw.append(a)
        ext = np.zeros(max(len(ext_merged), 1), np.float32)
        ext[:len(ext_merged)] = ext_merged

        def put(a, dtype):
            return torch.from_numpy(
                np.ascontiguousarray(a, dtype=dtype)).to(self.device)

        def stack(get, shape, dtype, fill=0):
            return put(np.stack([_pad_to(np.asarray(get(low)), shape, fill)
                                 for low in schedules]), dtype)

        seg, fac = (C, NB, Sb), (C, NB, Sb, T, F)
        self.seg_lo = stack(lambda l: l.seg_lo, seg, np.int32, SEG_SENTINEL)
        self.seg_hi = stack(lambda l: l.seg_hi, seg, np.int32, SEG_SENTINEL)
        self.seg_hmax = stack(lambda l: np.maximum.accumulate(l.seg_hi, -1),
                              seg, np.int32, SEG_SENTINEL)
        self.nterm = stack(lambda l: l.nterm, seg, np.int32)
        self.nfac = stack(lambda l: l.nfac, seg + (T,), np.int32)
        self.amp = stack(lambda l: l.amp, seg + (T,), np.float32)
        self.op = stack(lambda l: l.op, fac, np.int32)
        self.power = stack(lambda l: l.power, fac, np.int32)
        self.shift_hi = stack(lambda l: l.shift_hi, fac, np.int32)
        self.q32 = stack(lambda l: l.q32, fac + (4,), np.int32)
        self.args = put(np.stack([_pad_to(a, fac + (W_ARGS,))
                                  for a in args_rw]), np.float32)
        self.ext = put(ext, np.float32)
        self.clip = stack(lambda l: np.stack([l.clip_min, l.clip_max], 1),
                          (C, 2), np.float32)
        self.amp_im = (stack(lambda l: l.amp_im, seg + (T,), np.float32)
                       if self.pair else None)

        # packed playback serves many shots from one table: the clip rails
        # must be the same in every schedule (ext is merged above)
        self._clip_uniform = all(
            np.array_equal(low.clip_min, first.clip_min)
            and np.array_equal(low.clip_max, first.clip_max)
            for low in schedules)
        self._sparse_work = {}
        self._packed_tensors_cache = None
        self._packed_plans = {}
        self._palettes = {}
        # parallel.run_sequence's shot programs by key, the least recently
        # used first, under their lock; graph_hits / graph_misses count
        # its lookups
        self._shot_programs = OrderedDict()
        self._shot_programs_lock = threading.Lock()
        self.graph_hits = self.graph_misses = 0

    def describe(self) -> str:
        """One-line table summary (debugging / logging aid)."""
        C, NB, Sb, T, F = self.shape
        return (f"{self.n_schedules} schedules x {C} ch x "
                f"{self.n_samples} samples, {NB} bucket(s), padded "
                f"Sb={Sb} T={T} F={F}, opcodes {list(self.ops_present)}, "
                f"{'complex' if self.pair else 'real'}")

    def _clamp(self, k) -> int:
        return min(max(int(k), 0), self.n_schedules - 1)

    def shot_indices(self, ks, dim: int = 1) -> torch.Tensor:
        """Schedule indices as the shot entries take them: an int32
        (n_shots,) tensor on the table's device, from one index (``dim``
        0) or a vector (1), clamped to ``[0, K - 1]``.  A tensor on the
        card is clamped there (one elementwise launch; the kernels clamp
        again as a guard, but ``index_select`` and the packed plan's gather
        take these indices as they are) and is never read on the host;
        host indices are clamped on the host and reach the card through
        pinned memory, without a wait."""
        if isinstance(ks, torch.Tensor) and ks.device.type != 'cpu':
            if ks.dim() != dim:
                raise ValueError(f"expected a {dim}-D index, got "
                                 f"{ks.dim()}-D")
            return ks.reshape(-1).to(self.device).clamp(
                0, self.n_schedules - 1).to(torch.int32)
        a = np.asarray(ks.numpy() if isinstance(ks, torch.Tensor) else ks)
        if a.ndim != dim:
            raise ValueError(f"expected a {dim}-D index, got {a.ndim}-D")
        a = np.clip(a.reshape(-1).astype(np.int64), 0, self.n_schedules - 1)
        host = torch.from_numpy(a.astype(np.int32))
        if self.device.type == 'cuda':
            return host.pin_memory().to(self.device, non_blocking=True)
        return host

    def _schedule(self, k: int) -> DeviceSchedule:
        """Slice ``k`` of the table as a DeviceSchedule (views, no copy):
        what a one-shot launch, and the shot entries' plain versions,
        take."""
        names = ('seg_lo', 'seg_hi', 'seg_hmax', 'nterm', 'nfac', 'amp', 'op',
                 'power', 'shift_hi', 'q32', 'args', 'clip')
        return DeviceSchedule.from_tensors(
            self.shape, self.n_samples, self.bucket_samples, ext=self.ext,
            amp_im=self.amp_im[k] if self.pair else None,
            **{n: getattr(self, n)[k] for n in names})

    def _check_rows(self, rows_per_tile):
        """The JAX dense grid's tile rule.  The CUDA kernel picks its own
        tile, so ``rows_per_tile`` is only validated, as JAX validates it."""
        C, NB = self.shape[:2]
        R = rows_per_tile or default_rows_per_tile(
            self.n_samples, self.bucket_samples, NB)
        if NB > 1 and self.bucket_samples % (R * 128) != 0:
            raise ValueError(
                f"bucket_samples {self.bucket_samples} must be a multiple "
                f"of the tile ({R * 128})")

    def play(self, k, rows_per_tile: int | None = None, out_dtype=None,
             dac_scale=32767.0) -> torch.Tensor:
        """Synthesize schedule ``k`` (an int or a 0-d tensor) -> (C, N):
        one shot of :meth:`play_many`.

        ``out_dtype=torch.int16`` emits DAC codes scaled by a scalar or
        per-channel ``dac_scale``, ``torch.bfloat16`` / ``torch.float16``
        the f32 sum rounded once; pair-mode tables give complex64 and need
        f32."""
        with annotate('wf.play.prepare'):
            ks = self.shot_indices(k, 0)
        return self.play_many(ks, rows_per_tile, out_dtype=out_dtype,
                              dac_scale=dac_scale)[0]

    def play_many(self, ks, rows_per_tile: int | None = None,
                  sparse: bool = False, Rs: int = 32, out_dtype=None,
                  dac_scale=32767.0) -> torch.Tensor:
        """Synthesize the shot sequence ``ks`` (a list, an array or a 1-D
        tensor) -> (len(ks), C, N) in ONE launch: the dense kernel's shot
        entry (the worklist kernel's with ``sparse``), which reads each
        shot's index on the device and clamps it there.  A CUDA ``ks`` is
        never read on the host; with ``sparse`` the first play at an
        ``Rs`` builds the table's worklists on the host.  The host's work
        before the launch -- checks, the DAC scale, the indices, the
        output -- is the span ``wf.play.prepare``."""
        from .. import kernels
        C = self.shape[0]
        if sparse:
            if out_dtype is not None:
                raise NotImplementedError(
                    "play_many(sparse=True) is f32-only (play_sparse has "
                    "no narrowed store); use sparse=False for out_dtype")
            with annotate('wf.play.prepare'):
                self._check_sparse()
                ks = self.shot_indices(ks, 1)
                out = torch.zeros((ks.shape[0], C, self.n_samples),
                                  dtype=torch.float32, device=self.device)
                work = self._stacked_work(Rs)
            return kernels.synth_sparse.shots(self, work, ks, out, None)
        with annotate('wf.play.prepare'):
            self._check_rows(rows_per_tile)
            dt, scale = validate_out_mode(out_dtype, C, dac_scale,
                                          self.device, pair=self.pair)
            ks = self.shot_indices(ks, 1)
            out = torch.empty((ks.shape[0], C, self.n_samples), dtype=dt,
                              device=self.device)
        return kernels.synth_dense.shots(self, ks, out, scale)

    # -- the worklist kernel (K7) ----------------------------------------

    def _sparse_table(self, Rs: int):
        """Per-schedule live-subtile worklists, padded to one length and
        stacked -> ({field: (K, Kw) int32 tensor}, n_tiles, [n_live per
        schedule]).  Padding items point at the scratch subtile
        (``work_o == n_tiles``) with an empty segment range."""
        plans = [build_sparse_plan(v, Rs=Rs) for v in self._plan_views]
        n_tiles = plans[0].n_tiles
        Kw = next_pow2(max(p.work_c.shape[0] for p in plans))
        fields = {}
        for name, fill in (('work_c', 0), ('work_b', 0),
                           ('work_t', n_tiles), ('work_o', n_tiles),
                           ('work_s0', 0), ('work_s1', 0)):
            a = np.stack([np.pad(getattr(p, name),
                                 (0, Kw - p.work_c.shape[0]),
                                 constant_values=fill) for p in plans])
            fields[name] = torch.from_numpy(a.astype(np.int32)).to(
                self.device)
        return fields, n_tiles, [p.n_live for p in plans]

    def _check_sparse(self):
        if self.pair:
            raise UnsupportedFactor("sparse sequence play is real-only")
        if self.shape[1] != 1:
            raise UnsupportedFactor("sparse sequence play is single-bucket")

    def _sparse_tables(self, Rs: int):
        """:meth:`_sparse_table` at ``Rs``, built once."""
        if Rs not in self._sparse_work:
            self._sparse_work[Rs] = self._sparse_table(Rs)
        return self._sparse_work[Rs]

    def _stacked_work(self, Rs: int) -> SimpleNamespace:
        """The (K, Kw) worklists of every schedule, as the worklist
        kernel's shot entry takes them."""
        fields, n_tiles, _ = self._sparse_tables(Rs)
        return SimpleNamespace(Rs=Rs, n_tiles=n_tiles, **fields)

    def _sparse_args(self, k: int, Rs: int):
        """(schedule k, its SparseWork): a one-shot launch's inputs."""
        fields, n_tiles, n_live = self._sparse_tables(Rs)
        return self._schedule(k), SparseWork(
            Rs=Rs, n_tiles=n_tiles, n_live=n_live[k],
            **{n: f[k] for n, f in fields.items()})

    def play_sparse(self, k, Rs: int = 32) -> torch.Tensor:
        """Schedule ``k`` (an int or a 0-d tensor) -> (C, N) f32 through
        the worklist kernel, over a zeroed output: one shot of
        ``play_many(sparse=True)``.  Real single-bucket tables only."""
        return self.play_many(self.shot_indices(k, 0), sparse=True, Rs=Rs)[0]

    # -- shot-packed playback: one panel-kernel launch (K2) ---------------

    def _packed_tensors(self) -> DeviceSchedule:
        """The table concatenated along the segment axis, as one schedule
        of shape (C, 1, K*Sb, T, F): schedule ``k`` holds segment rows
        [k*Sb, (k+1)*Sb).  Made contiguous once and cached."""
        if self._packed_tensors_cache is None:
            C, NB, Sb, T, F = self.shape
            K = self.n_schedules

            def seg_axis(t):    # (K, C, 1, Sb, ...) -> (C, 1, K*Sb, ...)
                return t.movedim(0, 2).reshape(C, 1, K * Sb, *t.shape[4:])

            names = ('seg_lo', 'seg_hi', 'nterm', 'nfac', 'amp', 'op',
                     'power', 'shift_hi', 'q32', 'args')
            self._packed_tensors_cache = DeviceSchedule.from_tensors(
                (C, 1, K * Sb, T, F), self.n_samples, self.bucket_samples,
                ext=self.ext, clip=self.clip[0],
                **{n: seg_axis(getattr(self, n)).contiguous()
                   for n in names})
        return self._packed_tensors_cache

    def _packed_plan(self, n_shots: int, Rs: int):
        """The worklist of an n_shots packed launch (cached), as the JAX
        ``Sequencer._packed_plan`` builds it.

        Items enumerate (channel, shot, union-live subtile): a subtile is
        in the union when ANY schedule of the table has segments over it,
        so the items do not depend on which schedule each shot plays; only
        the per-item segment ranges do, gathered on the device from the
        small (K, n_union) tables ``rng0_u``/``rng1_u``."""
        key = (n_shots, Rs)
        if key in self._packed_plans:
            return self._packed_plans[key]
        C, NB, Sb, T, F = self.shape
        tile = Rs * 128
        tps = -(-(-(-self.n_samples // 128)) // Rs)      # subtiles per shot
        bases = np.arange(tps, dtype=np.int64) * tile
        r0 = np.zeros((self.n_schedules, C, tps), np.int32)
        r1 = np.zeros((self.n_schedules, C, tps), np.int32)
        for k, v in enumerate(self._plan_views):
            for c in range(C):
                lo = np.asarray(v.seg_lo[c, 0], np.int64)
                hi = np.asarray(v.seg_hi[c, 0], np.int64)
                hmax = np.maximum.accumulate(hi)
                s0 = np.searchsorted(hmax, bases, side='right')
                s1 = np.maximum(
                    np.searchsorted(lo, bases + tile, side='left'), s0)
                r0[k, c] = k * Sb + s0
                r1[k, c] = k * Sb + s1
        live = (r1 > r0).any(axis=0)              # (C, tps) union
        cs, ts = np.nonzero(live)
        n_union = len(cs)
        s_idx = np.repeat(np.arange(n_shots), n_union)
        c_arr = np.tile(cs, n_shots)
        t_arr = np.tile(ts, n_shots)
        wo = s_idx * tps + t_arr                  # shot-major output rows
        total_rows = max(n_shots * tps * Rs, Rs)
        P = max(Rs, min(PANEL_ROWS, total_rows))
        P = (P // Rs) * Rs
        NP = -(-total_rows // P)
        P = max(Rs, -(-(-(-total_rows // NP)) // Rs) * Rs)   # exact fit
        slot = c_arr * NP + (wo * Rs) // P        # NB == 1
        order = np.argsort(slot, kind='stable')
        n_items = n_shots * n_union
        pad = next_pow2(n_items) - n_items
        start = np.zeros(C * NP + 1, np.int64)
        np.add.at(start, slot + 1, 1)
        start = np.cumsum(start)

        def put(a, dtype=np.int32):
            return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(
                self.device)

        def col(a):
            return put(np.concatenate([np.asarray(a)[order],
                                       np.zeros(pad, np.int64)]))

        plan = SimpleNamespace(
            start=put(start), wt=col(t_arr), wo=col(wo),
            shot_of=put(s_idx[order], np.int64),
            u_of=put((np.arange(n_items) % n_union)[order], np.int64),
            rng0_u=put(r0[:, cs, ts]), rng1_u=put(r1[:, cs, ts]),
            pad=pad, n_items=n_items, n_union=n_union,
            P=P, NP=NP, tps=tps, Rs=Rs, total_rows=total_rows)
        self._packed_plans[key] = plan
        return plan

    def _packed_work(self, ks: torch.Tensor, Rs: int):
        """(plan, PanelWork) of a packed launch for the device shot vector
        ``ks``: each item's segment range is schedule ``clamp(ks[shot])``'s
        for the item's subtile, gathered on the device."""
        plan = self._packed_plan(ks.shape[0], Rs)
        sched = ks.clamp(0, self.n_schedules - 1)[plan.shot_of]
        zpad = torch.zeros(plan.pad, dtype=torch.int32, device=self.device)
        return plan, PanelWork(
            Rs=Rs, P=plan.P, n_panels=plan.NP, n_live=plan.n_items,
            start=plan.start, work_t=plan.wt, work_o=plan.wo,
            work_s0=torch.cat([plan.rng0_u[sched, plan.u_of], zpad]),
            work_s1=torch.cat([plan.rng1_u[sched, plan.u_of], zpad]))

    def play_packed(self, ks, Rs: int = 8, out_dtype=None,
                    dac_scale=32767.0) -> torch.Tensor:
        """Synthesize the shot sequence ``ks`` in ONE panel-kernel launch
        -> (len(ks), C, N), f32, bf16, f16 or int16 DAC codes.

        Real single-bucket tables with uniform clip rails only.  ``ks``
        stays on the device: each item's segment range is gathered there
        from ``clamp(ks, 0, K-1)``.  The result is a (shot, channel,
        sample) view of the launch's (C, n_shots * rows * 128) output,
        whose rows of a shot past its ``n_samples`` are trimmed."""
        from .. import kernels
        if self.pair:
            raise UnsupportedFactor("packed sequence play is real-only")
        C, NB, Sb, T, F = self.shape
        if NB != 1:
            raise UnsupportedFactor("packed sequence play is single-bucket")
        if not self._clip_uniform:
            raise UnsupportedFactor(
                "packed sequence play needs uniform clip rails")
        dt, scale = validate_out_mode(out_dtype, C, dac_scale, self.device)
        ks = self.shot_indices(ks).long()
        n_shots = ks.shape[0]
        plan, work = self._packed_work(ks, Rs)
        out = torch.empty((C, plan.total_rows * 128), dtype=dt,
                          device=self.device)
        kernels.synth_panel(self._packed_tensors(), work, out, scale)
        rows_shot = plan.tps * Rs
        out = out[:, :n_shots * rows_shot * 128]
        out = out.unflatten(1, (n_shots, rows_shot * 128))
        return out[..., :self.n_samples].permute(1, 0, 2)

    def play_replay(self, ks, out_dtype=None, dac_scale=32767.0,
                    max_palette_bytes: int = 2 ** 30) -> torch.Tensor:
        """Replay shots from a device palette -> (len(ks), C, N).

        The K schedules synthesize ONCE per (output type, ``dac_scale``)
        into a (K, C, N) palette -- the AWG's waveform-memory upload -- and
        each shot is a row gather (``index_select`` on the clamped
        indices, on the device).  Raises UnsupportedFactor when the palette
        (K * C * N * itemsize bytes) exceeds ``max_palette_bytes``."""
        C = self.shape[0]
        dt, _ = validate_out_mode(out_dtype, C, dac_scale, self.device,
                                  pair=self.pair)
        need = (self.n_schedules * C * self.n_samples
                * torch.empty((), dtype=dt).element_size())
        if need > max_palette_bytes:
            raise UnsupportedFactor(
                f"palette ({need >> 20} MiB) exceeds max_palette_bytes "
                "-- use play_packed/play_many for this table")
        key = (str(dt), np.asarray(dac_scale, np.float32).tobytes())
        if key not in self._palettes:
            self._palettes[key] = self.play_many(
                range(self.n_schedules), out_dtype=out_dtype,
                dac_scale=dac_scale)
        return self._palettes[key].index_select(0, self.shot_indices(ks))
