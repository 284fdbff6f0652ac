"""Live-subtile plans, the panel path and the worklist path.

The plans are the JAX package's, built the same way so that they compare
array-equal with it: :func:`build_sparse_plan` enumerates the live
``Rs x 128`` subtiles of each (channel, bucket) on the host, and
:func:`build_panel_plan` regroups that worklist by (channel, panel,
bucket).  :func:`synthesize_panels` runs the panel kernel
(``csrc/synth_panel.cu`` on a CUDA device, its plain version
:func:`.reference.panel_walk` on the CPU): zeros everywhere, and only the
live subtiles evaluated.  :func:`synthesize_sparse` runs the worklist
kernel (``csrc/synth_sparse.cu``, plain version
:func:`.reference.sparse_walk`): one thread block per live subtile over a
zeroed output.  Both take pair-mode schedules (complex64 output).

:func:`synthesize_panels_sharded` and :func:`synthesize_sparse_sharded`
run the same kernels over a ('channel', 'time') mesh
(:mod:`..parallel.mesh`), one launch per shard, each over its own channel
block's descriptors and its own slice of the worklist
(:func:`shard_panel_work`, :func:`shard_sparse_work`).

The TPU kernel kept its worklist in scalar memory under a budget; a GPU
worklist lives in global memory, so that budget is gone.  The rule that
narrowed stores (int16, bf16, f16) need one bucket stays: with several
buckets the kernel accumulates straddling subtiles in the output itself.
"""

from __future__ import annotations

from dataclasses import dataclass
from types import SimpleNamespace

import numpy as np
import torch

from .lowering import LoweredSchedule, UnsupportedFactor
from .synth import DeviceSchedule, normalize_out_dtype, validate_out_mode

__all__ = ['SparsePlan', 'SparseWork', 'build_sparse_plan', 'PanelPlan',
           'PanelWork', 'build_panel_plan', 'panels_eligible',
           'synthesize_panels', 'synthesize_sparse', 'shard_sparse_work',
           'shard_panel_work', 'synthesize_panels_sharded',
           'synthesize_sparse_sharded',
           'PANEL_OCCUPANCY_THRESHOLD', 'SPARSE_OCCUPANCY_THRESHOLD']

DEFAULT_SUBTILE_ROWS = 32

# Route engine='auto' to the panel kernel below this padded live-subtile
# fraction: the JAX package's value, measured on TPU v5e, which the JAX
# rule (ops.routes.JAX_RULE) of CPU devices keeps.  On the H100 no rung of
# the route ladder runs fastest on the panel kernel (route_ladder's record;
# NVIDIA H100 80GB HBM3, 700.00 W), so the card's rule (ops.routes.
# CARD_RULE) takes it nowhere.
PANEL_OCCUPANCY_THRESHOLD = 0.35

# Below this padded live-subtile fraction, a schedule that the panel
# kernel cannot take (a narrowed store with several buckets) goes to the
# worklist kernel: the JAX package's value (TPU v5e), the JAX rule's.  On
# the H100 the worklist path leads the dense kernel below 0.015 of the
# live-subtile fraction in f32 and pair mode and below 0.3 with a
# two-byte store (route_ladder's record), CARD_RULE's bounds.
SPARSE_OCCUPANCY_THRESHOLD = 0.2

# Panel height in rows before the exact-fit shrink (the JAX package's value,
# so that plans compare array-equal).
PANEL_ROWS = 4096


def next_pow2(n: int) -> int:
    """Smallest power of two >= max(n, 1)."""
    return 1 << (max(n, 1) - 1).bit_length()


@dataclass
class SparsePlan:
    """Host-enumerated live-subtile worklist (see build_sparse_plan)."""
    Rs: int                 # subtile height in output rows
    n_tiles: int            # OUTPUT subtiles (window; excl. scratch tile)
    work_c: np.ndarray      # i32[K] channel
    work_b: np.ndarray      # i32[K] descriptor bucket
    work_t: np.ndarray      # i32[K] ABSOLUTE subtile index (sample base)
    work_o: np.ndarray      # i32[K] OUTPUT subtile index (window-relative)
    work_s0: np.ndarray     # i32[K] first segment
    work_s1: np.ndarray     # i32[K] one past the last segment
    n_live: int             # un-padded worklist length
    window_samples: int     # samples this plan's output covers
    n_channels: int         # channels covered by the worklist
    bucket_samples: int = 0  # descriptor bucket size the plan was built for

    @property
    def occupied_fraction(self):
        """Live subtiles / total subtiles across all channels."""
        return self.n_live / max(self.n_tiles * self.n_channels, 1)


def build_sparse_plan(low: LoweredSchedule,
                      Rs: int = DEFAULT_SUBTILE_ROWS) -> SparsePlan:
    """Enumerate live subtiles of a lowered schedule.

    For every (channel, bucket) the segment list is lo-sorted; per subtile
    the overlapping segment range [s0, s1) comes from two searchsorted
    calls (running max of hi, and lo), and empty subtiles are dropped.
    """
    C, NB, S, T, F = low.shape
    tile = Rs * 128
    if NB > 1 and low.bucket_samples % tile:
        raise UnsupportedFactor(
            f"bucket_samples {low.bucket_samples} must be a multiple of "
            f"the sparse subtile ({tile})")
    n_rows = -(-low.n_samples // 128)
    n_tiles = -(-n_rows // Rs)

    cs, bs, ts, s0s, s1s = [], [], [], [], []
    for c in range(C):
        for b in range(NB):
            lo = low.seg_lo[c, b]
            hi = low.seg_hi[c, b]
            nt = low.nterm[c, b]
            if not nt.any():
                continue
            hmax = np.maximum.accumulate(hi)
            t0 = (b * low.bucket_samples) // tile if NB > 1 else 0
            t1 = min(-(-((b + 1) * low.bucket_samples) // tile)
                     if NB > 1 else n_tiles, n_tiles)
            if t1 <= t0:
                continue
            t_idx = np.arange(t0, t1, dtype=np.int64)
            bases = t_idx * tile
            s0 = np.searchsorted(hmax, bases, side='right')
            s1 = np.searchsorted(lo, bases + tile, side='left')
            live = s1 > s0
            if not live.any():
                continue
            n = int(live.sum())
            cs.append(np.full(n, c))
            bs.append(np.full(n, b))
            ts.append(t_idx[live])
            s0s.append(s0[live])
            s1s.append(s1[live])

    if cs:
        wc = np.concatenate(cs)
        wb = np.concatenate(bs)
        wt = np.concatenate(ts)
        w0 = np.concatenate(s0s)
        w1 = np.concatenate(s1s)
    else:
        wc = wb = wt = w0 = w1 = np.zeros(0, np.int64)
    n_live = len(wc)

    # pad to a power of two (the JAX package's kernel-cache rule, kept so
    # the plans compare array-equal); padding targets the scratch tile
    K = next_pow2(n_live)
    pad = K - n_live
    wc = np.concatenate([wc, np.zeros(pad, np.int64)])
    wb = np.concatenate([wb, np.zeros(pad, np.int64)])
    wo = wt = np.concatenate([wt, np.full(pad, n_tiles)])
    w0 = np.concatenate([w0, np.zeros(pad, np.int64)])
    w1 = np.concatenate([w1, np.zeros(pad, np.int64)])
    return SparsePlan(Rs=Rs, n_tiles=n_tiles,
                      work_c=wc.astype(np.int32),
                      work_b=wb.astype(np.int32),
                      work_t=wt.astype(np.int32),
                      work_o=wo.astype(np.int32),
                      work_s0=w0.astype(np.int32),
                      work_s1=w1.astype(np.int32),
                      n_live=n_live,
                      window_samples=low.n_samples,
                      n_channels=C,
                      bucket_samples=low.bucket_samples)


@dataclass
class PanelPlan:
    """Per-(channel, panel, bucket) segmented worklist (build_panel_plan)."""
    Rs: int                  # subtile height in output rows
    P: int                   # panel height in output rows (multiple of Rs)
    n_panels: int            # panels per channel (of the window)
    start: np.ndarray        # i32[C*NP*NB + 1] worklist slice offsets
    work_t: np.ndarray       # i32[K] ABSOLUTE subtile index (sample base)
    work_o: np.ndarray       # i32[K] OUTPUT subtile index (window-relative)
    work_s0: np.ndarray      # i32[K] first segment
    work_s1: np.ndarray      # i32[K] one past the last segment
    n_live: int
    n_channels: int
    n_buckets: int
    window_samples: int
    bucket_samples: int = 0

    @property
    def occupied_fraction(self):
        n_tiles = self.n_panels * (self.P // self.Rs)
        return self.n_live / max(n_tiles * self.n_channels, 1)


def build_panel_plan(low: LoweredSchedule, Rs: int = DEFAULT_SUBTILE_ROWS,
                     base: SparsePlan | None = None) -> PanelPlan:
    """Re-segment the live-subtile worklist by (channel, panel, bucket).

    ``base`` reuses an already-built worklist.  Panels are the smallest
    Rs-multiple height that covers the window in ``NP`` panels."""
    if base is None:
        base = build_sparse_plan(low, Rs=Rs)
    elif base.Rs != Rs:
        raise ValueError(f"base plan has Rs={base.Rs}, expected {Rs}")
    C, NB, S, T, F = low.shape
    n_rows_win = base.n_tiles * Rs
    P = max(Rs, min(PANEL_ROWS, n_rows_win))
    P = (P // Rs) * Rs
    NP = -(-n_rows_win // P)
    P = max(Rs, -(-(-(-n_rows_win // NP)) // Rs) * Rs)
    live = slice(0, base.n_live)
    wc = base.work_c[live].astype(np.int64)
    wb = base.work_b[live].astype(np.int64)
    wt = base.work_t[live].astype(np.int64)
    wo = base.work_o[live].astype(np.int64)
    ws0 = base.work_s0[live]
    ws1 = base.work_s1[live]
    pidx = (wo * Rs) // P
    slot = (wc * NP + pidx) * NB + wb
    order = np.argsort(slot, kind='stable')
    n_slots = C * NP * NB
    start = np.zeros(n_slots + 1, np.int64)
    np.add.at(start, slot + 1, 1)
    start = np.cumsum(start)
    K = next_pow2(base.n_live)
    pad = K - base.n_live

    def col(a, fill=0):
        return np.concatenate(
            [np.asarray(a)[order],
             np.full(pad, fill, np.int64)]).astype(np.int32)

    return PanelPlan(
        Rs=Rs, P=P, n_panels=NP,
        start=start.astype(np.int32),
        work_t=col(wt), work_o=col(wo), work_s0=col(ws0),
        work_s1=col(ws1),
        n_live=base.n_live, n_channels=C, n_buckets=NB,
        window_samples=base.window_samples,
        bucket_samples=base.bucket_samples)


def panels_eligible(plan: PanelPlan, out_dtype) -> bool:
    """Narrowed stores (int16, bf16, f16) need a single bucket: with
    several, the kernel adds bucket-straddling subtiles into the output
    itself.  (The JAX rule also refuses worklists over its SMEM budget;
    the card keeps worklists in global memory.)"""
    return (plan.n_buckets == 1
            or normalize_out_dtype(out_dtype) == torch.float32)


@dataclass
class PanelWork:
    """A PanelPlan's worklist as int32 tensors on the schedule's device."""
    Rs: int
    P: int
    n_panels: int
    n_live: int
    start: torch.Tensor
    work_t: torch.Tensor
    work_o: torch.Tensor
    work_s0: torch.Tensor
    work_s1: torch.Tensor

    @classmethod
    def upload(cls, plan: PanelPlan, device) -> 'PanelWork':
        def put(a):
            return torch.from_numpy(
                np.ascontiguousarray(a, dtype=np.int32)).to(device)
        return cls(Rs=plan.Rs, P=plan.P, n_panels=plan.n_panels,
                   n_live=plan.n_live, start=put(plan.start),
                   work_t=put(plan.work_t), work_o=put(plan.work_o),
                   work_s0=put(plan.work_s0), work_s1=put(plan.work_s1))


def _validate_panel_plan(plan: PanelPlan, dev: DeviceSchedule) -> None:
    """A plan from another lowering would index the wrong descriptors."""
    C, NB, S, T, F = dev.shape
    if plan.n_channels != C or plan.n_buckets != NB:
        raise ValueError(
            f"panel plan covers {plan.n_channels}x{plan.n_buckets} "
            f"channel-buckets, schedule has {C}x{NB} -- rebuild the plan "
            "from this schedule's lowering")
    if plan.bucket_samples and plan.bucket_samples != dev.bucket_samples:
        raise ValueError(
            f"panel plan bucket_samples {plan.bucket_samples} != "
            f"schedule's {dev.bucket_samples}")
    if plan.window_samples > dev.n_samples:
        raise ValueError(
            f"panel plan window ({plan.window_samples} samples) exceeds "
            f"the schedule ({dev.n_samples})")
    if plan.n_live:
        live = slice(0, plan.n_live)
        n_rows = -(-dev.n_samples // 128)
        n_tiles_abs = -(-n_rows // plan.Rs)
        if (int(plan.work_s1[live].max()) > S
                or int(plan.work_t[live].max()) >= n_tiles_abs):
            raise ValueError(
                "panel plan indexes outside this schedule's descriptor "
                f"blocks (shape {dev.shape}, {n_tiles_abs} subtiles) -- "
                "it was built from a different lowering")


def synthesize_panels(dev: DeviceSchedule,
                      low: LoweredSchedule | None = None,
                      plan: PanelPlan | None = None,
                      Rs: int = DEFAULT_SUBTILE_ROWS,
                      out_dtype=None,
                      dac_scale=32767.0) -> torch.Tensor:
    """Run the panel kernel on ``dev`` -> (C, window_samples) on
    ``dev.device`` (f32, bf16, f16, int16 DAC codes, or complex64 in
    pair mode)."""
    from .. import kernels
    C = dev.shape[0]
    dt, scale = validate_out_mode(out_dtype, C, dac_scale, dev.device,
                                  pair=dev.amp_im is not None)
    if plan is None:
        if low is None:
            raise ValueError("synthesize_panels needs `low` or `plan`")
        plan = build_panel_plan(low, Rs=Rs)
    _validate_panel_plan(plan, dev)
    if not panels_eligible(plan, out_dtype):
        raise UnsupportedFactor(
            "int16, bf16 and f16 panel output need a single-bucket "
            "schedule -- use the dense path")
    out = torch.empty((C, plan.window_samples), dtype=dt, device=dev.device)
    return kernels.synth_panel(dev, PanelWork.upload(plan, dev.device), out,
                               scale)


@dataclass
class SparseWork:
    """A SparsePlan's worklist as int32 tensors on the schedule's device.
    Padding items have ``work_o == n_tiles`` and write nothing."""
    Rs: int
    n_tiles: int
    n_live: int
    work_c: torch.Tensor
    work_b: torch.Tensor
    work_t: torch.Tensor
    work_o: torch.Tensor
    work_s0: torch.Tensor
    work_s1: torch.Tensor

    @classmethod
    def upload(cls, plan: SparsePlan, device) -> 'SparseWork':
        def put(a):
            return torch.from_numpy(
                np.ascontiguousarray(a, dtype=np.int32)).to(device)
        return cls(Rs=plan.Rs, n_tiles=plan.n_tiles, n_live=plan.n_live,
                   work_c=put(plan.work_c), work_b=put(plan.work_b),
                   work_t=put(plan.work_t), work_o=put(plan.work_o),
                   work_s0=put(plan.work_s0), work_s1=put(plan.work_s1))


def _validate_sparse_plan(plan: SparsePlan, dev: DeviceSchedule) -> None:
    """A plan built from another lowering would index the wrong
    descriptor blocks; check every cross-reference before launching."""
    C, NB, S, T, F = dev.shape
    if plan.n_channels != C:
        raise ValueError(
            f"sparse plan covers {plan.n_channels} channels, schedule has "
            f"{C} -- rebuild the plan from this schedule's lowering")
    if plan.bucket_samples and plan.bucket_samples != dev.bucket_samples:
        raise ValueError(
            f"sparse plan bucket_samples {plan.bucket_samples} != "
            f"schedule's {dev.bucket_samples}")
    if plan.window_samples > dev.n_samples:
        raise ValueError(
            f"sparse plan window ({plan.window_samples} samples) exceeds "
            f"the schedule ({dev.n_samples})")
    if plan.n_live:
        live = slice(0, plan.n_live)
        n_rows = -(-dev.n_samples // 128)
        n_tiles_abs = -(-n_rows // plan.Rs)
        if (int(plan.work_c[live].max()) >= C
                or int(plan.work_b[live].max()) >= NB
                or int(plan.work_s1[live].max()) > S
                or int(plan.work_t[live].max()) >= n_tiles_abs):
            raise ValueError(
                "sparse plan indexes outside this schedule's descriptor "
                f"blocks (shape {dev.shape}, {n_tiles_abs} subtiles) -- "
                "it was built from a different lowering")


def synthesize_sparse(dev: DeviceSchedule,
                      low: LoweredSchedule | None = None,
                      plan: SparsePlan | None = None,
                      Rs: int = DEFAULT_SUBTILE_ROWS,
                      out_dtype=None,
                      dac_scale=32767.0) -> torch.Tensor:
    """Run the worklist kernel on ``dev`` -> (C, window_samples) on
    ``dev.device`` (f32, bf16, f16, int16 DAC codes, or complex64 in
    pair mode).

    The output starts zeroed (``torch.zeros``, the background that the
    TPU kernel, too, takes from outside) and the kernel stores each live
    subtile once: ``build_sparse_plan`` requires buckets that are whole
    subtiles, so no subtile has two items and int16 needs no single-bucket
    rule here."""
    from .. import kernels
    C = dev.shape[0]
    dt, scale = validate_out_mode(out_dtype, C, dac_scale, dev.device,
                                  pair=dev.amp_im is not None)
    if plan is None:
        if low is None:
            raise ValueError("synthesize_sparse needs `low` or `plan`")
        plan = build_sparse_plan(low, Rs=Rs)
    _validate_sparse_plan(plan, dev)
    out = torch.zeros((C, plan.window_samples), dtype=dt, device=dev.device)
    return kernels.synth_sparse(dev, SparseWork.upload(plan, dev.device),
                                out, scale)


def shard_sparse_work(plan: SparsePlan, nc: int, nt: int, cs: int,
                      tps: int, nb_local: int = 1):
    """Partition a global worklist by (channel shard, time shard).

    Returns the (nc, nt, K) local worklist arrays ``(work_c, work_b,
    work_t, work_o, work_s0, work_s1)`` -- channel and bucket localized,
    ``work_t`` the ABSOLUTE subtile (it sets the samples' time), ``work_o``
    the shard's output subtile, padding entries aimed at the scratch
    subtile ``tps`` -- plus the per-shard live counts and K, the padded
    length (the JAX package's, array for array)."""
    live = slice(0, plan.n_live)
    wc = plan.work_c[live].astype(np.int64)
    wb = plan.work_b[live].astype(np.int64)
    wt = plan.work_t[live].astype(np.int64)
    ws0 = plan.work_s0[live]
    ws1 = plan.work_s1[live]
    ci = wc // cs
    ti = wt // tps
    counts = np.zeros((nc, nt), np.int64)
    np.add.at(counts, (ci, ti), 1)
    K = next_pow2(int(counts.max()))
    lwc = np.zeros((nc, nt, K), np.int32)
    lwb = np.zeros((nc, nt, K), np.int32)
    lwt = np.zeros((nc, nt, K), np.int32)
    lwo = np.full((nc, nt, K), tps, np.int32)
    lws0 = np.zeros((nc, nt, K), np.int32)
    lws1 = np.zeros((nc, nt, K), np.int32)
    # stable-sort by shard, rank within the shard by position, one
    # fancy-indexed write per field
    shard = ci * nt + ti
    order = np.argsort(shard, kind='stable')
    offs = np.zeros(nc * nt + 1, np.int64)
    np.add.at(offs, shard + 1, 1)
    offs = np.cumsum(offs)
    a, b = ci[order], ti[order]
    p = np.arange(len(order), dtype=np.int64) - offs[shard[order]]
    lwc[a, b, p] = (wc[order] % cs).astype(np.int32)
    lwb[a, b, p] = (wb[order] % nb_local).astype(np.int32)   # local bucket
    lwt[a, b, p] = wt[order].astype(np.int32)                # absolute
    lwo[a, b, p] = (wt[order] - b * tps).astype(np.int32)    # local output
    lws0[a, b, p] = ws0[order].astype(np.int32)
    lws1[a, b, p] = ws1[order].astype(np.int32)
    return (lwc, lwb, lwt, lwo, lws0, lws1), counts, K


def shard_panel_work(plan: SparsePlan, nc: int, nt: int, cs: int,
                     tps: int, nb_local: int, Rs: int,
                     panel_rows: int = PANEL_ROWS):
    """Partition a global worklist into per-shard panel segmentations:
    per (channel shard, time shard), the shard's live subtiles grouped by
    (local channel, panel, local bucket) as :func:`build_panel_plan`
    groups them.  Returns ``(starts, wt, wo, ws0, ws1), counts, K, P, NP``
    (the JAX package's, array for array)."""
    (lwc, lwb, lwt, lwo, lws0, lws1), counts, K = shard_sparse_work(
        plan, nc, nt, cs, tps, nb_local)
    n_rows_loc = tps * Rs
    P = max(Rs, min(panel_rows, n_rows_loc))
    P = (P // Rs) * Rs
    NP = -(-n_rows_loc // P)
    P = max(Rs, -(-(-(-n_rows_loc // NP)) // Rs) * Rs)
    n_slots = cs * NP * nb_local
    starts = np.zeros((nc, nt, n_slots + 1), np.int64)
    for a in range(nc):
        for b in range(nt):
            n = int(counts[a, b])
            if not n:
                continue
            slot = ((lwc[a, b, :n].astype(np.int64) * NP
                     + (lwo[a, b, :n].astype(np.int64) * Rs) // P)
                    * nb_local + lwb[a, b, :n])
            order = np.argsort(slot, kind='stable')
            for col in (lwt, lwo, lws0, lws1, lwc, lwb):
                col[a, b, :n] = col[a, b, :n][order]
            np.add.at(starts[a, b], slot[order] + 1, 1)
            starts[a, b] = np.cumsum(starts[a, b])
    return ((starts.astype(np.int32), lwt, lwo, lws0, lws1), counts, K, P,
            NP)


def _run_sharded_common(low: LoweredSchedule, mesh, Rs, plan, out_dtype,
                        dac_scale, make_worklist, make_launch):
    """The shared scaffolding of the two sharded kernels -> the
    :class:`..parallel.mesh.ShardRun` of their launches, not yet run.

    Mesh and bucket layout, the shards' descriptors, the stale-plan check,
    the output mode and each shard's output block live here once; the two
    entry points differ in their worklist function ``make_worklist(plan,
    nc, nt, cs, tps, nb_local) -> (work arrays, counts, static)`` (which
    may raise UnsupportedFactor before anything launches) and
    ``make_launch(i, j, dev, work, counts, static, out, scale) -> launch``.
    A shard's block is its channel block by its slice of ``tps`` subtiles,
    cut at the schedule's end.  Every process partitions the whole
    worklist alike and uploads and launches its own shards' parts only."""
    from ..parallel.mesh import ShardRun, _shard_scales, shard_schedule, \
        time_windows
    C, NB, S, T, F = low.shape
    dt, _ = validate_out_mode(out_dtype, C, dac_scale, 'cpu',
                              pair=low.amp_im is not None)
    nc, nt = mesh.devices.shape
    c_pad = -(-C // nc) * nc
    cs = c_pad // nc
    tile = Rs * 128
    if NB > 1:
        # whole buckets per time shard (the dense mesh layout): subtiles
        # map to shards by work_t // tps, tps = nb_local * subtiles a bucket
        if low.bucket_samples % tile:
            raise UnsupportedFactor(
                f"bucket_samples {low.bucket_samples} must be a multiple "
                f"of the sparse subtile ({tile})")
        nb_pad = -(-NB // nt) * nt
        nb_local = nb_pad // nt
        tps = nb_local * (low.bucket_samples // tile)
        grid, _ = shard_schedule(low, mesh, nb_pad=nb_pad)
    else:
        n_tiles = -(-(-(-low.n_samples // 128)) // Rs)
        tps = -(-n_tiles // nt)                # subtiles per time shard
        nb_local = 1
        grid, _ = shard_schedule(low, mesh)
    if plan is None:
        plan = build_sparse_plan(low, Rs=Rs)
    elif plan.Rs != Rs:
        raise ValueError(f"prebuilt plan has Rs={plan.Rs}, expected {Rs}")
    else:
        # a plan from another lowering synthesizes wrong samples
        _validate_sparse_plan(plan, SimpleNamespace(
            shape=low.shape, n_samples=low.n_samples,
            bucket_samples=low.bucket_samples))
    work, counts, static = make_worklist(plan, nc, nt, cs, tps, nb_local)
    scales = _shard_scales(dt, dac_scale, C, c_pad, mesh)
    windows = time_windows(low.n_samples, tps * tile, nt)
    run = ShardRun(mesh.devices.shape, C, cs, dt,
                   [b - a for a, b in windows], mesh.plane_owners)
    for i in range(nc):
        for j, (a, b) in enumerate(windows):
            if not mesh.is_local(i, j):
                continue               # another process's shard
            dev = grid[i][j]
            out = torch.empty((cs, b - a), dtype=dt, device=dev.device)
            scale = None if scales is None else scales[i][j]
            run.add(i, j, out, None if b == a else make_launch(
                i, j, dev, work, counts, static, out, scale))
    return run


def _put(a, device):
    return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(device)


def panel_shards(low: LoweredSchedule, mesh, Rs=DEFAULT_SUBTILE_ROWS,
                 plan: SparsePlan | None = None, out_dtype=None,
                 dac_scale=32767.0):
    """The launches of :func:`synthesize_panels_sharded`, not yet run."""
    from .. import kernels

    def make_worklist(plan, nc, nt, cs, tps, nb_local):
        work, counts, K, P, NP = shard_panel_work(plan, nc, nt, cs, tps,
                                                  nb_local, Rs)
        if nb_local > 1 and normalize_out_dtype(out_dtype) != torch.float32:
            raise UnsupportedFactor(
                "narrowed multi-bucket stores are outside the panel "
                "kernel's budgets -- use synthesize_sparse_sharded")
        return work, counts, dict(P=P, NP=NP)

    def make_launch(i, j, dev, work, counts, st, out, scale):
        start, wt, wo, ws0, ws1 = (a[i, j] for a in work)
        pw = PanelWork(Rs=Rs, P=st['P'], n_panels=st['NP'],
                       n_live=int(counts[i, j]),
                       start=_put(start, dev.device),
                       work_t=_put(wt, dev.device),
                       work_o=_put(wo, dev.device),
                       work_s0=_put(ws0, dev.device),
                       work_s1=_put(ws1, dev.device))
        return lambda: kernels.synth_panel(dev, pw, out, scale)

    return _run_sharded_common(low, mesh, Rs, plan, out_dtype, dac_scale,
                               make_worklist, make_launch)


def sparse_shards(low: LoweredSchedule, mesh, Rs=DEFAULT_SUBTILE_ROWS,
                  plan: SparsePlan | None = None, out_dtype=None,
                  dac_scale=32767.0):
    """The launches of :func:`synthesize_sparse_sharded`, not yet run: each
    zeroes its block, then launches K7 on it."""
    from .. import kernels

    def make_worklist(plan, nc, nt, cs, tps, nb_local):
        work, counts, K = shard_sparse_work(plan, nc, nt, cs, tps, nb_local)
        return work, counts, dict(tps=tps)

    def make_launch(i, j, dev, work, counts, st, out, scale):
        wc, wb, wt, wo, ws0, ws1 = (_put(a[i, j], dev.device) for a in work)
        sw = SparseWork(Rs=Rs, n_tiles=st['tps'], n_live=int(counts[i, j]),
                        work_c=wc, work_b=wb, work_t=wt, work_o=wo,
                        work_s0=ws0, work_s1=ws1)

        def launch():
            out.zero_()
            kernels.synth_sparse(dev, sw, out, scale)
        return launch

    return _run_sharded_common(low, mesh, Rs, plan, out_dtype, dac_scale,
                               make_worklist, make_launch)


def _split_pair(plane, combine_pair):
    """A pair-mode plane as it is, or as its (re, im) f32 planes."""
    if combine_pair or plane.dtype != torch.complex64:
        return plane
    return plane.map(lambda b: b.real), plane.map(lambda b: b.imag)


def synthesize_panels_sharded(low: LoweredSchedule, mesh,
                              Rs: int = DEFAULT_SUBTILE_ROWS,
                              plan: SparsePlan | None = None,
                              out_dtype=None, dac_scale=32767.0,
                              combine_pair: bool = True):
    """Panel-kernel synthesis over a ('channel', 'time') mesh, one K2
    launch per shard -> :class:`..parallel.mesh.ShardedPlane`.

    Each shard zero-fills and walks only its own (channel block, sample
    slice) panels from its local worklist (:func:`shard_panel_work`), over
    its own descriptors, which keep the schedule's global ``n_samples`` so
    that the absolute ``work_t`` sets each sample's time.  f32, int16,
    bf16, f16 and pair mode, bucketed or not, under the single-device
    panel rule applied per shard: a narrowed store with several local
    buckets raises UnsupportedFactor.  The TPU's per-shard worklist budget
    (``PANEL_WORK_SMEM_BUDGET``) is not carried over: the worklist lives in
    global memory.  ``combine_pair=False`` returns pair-mode output as two
    f32 (re, im) planes."""
    return _split_pair(panel_shards(low, mesh, Rs, plan, out_dtype,
                                dac_scale).run().plane(), combine_pair)


def synthesize_sparse_sharded(low: LoweredSchedule, mesh,
                              Rs: int = DEFAULT_SUBTILE_ROWS,
                              plan: SparsePlan | None = None,
                              out_dtype=None, dac_scale=32767.0,
                              combine_pair: bool = True):
    """Worklist synthesis over a ('channel', 'time') mesh, one K7 launch per
    shard over its zeroed block -> :class:`..parallel.mesh.ShardedPlane`.

    The global worklist partitions by (channel shard, time shard)
    (:func:`shard_sparse_work`): each shard runs exactly its own live
    subtiles over its channel block's descriptors and writes its sample
    slice; bucketed descriptors shard whole bucket windows along 'time'.
    f32, int16, bf16, f16 and pair mode; ``combine_pair=False`` returns
    pair-mode output as two f32 (re, im) planes."""
    return _split_pair(sparse_shards(low, mesh, Rs, plan, out_dtype,
                                 dac_scale).run().plane(), combine_pair)
