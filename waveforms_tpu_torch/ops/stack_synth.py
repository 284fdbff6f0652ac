"""Pulse-instance batched synthesis: the stack route.

Schedules made of many short pulses (a WaveVStack of 1000 pulses, 100
overlapping DRAGs merged into one channel, a channel with 120 pulses in
half a millisecond) make the segment-walk kernels evaluate whole subtiles
for segments that cover a few dozen samples.  This route flips the
decomposition: every NARROW (channel, segment, term) of the lowered
schedule becomes a pulse instance, evaluated only over the 128-sample
blocks it covers, and the blocks are added into the output.

:func:`build_stack_plan` is the JAX package's planner
(``waveforms_tpu.ops.stack_synth.build_stack_plan``) carried over as numpy,
so that plans compare array-equal with it: instance enumeration,
coalescing of split pulses, the same-support term merge, grouping by
factor structure, and the WIDE residual (long plateaus, carriers, clipped
channels) that stays on the dense kernel.  :func:`build_stack_tables`
flattens a plan into the instance and block tables of the stack kernel
(``csrc/synth_stack.cu``; on the CPU its plain version
:func:`.reference.stack_eval`), and :func:`synthesize_stack` runs it and
adds the residual.

The TPU kernel's table layouts, its one-hot scatter matmul and the
scalar/vector memory caps that shaped them are not carried over: on the
GPU one thread block owns CTA_CHUNKS chunks (32,768 samples) of a channel
and adds each block's samples directly (see the kernels' source).
"""

from __future__ import annotations

import copy
from dataclasses import dataclass, field

import numpy as np
import torch

from .lowering import (SEG_SENTINEL, W_ARGS, LoweredSchedule,
                       UnsupportedFactor)
from .synth import (DeviceSchedule, resolve_device, synthesize_device,
                    validate_out_mode)

__all__ = ['GroupData', 'StackPlan', 'StackTables', 'build_stack_plan',
           'build_stack_tables', 'synthesize_stack', 'DEFAULT_MAX_WIDTH',
           'DEFAULT_ADVANTAGE', 'STACK_MIN_NARROW', 'STACK_OCC_FLOOR',
           'CHUNK_ROWS', 'CTA_CHUNKS', 'STAGE_BLOCKS', 'STAGE_WORDS',
           'chunk_staging']

# instances at most this many samples wide run batched; wider ones go to
# the dense kernel as the residual (the JAX package's value)
DEFAULT_MAX_WIDTH = 2048

# route to the stack kernel when the segment-walk kernels would touch at
# least this many times more samples than the batched path evaluates
# (the JAX package's value, measured on TPU v5e); on the H100 every rung
# of the route ladder with a stack plan has an advantage of 36.9 or more
# and the stack kernel wins wherever the card's rule takes it, so the
# card's rule (ops.routes.CARD_RULE) keeps the value (route_ladder's
# record; NVIDIA H100 80GB HBM3, 700.00 W)
DEFAULT_ADVANTAGE = 4.0

# ... and only with at least this many narrow instances (the JAX value;
# the card's rule keeps it: the short windows with fewer, station and
# flagship_16k, run fastest elsewhere on the H100)
STACK_MIN_NARROW = 64

# padded subtile occupancy from which many-pulse schedules try the stack
# route before the segment walks (the JAX router's value, from its TPU
# occupancy ladder; the JAX rule's).  On the H100 the stack kernel is the
# fastest kernel from the 5-pulse rung (0.021) up, but below this floor
# its plan's 0.1-0.3 s of host time outweighs the 0.01-0.07 ms it saves,
# so the card's rule keeps the floor, where the routers build the plan
# anyway (route_ladder's record)
STACK_OCC_FLOOR = 0.15

# 128-sample rows per chunk of the stack kernels' block lists (the CSR
# offsets chunk_start of StackTables)
CHUNK_ROWS = 64

# the stack kernels' layout (csrc/synth_stack_common.cuh): one thread block
# fills CTA_CHUNKS consecutive chunks of one channel, its warps holding
# whole rows in registers, and stages the chunks' block list, up to
# STAGE_BLOCKS blocks, and their instances' descriptors, up to STAGE_WORDS
# 4-byte words, in shared memory; a thread block past either reads them
# from device memory in place
CTA_CHUNKS = 4
STAGE_BLOCKS = 256
STAGE_WORDS = 8192


@dataclass
class GroupData:
    """One structure group of narrow pulse instances (host arrays).

    An instance is a full SEGMENT-support evaluation: the sum over its
    terms of each term's factor product (same-support terms merge into
    one instance at plan build).  Factor arrays pack the LIVE factors of
    every term flat along one axis (TF = sum(term_nfac))."""
    ops: tuple            # flat per-factor opcode, len TF
    powers: tuple         # flat per-factor integer power, len TF
    term_nfac: tuple      # live factors per term; len NT
    amp: np.ndarray       # f32[M, NT] per-term amplitude
    lo: np.ndarray        # i64[M] first sample (clipped, global)
    hi: np.ndarray        # i64[M] one past last sample
    row0: np.ndarray      # i64[M] first 128-row
    chan: np.ndarray      # i64[M]
    shift: np.ndarray     # i32[M, TF]
    q32: np.ndarray       # i32[M, TF, 4]
    args: np.ndarray      # f32[M, TF, W]


@dataclass
class StackPlan:
    groups: list[GroupData] = field(default_factory=list)
    wide: LoweredSchedule | None = None   # residual for the dense kernel
    n_narrow: int = 0
    n_blocks_total: int = 0
    kernel_samples: int = 0    # samples the kernels would walk for narrow
    batch_samples: int = 0     # samples the batched path evaluates
    n_rows: int = 0
    n_channels: int = 0
    n_samples: int = 0
    # the stack kernel's tables per device (build_stack_tables)
    tables: dict = field(default_factory=dict, repr=False, compare=False)

    @property
    def advantage(self) -> float:
        """How many times fewer samples the batched path touches."""
        return self.kernel_samples / max(self.batch_samples, 1)


def build_stack_plan(low: LoweredSchedule,
                     max_width: int = DEFAULT_MAX_WIDTH,
                     subtile: int = 32 * 128) -> StackPlan | None:
    """Enumerate narrow pulse instances of a lowered schedule.

    Returns None when the schedule has no batched work (all wide, complex
    amplitudes, or clipped channels).  ``subtile`` is the sparse kernel's
    tile size, used only for the cost model in ``kernel_samples``.
    """
    if low.amp_im is not None:
        return None
    C, NB, S, T, F = low.shape
    n_rows = -(-low.n_samples // 128)
    clip_finite = (np.isfinite(low.clip_min) | np.isfinite(low.clip_max))

    # vectorized instance enumeration over (c, b, s)
    nt = low.nterm                      # (C, NB, S)
    live = nt > 0
    if not live.any():
        return None
    cs, bs, ss = np.nonzero(live)
    lo = low.seg_lo[cs, bs, ss].astype(np.int64)
    hi = low.seg_hi[cs, bs, ss].astype(np.int64)
    if NB > 1:
        blo = bs.astype(np.int64) * low.bucket_samples
        bhi = np.minimum(blo + low.bucket_samples, low.n_samples)
        lo = np.maximum(lo, blo)
        hi = np.minimum(hi, bhi)
    lo = np.clip(lo, 0, low.n_samples)
    hi = np.clip(hi, 0, low.n_samples)
    keep = hi > lo
    cs, bs, ss, lo, hi = cs[keep], bs[keep], ss[keep], lo[keep], hi[keep]
    nseg_terms = nt[cs, bs, ss]

    # expand every live segment into per-term instances
    rep = np.repeat(np.arange(len(cs)), nseg_terms)   # segment idx per inst
    tj = (np.concatenate([np.arange(k) for k in nseg_terms])
          if len(nseg_terms) else np.zeros(0, np.int64))
    ic, ib, is_ = cs[rep], bs[rep], ss[rep]
    ilo, ihi = lo[rep], hi[rep]
    M0 = len(ic)
    if M0 == 0:
        return None
    nfac = low.nfac[ic, ib, is_, tj]
    ops_arr = low.op[ic, ib, is_, tj].reshape(M0, -1)   # (M0, F)
    pw_arr = low.power[ic, ib, is_, tj].reshape(M0, -1)
    sh_arr = low.shift_hi[ic, ib, is_, tj].reshape(M0, -1)
    q_arr = low.q32[ic, ib, is_, tj].reshape(M0, -1)
    a_arr = low.args[ic, ib, is_, tj].reshape(M0, -1)
    amp_arr = low.amp[ic, ib, is_, tj]

    # COALESCE: a pulse overlapped by others is split by the piecewise
    # merge into many adjacent segments carrying IDENTICAL term
    # descriptors (and bucket splits duplicate them again).  Merging
    # contiguous identical-descriptor instances recovers each pulse's
    # full support.  f64 packing is exact for every field (f32 bits,
    # int32, small ints).
    mat = np.column_stack([ic, nfac, ops_arr, pw_arr, sh_arr, q_arr,
                           a_arr.astype(np.float64),
                           amp_arr.astype(np.float64)])
    _, inv = np.unique(mat, axis=0, return_inverse=True)
    order = np.lexsort((ilo, inv))
    sinv, slo, shi = inv[order], ilo[order], ihi[order]
    new_run = np.ones(M0, bool)
    new_run[1:] = (sinv[1:] != sinv[:-1]) | (slo[1:] != shi[:-1])
    starts = np.flatnonzero(new_run)
    ends = np.r_[starts[1:], M0] - 1
    keep = order[starts]                    # representative instance
    mlo = slo[starts]
    mhi = shi[ends]
    gid_of_inst = np.empty(M0, np.int64)    # original -> coalesced id
    gid_of_inst[order] = np.cumsum(new_run) - 1

    width = mhi - mlo
    narrow = (width <= max_width) & ~clip_finite[ic[keep]]
    n_narrow = int(narrow.sum())
    if n_narrow == 0:
        return None

    plan = StackPlan(n_rows=n_rows, n_channels=C, n_samples=low.n_samples)
    # kernel cost proxy: each narrow instance forces its covering
    # subtiles' evaluation in the sparse kernel (dense is worse)
    ktiles = (mhi[narrow] - 1) // subtile - mlo[narrow] // subtile + 1
    plan.kernel_samples = int((ktiles * subtile).sum())

    nk = keep[narrow]
    nlo, nhi = mlo[narrow], mhi[narrow]

    # SAME-SUPPORT TERM MERGE: per-term instances sharing (channel, lo,
    # hi) fuse into ONE multi-term instance (sum of per-term factor
    # products).  Factor tables pack only LIVE factors.
    sh_f = sh_arr.reshape(M0, F)
    q_f = q_arr.reshape(M0, F, 4)
    a_f = a_arr.reshape(M0, F, -1)
    W = a_f.shape[-1]
    order2 = np.lexsort((nhi, nlo, ic[nk]))
    j = 0
    n_sorted = len(order2)
    inst_list = []              # (key, members) in first-seen order
    while j < n_sorted:
        k = j
        a0 = order2[j]
        while (k + 1 < n_sorted
               and ic[nk[order2[k + 1]]] == ic[nk[a0]]
               and nlo[order2[k + 1]] == nlo[a0]
               and nhi[order2[k + 1]] == nhi[a0]):
            k += 1
        members = order2[j:k + 1]
        # canonical term order inside the instance -> stable group keys
        term_keys = []
        for m in members:
            src_i = nk[m]
            nf = int(nfac[src_i])
            term_keys.append((
                tuple(int(o) for o in ops_arr[src_i, :nf]),
                tuple(int(p) for p in pw_arr[src_i, :nf]), m))
        term_keys.sort(key=lambda t: t[:2])
        key = tuple(t[:2] for t in term_keys)
        inst_list.append((key, [t[2] for t in term_keys]))
        j = k + 1

    by_key: dict = {}
    for i, (key, members) in enumerate(inst_list):
        by_key.setdefault(key, []).append((i, members))
    plan.n_narrow = len(inst_list)
    n_blocks_total = 0
    for key, insts in sorted(by_key.items()):
        term_nfac = tuple(len(t[0]) for t in key)
        kops = tuple(o for t in key for o in t[0])
        kpw = tuple(p for t in key for p in t[1])
        NT = len(term_nfac)
        TF = len(kops)
        M = len(insts)
        amp_g = np.zeros((M, NT), np.float32)
        sh_g = np.zeros((M, TF), sh_f.dtype)
        q_g = np.zeros((M, TF, 4), q_f.dtype)
        a_g = np.zeros((M, TF, W), a_f.dtype)
        lo_g = np.zeros(M, np.int64)
        hi_g = np.zeros(M, np.int64)
        ch_g = np.zeros(M, np.int64)
        for r, (i, members) in enumerate(insts):
            m0 = members[0]
            lo_g[r], hi_g[r], ch_g[r] = nlo[m0], nhi[m0], ic[nk[m0]]
            f0 = 0
            for t, m in enumerate(members):
                src_i = nk[m]
                nf = term_nfac[t]
                amp_g[r, t] = amp_arr[src_i]
                sh_g[r, f0:f0 + nf] = sh_f[src_i, :nf]
                q_g[r, f0:f0 + nf] = q_f[src_i, :nf]
                a_g[r, f0:f0 + nf] = a_f[src_i, :nf]
                f0 += nf
        row0_g = lo_g >> 7
        nblk_g = ((hi_g - 1) >> 7) - row0_g + 1
        n_blocks_total += int(nblk_g.sum())
        plan.groups.append(GroupData(
            ops=kops, powers=kpw, term_nfac=term_nfac,
            amp=amp_g, lo=lo_g, hi=hi_g, row0=row0_g, chan=ch_g,
            shift=sh_g, q32=q_g, args=a_g,
        ))
    plan.n_blocks_total = n_blocks_total
    plan.batch_samples = n_blocks_total * 128

    # residual schedule: terms belonging to WIDE coalesced instances (and
    # clipped channels) keep the kernel path.  Per segment, wide terms
    # compact to the front so batched slots vanish from the walk.
    inst_narrow = narrow[gid_of_inst]       # per original instance
    if not inst_narrow.all():
        wide = copy.copy(low)
        # every array that the compaction or _normalize_segment_order
        # writes is copied: the caller's schedule stays as it was
        for name in ('nterm', 'nfac', 'amp', 'op', 'power', 'shift_hi',
                     'q32', 'args', 'seg_lo', 'seg_hi'):
            setattr(wide, name, getattr(low, name).copy())
        # the hi-tier residual planes are not compacted; the residual is
        # an f32 dense-kernel schedule, so they are dropped
        wide.args_lo = None
        wide.amp_lo = None
        seg_first = np.searchsorted(rep, np.arange(len(cs)))
        for j, (c, b, s) in enumerate(zip(cs, bs, ss)):
            k = int(nseg_terms[j])
            sl = slice(seg_first[j], seg_first[j] + k)
            w_terms = np.flatnonzero(~inst_narrow[sl])
            if len(w_terms) == k:
                continue
            if len(w_terms) == 0:
                wide.nterm[c, b, s] = 0
                wide.seg_lo[c, b, s] = SEG_SENTINEL
                wide.seg_hi[c, b, s] = SEG_SENTINEL
                continue
            for name in ('nfac', 'amp'):
                arr = getattr(wide, name)
                arr[c, b, s, :len(w_terms)] = arr[c, b, s, w_terms]
            for name in ('op', 'power', 'shift_hi', 'q32', 'args'):
                arr = getattr(wide, name)
                arr[c, b, s, :len(w_terms)] = arr[c, b, s, w_terms]
            wide.nterm[c, b, s] = len(w_terms)
        wide._normalize_segment_order()
        plan.wide = wide
    return plan


@dataclass
class StackTables:
    """A StackPlan flattened for the stack kernel, as tensors on one device.

    Instances of every group share one table, padded to the plan's widest
    term and factor counts: per instance ``inst`` = (channel, lo, hi,
    n_terms) int32, ``amp`` (M, NTmax) f32, ``term_nfac`` (M, NTmax) int32,
    and per factor ``op``, ``power``, ``shift_hi`` (M, TFmax) int32, ``q32``
    (M, TFmax, 4) int32, ``args`` (M, TFmax, W_ARGS) f32.  Blocks
    (``blk_inst``, ``blk_row``: source instance and per-channel 128-row)
    are sorted by (channel, chunk of CHUNK_ROWS rows), stably, as the JAX
    package's ``_chunk_assign`` sorts them by output chunk, with CSR
    offsets ``chunk_start`` (C * n_chunks + 1).  ``ext`` is the schedule's
    side-buffer, read in place by the drag_sin opcodes.  The tables of K
    schedules stacked by :class:`.stack_seq.StackSequencer` have a
    (K, C * n_chunks + 1) ``chunk_start``, row k bounding schedule k's
    blocks."""
    n_channels: int
    n_samples: int
    n_chunks: int            # chunks per channel
    NT: int
    TF: int
    inst: torch.Tensor
    amp: torch.Tensor
    term_nfac: torch.Tensor
    op: torch.Tensor
    power: torch.Tensor
    shift_hi: torch.Tensor
    q32: torch.Tensor
    args: torch.Tensor
    ext: torch.Tensor
    blk_inst: torch.Tensor
    blk_row: torch.Tensor
    chunk_start: torch.Tensor

    @property
    def n_blocks(self) -> int:
        return int(self.blk_inst.shape[0])


def build_stack_tables(plan: StackPlan, low: LoweredSchedule,
                       device='cuda') -> StackTables:
    """Flatten ``plan``'s groups into one instance table and its CSR block
    list on ``device`` (cached on the plan per device)."""
    device = resolve_device(device)
    if str(device) in plan.tables:
        return plan.tables[str(device)]
    groups = plan.groups
    M = sum(len(g.amp) for g in groups)
    NT = max((len(g.term_nfac) for g in groups), default=1)
    TF = max(max((len(g.ops) for g in groups), default=1), 1)
    inst = np.zeros((M, 4), np.int32)
    amp = np.zeros((M, NT), np.float32)
    tnf = np.zeros((M, NT), np.int32)
    op = np.zeros((M, TF), np.int32)
    pw = np.ones((M, TF), np.int32)
    sh = np.zeros((M, TF), np.int32)
    q = np.zeros((M, TF, 4), np.int32)
    args = np.zeros((M, TF, W_ARGS), np.float32)
    blk_inst, blk_row = [], []
    m0 = 0
    for g in groups:
        m, nt, tf = len(g.amp), len(g.term_nfac), len(g.ops)
        sl = slice(m0, m0 + m)
        inst[sl] = np.stack([g.chan, g.lo, g.hi, np.full(m, nt)], axis=1)
        amp[sl, :nt] = g.amp
        tnf[sl, :nt] = g.term_nfac
        op[sl, :tf] = g.ops
        pw[sl, :tf] = g.powers
        sh[sl, :tf] = g.shift
        q[sl, :tf] = g.q32
        args[sl, :tf] = g.args
        nblk = ((g.hi - 1) >> 7) - g.row0 + 1
        src = np.repeat(np.arange(m), nblk)
        off = (np.concatenate([np.arange(k) for k in nblk])
               if m else np.zeros(0, np.int64))
        blk_inst.append(m0 + src)
        blk_row.append(g.row0[src] + off)
        m0 += m
    C, n = plan.n_channels, plan.n_samples
    n_chunks = -(-plan.n_rows // CHUNK_ROWS)
    bi = np.concatenate(blk_inst) if blk_inst else np.zeros(0, np.int64)
    br = np.concatenate(blk_row) if blk_row else np.zeros(0, np.int64)
    key = inst[bi, 0].astype(np.int64) * n_chunks + br // CHUNK_ROWS
    order = np.argsort(key, kind='stable')
    start = np.zeros(C * n_chunks + 1, np.int64)
    np.add.at(start, key + 1, 1)
    ext = np.zeros(max(int(low.ext.size) if low.ext is not None else 0, 1),
                   np.float32)
    if low.ext is not None and low.ext.size:
        ext[:low.ext.size] = low.ext

    def put(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(device)

    tables = StackTables(
        n_channels=C, n_samples=n, n_chunks=n_chunks, NT=NT, TF=TF,
        inst=put(inst, np.int32), amp=put(amp, np.float32),
        term_nfac=put(tnf, np.int32), op=put(op, np.int32),
        power=put(pw, np.int32), shift_hi=put(sh, np.int32),
        q32=put(q, np.int32), args=put(args, np.float32),
        ext=put(ext, np.float32), blk_inst=put(bi[order], np.int32),
        blk_row=put(br[order], np.int32),
        chunk_start=put(np.cumsum(start), np.int32))
    plan.tables[str(device)] = tables
    return tables


def chunk_staging(t: StackTables) -> dict:
    """How the stack kernels stage tables ``t``: numpy arrays with one
    entry per thread block -- CTA_CHUNKS consecutive chunks of one channel,
    channel-major (per schedule of stacked tables, one row each) -- of its
    ``blocks``, its ``slots`` (runs of consecutive blocks of one instance,
    each staged once) and whether it is ``staged``: its block list and
    descriptors fit STAGE_BLOCKS and STAGE_WORDS, else it walks them in
    place."""
    cs = t.chunk_start.cpu().numpy().astype(np.int64)
    n = t.n_chunks
    first = (np.arange(t.n_channels)[:, None] * n
             + np.arange(0, n, CTA_CHUNKS)[None, :])
    last = np.minimum(first + CTA_CHUNKS, (first // n + 1) * n)
    k0, k1 = cs[..., first.ravel()], cs[..., last.ravel()]
    bi = t.blk_inst.cpu().numpy()
    opens = np.ones(len(bi), np.int64)
    opens[1:] = bi[1:] != bi[:-1]
    opens[k0[k1 > k0]] = 1          # a thread block's first block opens a slot
    runs = np.concatenate([[0], np.cumsum(opens)])
    blocks, slots = k1 - k0, runs[k1] - runs[k0]
    words = 4 + 2 * t.NT + (3 + 4 + W_ARGS) * t.TF
    fit = min(STAGE_BLOCKS, STAGE_WORDS // words)
    return {'blocks': blocks, 'slots': slots,
            'staged': (blocks <= STAGE_BLOCKS) & (slots <= fit)}


def synthesize_stack(low: LoweredSchedule, plan: StackPlan | None = None,
                     out_dtype=None, dac_scale=32767.0,
                     device='cuda') -> torch.Tensor:
    """Synthesize via the pulse-instance batched path -> (C, n_samples) on
    ``device``: the stack kernel over the narrow instances, plus the dense
    kernel over the wide residual, summed in f32.

    ``out_dtype=torch.int16`` emits DAC codes
    ``clip(round_half_even(x * dac_scale))``; ``torch.bfloat16`` and
    ``torch.float16`` round the f32 sum once to nearest even, with no
    scale.  As in the JAX package, the stack kernel narrows in its own
    store only for a plan with no residual and a scalar ``dac_scale``;
    otherwise the f32 sum is narrowed after it, so it rounds once.  The
    kernel tables are built once per plan and device and cached on the
    plan."""
    from .. import kernels
    if plan is None:
        plan = build_stack_plan(low)
    if plan is None:
        raise UnsupportedFactor(
            "schedule has no batchable pulse instances (complex, clipped, "
            "or all-wide) -- use the kernel engines")
    if low.amp_im is not None:
        raise ValueError("the stack route has no pair mode (part='complex')")
    device = resolve_device(device)
    C, n = plan.n_channels, plan.n_samples
    dt, scale = validate_out_mode(out_dtype, C, dac_scale, device)
    in_kernel = (dt != torch.float32 and plan.wide is None
                 and np.ndim(dac_scale) == 0)
    out = torch.empty((C, n), dtype=dt if in_kernel else torch.float32,
                      device=device)
    out = kernels.synth_stack(build_stack_tables(plan, low, device), out,
                              scale if in_kernel else None)
    if plan.wide is not None:
        out += synthesize_device(DeviceSchedule(plan.wide, device))
    if dt == torch.int16 and not in_kernel:
        out = torch.clamp(torch.round(out * scale[:, None]), -32768.0,
                          32767.0).to(torch.int16)
    elif dt != torch.float32 and not in_kernel:
        out = out.to(dt)
    return out
