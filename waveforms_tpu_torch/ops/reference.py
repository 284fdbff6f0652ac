"""Plain PyTorch versions of the synthesis kernels.

These compute, sample by sample, what the CUDA kernels in ``csrc/`` and
the Pallas kernels of ``waveforms_tpu`` compute: for every sample, the sum
over the segments that contain it (in the bucket's lo-sorted order) of
``clip(sum_t amp_t * prod_f factor_f ** power_f)``, accumulated in f32.
The 17 opcode formulas (:func:`op_builders`) follow
``waveforms_tpu.ops.pallas_synth.op_builders`` term by term: carrier and
chirp phases in int32 fixed-point turns plus an f32 residual, the
Abramowitz-Stegun erf, round-half-even everywhere.

int32 wraparound is the phase design.  Here the integer phase arithmetic
runs in int64 and wraps to int32 explicitly (:func:`wrap32`); it never
relies on int32 tensor overflow.

The walks gather only the samples that a live segment covers, in chunks,
so they run at full schedule size on the card (``chip_smoke.py`` holds the
kernels against them there) and at test size on the CPU.
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch

from .lowering import (DRAG_SIN_NC, DRAG_SINX_MAXQ, OP_COS, OP_COSH, OP_DRAG,
                       OP_DRAG_SIN, OP_DRAG_SINX, OP_ERF, OP_EXP, OP_EXPCHIRP,
                       OP_GAUSSIAN, OP_HYPCHIRP, OP_INTERP, OP_LINEAR,
                       OP_LINEARCHIRP, OP_MOLLIFIER, OP_POLY_GAUSS, OP_SINC,
                       OP_SINH, W_ARGS)

__all__ = ['op_builders', 'dense_window', 'dense_walk', 'panel_walk',
           'sparse_walk', 'stack_eval', 'stack_seq_eval', 'wrap32',
           'dense_bucket0', 'stack_window', 'dense_walk_shots',
           'sparse_walk_shots']

_F32 = torch.float32
# f32 constants, exactly as the JAX kernel spells them (np.float32 values)
_PHASE = float(np.float32(2 * np.pi / 2**32))   # int32 turn -> radians
_INV_TWO_PI = float(np.float32(1.0 / (2 * np.pi)))
_TWO_PI = float(np.float32(2 * np.pi))
_PI = float(np.float32(np.pi))
_TWO31 = float(np.float32(2**31))
_EXP_CLAMP = 80.0
_COS_POLY = [float(np.float32(v)) for v in
             (-1 / 2, 1 / 24, -1 / 720, 1 / 40320, -1 / 3628800)]
_SIN_POLY = [float(np.float32(v)) for v in
             (-1 / 6, 1 / 120, -1 / 5040, 1 / 362880)]
_ERF = [float(np.float32(v)) for v in
        (0.3275911, 0.254829592, -0.284496736, 1.421413741, -1.453152027,
         1.061405429)]

# elements evaluated per gather step: bounds the temporaries of a walk
CHUNK = 1 << 22

# rows of 128 samples in a chunk of the stack tables (== .stack_synth
# .CHUNK_ROWS and csrc/synth_stack_common.cuh's CHUNK_ROWS)
STACK_CHUNK_ROWS = 64

# PyTorch's CPU transcendentals can return values ~1e-4 off, over one or
# more worker threads' shares of the elements, the first time they run in a
# process (torch 2.13.0+cpu with MKL 2024.2 on AVX-512; count them with
# ``python -m waveforms_tpu_torch.cpu_first_call``), and right on every
# later call.  Running each once at full thread width first keeps them
# right, so the plain versions do that before their first CPU evaluation,
# and again whenever the intra-op thread count has changed since.
_WARM_ELEMENTS = 1 << 20      # enough for every thread to take a share
_cpu_math_warm_threads = 0    # the thread count of the last warm-up


def warm_cpu_math():
    """Run the transcendentals the plain versions use once on a throwaway
    CPU tensor (see above); later calls do nothing until
    ``torch.get_num_threads()`` changes."""
    global _cpu_math_warm_threads
    threads = torch.get_num_threads()
    if _cpu_math_warm_threads == threads:
        return
    for dt in (torch.float32, torch.float64):
        x = torch.linspace(0.5, 1.5, _WARM_ELEMENTS, dtype=dt)
        for fn in (torch.sin, torch.cos, torch.exp, torch.log):
            fn(x)
        torch.pow(x, x)
    _cpu_math_warm_threads = threads


def wrap32(x):
    """int64 tensor -> the same values wrapped to the int32 range."""
    return ((x + 2**31) & 0xFFFFFFFF) - 2**31


def _fma(a, b, c):
    """f32 ``a * b + c`` rounded once, as a fused multiply-add: the f64
    product of two f32 values is exact.  The kernels' Horner steps compile
    to FMAs (nvcc, and XLA for the JAX kernels); rounding twice instead
    loses ~2e-6 of the peak on the 40-coefficient DRAG blend polynomials."""
    return (a.double() * b.double() + c.double()).to(_F32)


def _carrier_parts(di, q32, cq32, eps, ceps):
    """Carrier phase as (int32 turns, f32 residual); see the JAX kernel's
    ``_carrier_parts``."""
    turns = wrap32(q32 * di + cq32)
    return turns, eps * di.to(_F32) + ceps


def _quadratic_parts(di, q_hh, q_hl, q_ll, q_lin, e_hh, e_hl, e_ll, e_lin):
    """Chirp phase A*di^2 + B*di with di = dh*2^11 + dl (arithmetic shift),
    every integer product wrapped to int32 as it forms."""
    dh = di >> 11
    dl = di - (dh << 11)
    turns = wrap32(wrap32(wrap32(q_hh * dh) * dh)
                   + wrap32(wrap32(q_hl * dh) * dl)
                   + wrap32(wrap32(q_ll * dl) * dl)
                   + wrap32(q_lin * di))
    dhf = dh.to(_F32)
    dlf = dl.to(_F32)
    dif = di.to(_F32)
    resid = ((e_hh * dhf + e_hl * dlf) * dhf + e_ll * dlf * dlf
             + e_lin * dif)
    return turns, resid


def _const_phase_turns(phi):
    """f32 radians -> (int32 turns, f32 residual), rounding twice and
    wrapping the residual, term by term as the JAX kernel does."""
    c = phi * _INV_TWO_PI
    ci = torch.round((c - torch.round(c)) * _TWO31).to(torch.int64)
    turns = wrap32(ci * 2)
    resid = phi - turns.to(_F32) * _PHASE
    return turns, resid - _TWO_PI * torch.round(resid * _INV_TWO_PI)


def _sincos_turns(turns, resid):
    """(sin, cos) of ``turns * 2pi/2^32 + resid``: quadrant from the top
    two bits, Taylor polynomials on [-pi/4, pi/4)."""
    q = wrap32(turns + (1 << 29))
    quad = (q >> 30) & 3
    r = (q & 0x3FFFFFFF) - (1 << 29)
    x = r.to(_F32) * _PHASE + resid
    x2 = x * x
    c2, c4, c6, c8, c10 = _COS_POLY
    s3, s5, s7, s9 = _SIN_POLY
    cosx = 1.0 + x2 * (c2 + x2 * (c4 + x2 * (c6 + x2 * (c8 + x2 * c10))))
    sinx = x * (1.0 + x2 * (s3 + x2 * (s5 + x2 * (s7 + x2 * s9))))
    swap = (quad & 1) == 1
    csign = torch.where((quad == 1) | (quad == 2), -1.0, 1.0)
    ssign = torch.where(quad >= 2, -1.0, 1.0)
    cos = torch.where(swap, sinx, cosx) * csign
    sin = torch.where(swap, cosx, sinx) * ssign
    return sin, cos


def op_builders(di, arg, q32, eread):
    """``{opcode: zero-arg builder}`` over one batch of elements.

    ``di`` is the int64 sample delta (idx - shift_hi, wrapped to int32);
    ``arg(k)`` returns the factor's f32 arg slot k, ``q32(j)`` its int32
    phase slot j (as int64), ``eread(k)`` the ext word at ``int(arg(7)) + k``.
    """
    dif = di.to(_F32)

    def u():
        return dif - arg(0)

    def op_linear():
        return arg(1) * u()

    def op_gaussian():
        x = arg(1) * u()
        return torch.exp(-(x * x))

    def op_erf():
        # Abramowitz-Stegun 7.1.26, the same form as the kernels
        p, a1, a2, a3, a4, a5 = _ERF
        x = arg(1) * u()
        sign = torch.sign(x)
        ax = torch.abs(x)
        t = 1.0 / (1.0 + p * ax)
        poly = t * (a1 + t * (a2 + t * (a3 + t * (a4 + t * a5))))
        return sign * (1.0 - poly * torch.exp(-(ax * ax)))

    def op_cos():
        turns, resid = _carrier_parts(di, q32(0), q32(1), arg(2), arg(3))
        return _sincos_turns(turns, resid)[1]

    def op_sinc():
        x = arg(1) * u()
        px = _PI * x
        small = torch.abs(px) < 1e-6
        safe = torch.where(small, 1.0, px)
        return torch.where(small, 1.0, torch.sin(safe) / safe)

    def op_exp():
        return torch.exp(torch.clamp(arg(1) * u(), -_EXP_CLAMP, _EXP_CLAMP))

    def op_linearchirp():
        turns, resid = _quadratic_parts(
            di, q32(0), q32(1), q32(2), q32(3),
            arg(2), arg(3), arg(4), arg(5))
        cturns, ceps = _const_phase_turns(arg(6))
        return _sincos_turns(wrap32(turns + cturns), resid + ceps)[0]

    def op_expchirp():
        x = torch.clamp(arg(2) * u(), -_EXP_CLAMP, _EXP_CLAMP)
        return torch.sin(arg(3) + arg(1) * torch.exp(x))

    def op_hypchirp():
        x = torch.clamp(1.0 + arg(2) * u(), min=1e-30)
        return torch.sin(arg(3) + arg(1) * torch.log(x))

    def op_cosh():
        e = torch.exp(torch.clamp(arg(1) * u(), -_EXP_CLAMP, _EXP_CLAMP))
        return 0.5 * (e + 1.0 / e)

    def op_sinh():
        e = torch.exp(torch.clamp(arg(1) * u(), -_EXP_CLAMP, _EXP_CLAMP))
        return 0.5 * (e - 1.0 / e)

    def op_drag():
        x = arg(1) * u()
        s = torch.sin(x)
        env_x = s * s
        turns, resid = _carrier_parts(di, q32(0), q32(1), arg(3), arg(4))
        sin_t, cos_t = _sincos_turns(turns, resid)
        env_y = arg(5) * torch.sin(2.0 * x)
        return env_x * cos_t + env_y * sin_t

    def _polyval_asc(x, first, count):
        acc = torch.zeros_like(x)
        for k in range(count - 1, -1, -1):
            acc = _fma(acc, x, arg(first + k))
        return acc

    def op_poly_gauss():
        x = arg(1) * u()
        return arg(2) * _polyval_asc(x, 3, 9) * torch.exp(-(x * x))

    def _drag_sin_like(with_blend):
        o_dt = arg(1)
        uu = u()
        left_hi = arg(5) * 0.5
        right_lo = left_hi + arg(6)
        rise = uu <= left_hi
        flat = ~rise & (uu < right_lo)
        bt = torch.where(rise, uu, uu - arg(6))
        s = torch.sin(o_dt * bt)
        c = torch.cos(o_dt * bt)
        ox = torch.zeros_like(uu)
        oy = torch.zeros_like(uu)
        sp = torch.ones_like(uu)
        for p in range(DRAG_SIN_NC):
            basis = sp * c if p % 2 else sp
            ox = ox + eread(1 + p) * basis
            oy = oy + eread(1 + DRAG_SIN_NC + p) * basis
            sp = sp * s
        ox = torch.where(flat, eread(1 + 2 * DRAG_SIN_NC), ox)
        oy = torch.where(flat, eread(2 + 2 * DRAG_SIN_NC), oy)
        if with_blend:
            b0 = 3 + 2 * DRAG_SIN_NC
            bh = eread(b0)

            def horner(base, x):
                acc = torch.zeros_like(x)
                for k in range(DRAG_SINX_MAXQ - 1, -1, -1):
                    acc = _fma(acc, x, eread(base + k))
                return acc

            stride = 1 + DRAG_SINX_MAXQ
            dl_ = uu - left_hi
            dr_ = uu - right_lo
            in_l = (uu >= left_hi - bh) & (uu <= left_hi)
            in_r = (uu >= right_lo) & (uu <= right_lo + bh)
            ox = torch.where(in_l, horner(b0 + 2, dl_), ox)
            oy = torch.where(in_l, horner(b0 + 2 + stride, dl_), oy)
            ox = torch.where(in_r, horner(b0 + 2 + 2 * stride, dr_), ox)
            oy = torch.where(in_r, horner(b0 + 2 + 3 * stride, dr_), oy)
        turns, resid = _carrier_parts(di, q32(0), q32(1), arg(3), arg(4))
        sin_t, cos_t = _sincos_turns(turns, resid)
        return ox * cos_t + oy * sin_t

    def op_mollifier():
        x = arg(1) * u()
        xx1 = x * x - 1.0
        inside = xx1 < 0
        safe = torch.where(inside, xx1, -1.0)
        bump = torch.exp(1.0 / safe + 1.0)
        d = arg(2)
        denom = torch.where(inside, torch.pow(-safe, 2.0 * d), 1.0)
        poly = torch.where(d > 0, _polyval_asc(x, 3, 9), 1.0)
        return torch.where(inside, bump / denom * poly, 0.0)

    return {
        OP_LINEAR: op_linear,
        OP_GAUSSIAN: op_gaussian,
        OP_ERF: op_erf,
        OP_COS: op_cos,
        OP_SINC: op_sinc,
        OP_EXP: op_exp,
        OP_LINEARCHIRP: op_linearchirp,
        OP_EXPCHIRP: op_expchirp,
        OP_HYPCHIRP: op_hypchirp,
        OP_COSH: op_cosh,
        OP_SINH: op_sinh,
        OP_DRAG: op_drag,
        OP_POLY_GAUSS: op_poly_gauss,
        OP_MOLLIFIER: op_mollifier,
        OP_INTERP: op_linear,   # reserved: never emitted
        OP_DRAG_SIN: lambda: _drag_sin_like(False),
        OP_DRAG_SINX: lambda: _drag_sin_like(True),
    }


def _raise_power(v, p):
    """v ** p by repeated multiplication (p == 1 passes v through; a
    negative p inverts the product), as the kernels do."""
    ap = p.abs()
    out = v
    for i in range(1, int(ap.max()) if ap.numel() else 1):
        out = torch.where(i < ap, out * v, out)
    return torch.where(p < 0, 1.0 / out, out)


def _factor_values(d, ff, idx, live):
    """Factor ``ff`` (flat factor index per element) at sample ``idx``;
    1.0 where ``live`` is False.  ``d`` holds flat-indexable ``op``,
    ``power``, ``shift_hi``, ``q32``, ``args`` and ``ext`` (a
    DeviceSchedule or the stack kernel's instance tables)."""
    if idx.device.type == 'cpu':
        warm_cpu_math()
    op = torch.where(live, d.op.reshape(-1)[ff], -1)
    out = torch.ones(idx.shape, dtype=_F32, device=idx.device)
    args = d.args.reshape(-1)
    q32 = d.q32.reshape(-1)
    for code in torch.unique(op).tolist():
        if code < 0:
            continue
        m = torch.nonzero(op == code).squeeze(1)
        f = ff[m]
        di = wrap32(idx[m] - d.shift_hi.reshape(-1)[f])

        def arg(k, f=f):
            return args[f * W_ARGS + k]

        def q(j, f=f):
            return q32[f * 4 + j].to(torch.int64)

        def eread(k, arg=arg):
            return d.ext[arg(7).to(torch.int64) + k]

        v = op_builders(di, arg, q, eread)[code]()
        out[m] = _raise_power(v, d.power.reshape(-1)[f])
    return out


def _segment_values(d, c, b, s, idx):
    """``clip(sum_t amp_t * prod_f factor_f)`` of slot (c, b, s) at idx, as
    a list of one plane, or of two in pair mode (``d.amp_im`` set): there
    the product starts at 1.0 and the two planes are ``sum_t amp_t * prod``
    and ``sum_t amp_im_t * prod``, each clipped, as the JAX kernel's
    ``_tile_walker`` computes them."""
    C, NB, S, T, F = d.shape
    pair = d.amp_im is not None
    row = (c * NB + b) * S + s
    nt = d.nterm.reshape(-1)[row]
    amp = d.amp.reshape(-1)
    amp_im = d.amp_im.reshape(-1) if pair else None
    nfac = d.nfac.reshape(-1)
    segs = [torch.zeros(idx.shape, dtype=_F32, device=idx.device)
            for _ in range(2 if pair else 1)]
    for t in range(T):
        live_t = t < nt
        if not bool(live_t.any()):
            break
        tf = row * T + t
        prod = torch.ones_like(segs[0]) if pair else amp[tf]
        nf = nfac[tf]
        for f in range(F):
            live_f = live_t & (f < nf)
            if not bool(live_f.any()):
                break
            prod = prod * _factor_values(d, tf * F + f, idx, live_f)
        terms = (amp[tf] * prod, amp_im[tf] * prod) if pair else (prod,)
        segs = [torch.where(live_t, sg + v, sg) for sg, v in zip(segs, terms)]
    cmin = d.clip[c, 0]
    cmax = d.clip[c, 1]
    return [torch.minimum(torch.maximum(sg, cmin), cmax) for sg in segs]


def _accumulate(d, accs, c, b, s, a, e, dst, values=None, orow=None):
    """Add slot (c[r], b[r], s[r])'s value over samples [a[r], e[r]) into
    ``acc[orow[r], dst[r] + (idx - a[r])]`` for each plane of ``accs``
    (``orow`` defaults to the channel ``c``), in chunks of elements.
    Within one call no output element is hit twice, so the adds do not
    race.  ``values`` evaluates the slots (default
    :func:`_segment_values`; the double tier passes its own)."""
    values = values or _segment_values
    orow = c if orow is None else orow
    n_out = accs[0].shape[1]
    length = e - a
    cum = torch.cumsum(length, 0)
    total = int(cum[-1]) if cum.numel() else 0
    first = cum - length
    for e0 in range(0, total, CHUNK):
        el = torch.arange(e0, min(e0 + CHUNK, total), device=accs[0].device)
        r = torch.searchsorted(cum, el, right=True)
        off = el - first[r]
        cr = c[r]
        vals = values(d, cr, b[r], s[r], a[r] + off)
        for acc, v in zip(accs, vals):
            acc.view(-1).index_add_(0, orow[r] * n_out + dst[r] + off, v)


def _planes(out, pair):
    """Zeroed f32 accumulators for ``out``: ``out`` itself when it is f32,
    else one (or, in pair mode, two) f32 planes of its shape."""
    if out.dtype == _F32:
        return [out.zero_()]
    return [torch.zeros(out.shape, dtype=_F32, device=out.device)
            for _ in range(2 if pair else 1)]


def _stored(accs, dtype, scale):
    """What the kernels store: f32 as is, int16 codes
    clip(round_half_even(acc * scale)) (``scale`` broadcast to the
    planes), complex64 re + i*im, bf16 / f16 the f32 sum rounded once to
    nearest even (no scale)."""
    if dtype == torch.int16:
        code = torch.round(accs[0] * scale)
        return torch.clamp(code, -32768.0, 32767.0).to(torch.int16)
    if dtype == torch.complex64:
        return torch.complex(accs[0], accs[1])
    if dtype in (torch.bfloat16, torch.float16):
        return accs[0].to(dtype)
    return accs[0]


def _store(accs, out, scale):
    v = _stored(accs, out.dtype,
                None if scale is None else scale.reshape(-1, 1))
    if v is not out:
        out.copy_(v)
    return out


def dense_window(d, row0=0, n_out=None) -> int:
    """The dense kernel's window over schedule ``d``: samples [row0, row0 +
    n_out), ``n_out`` defaulting to the rest of the schedule -> n_out.
    ``row0`` is a non-negative multiple of 128 (the kernel places its tiles
    from it), and the window ends at most at ``n_samples`` rounded up to
    whole 128-sample rows, as the TPU kernel's ``n_rows * 128``; anything
    else raises, never clamped."""
    row0 = int(row0)
    if row0 < 0 or row0 % 128:
        raise ValueError(f"row0 {row0} must be a non-negative multiple of "
                         "128")
    n_out = d.n_samples - row0 if n_out is None else int(n_out)
    if n_out < 0 or row0 + n_out > -(-d.n_samples // 128) * 128:
        raise ValueError(f"window [{row0}, {row0 + n_out}) is outside the "
                         f"schedule's {d.n_samples} samples (rounded up to "
                         "whole 128-sample rows)")
    return n_out


def dense_bucket0(bucket0=0) -> int:
    """The schedule bucket that bucket 0 of a schedule's descriptors holds: 0
    for a whole schedule, a time shard's first bucket for its slice of the
    bucket axis (``parallel.mesh.shard_schedule``).  A non-negative int;
    anything else raises."""
    if int(bucket0) != bucket0 or bucket0 < 0:
        raise ValueError(f"bucket0 {bucket0} must be a non-negative integer")
    return int(bucket0)


def dense_walk(d, out, scale=None, row0=0, n_out=None, bucket0=0):
    """Plain version of the dense kernel: fill ``out`` (C, n_out), f32,
    int16 (``scale`` per channel) or, in pair mode, complex64, with samples
    [row0, row0 + n_out) of DeviceSchedule ``d`` (:func:`dense_window`;
    by default the whole schedule), whose descriptors hold the schedule's
    buckets [bucket0, bucket0 + NB).

    Sample i reads local bucket ``clamp(i // bucket_samples - bucket0, 0,
    NB - 1)``; slots are added in ascending order, so each sample sums its
    segments in the bucket's lo-sorted order, as the kernel does."""
    C, NB, S, T, F = d.shape
    n_out = dense_window(d, row0, n_out)
    bucket0 = dense_bucket0(bucket0)
    if tuple(out.shape) != (C, n_out):
        raise ValueError(f"out has shape {tuple(out.shape)}, expected "
                         f"{(C, n_out)}")
    w0, w1 = int(row0), int(row0) + n_out
    dev = d.seg_lo.device
    accs = _planes(out, d.amp_im is not None)
    cc = torch.arange(C, device=dev).repeat_interleave(NB)
    bb = torch.arange(NB, device=dev).repeat(C)
    if NB > 1:
        # the first and last local buckets take the samples outside the
        # slice, as the kernel's clamp gives them
        gb = bb + bucket0
        b_lo = torch.where(bb == 0, w0,
                           torch.clamp(gb * d.bucket_samples, min=w0))
        b_hi = torch.clamp((gb + 1) * d.bucket_samples, max=w1)
        b_hi = torch.where(bb == NB - 1, w1, b_hi)
    else:
        b_lo = torch.full_like(bb, w0)
        b_hi = torch.full_like(bb, w1)
    for s in range(S):
        lo = d.seg_lo[:, :, s].reshape(-1).to(torch.int64)
        hi = d.seg_hi[:, :, s].reshape(-1).to(torch.int64)
        nt = d.nterm[:, :, s].reshape(-1)
        a = torch.maximum(lo, b_lo)
        e = torch.minimum(hi, b_hi)
        live = (nt > 0) & (e > a)
        if not bool(live.any()):
            continue
        a, e = a[live], e[live]
        _accumulate(d, accs, cc[live], bb[live], torch.full_like(a, s), a, e,
                    a - w0)
    return _store(accs, out, scale)


def _walk_items(d, accs, c, b, base, obase, s0, s1, tile, values=None,
                orow=None):
    """Walk worklist items: item r evaluates samples [base[r], base[r] +
    tile) of (channel c[r], bucket b[r]) over its segments [s0[r], s1[r])
    and adds them at output offset obase[r] of output row orow[r] (default
    c[r]); samples past the output's end are not evaluated."""
    orow = c if orow is None else orow
    C, NB, S, T, F = d.shape
    window = accs[0].shape[1]
    end = torch.minimum(base + tile, base + (window - obase))
    for kk in range(int((s1 - s0).max()) if s1.numel() else 0):
        s = s0 + kk
        m = s < s1
        sm = torch.where(m, s, 0)
        row = (c * NB + b) * S + sm
        a = torch.maximum(d.seg_lo.reshape(-1)[row].to(torch.int64), base)
        e = torch.minimum(d.seg_hi.reshape(-1)[row].to(torch.int64), end)
        live = m & (d.nterm.reshape(-1)[row] > 0) & (e > a)
        if not bool(live.any()):
            continue
        _accumulate(d, accs, c[live], b[live], sm[live], a[live], e[live],
                    (obase + a - base)[live], values, orow[live])


def panel_walk(d, work, out, scale=None):
    """Plain version of the panel kernel: zeros everywhere, and the live
    subtiles of ``work`` (a :class:`..ops.sparse_synth.PanelWork`) walked
    over their own segment ranges ``[work_s0, work_s1)``.  Fills ``out``
    (C, window_samples), f32, int16 or, in pair mode, complex64."""
    C, NB, S, T, F = d.shape
    dev = d.seg_lo.device
    accs = _planes(out, d.amp_im is not None)
    if work.n_live:
        k = torch.arange(work.n_live, device=dev)
        slot = torch.searchsorted(work.start.to(torch.int64), k,
                                  right=True) - 1
        tile = work.Rs * 128
        _walk_items(d, accs, slot // (work.n_panels * NB), slot % NB,
                    work.work_t[:work.n_live].to(torch.int64) * tile,
                    work.work_o[:work.n_live].to(torch.int64) * tile,
                    work.work_s0[:work.n_live].to(torch.int64),
                    work.work_s1[:work.n_live].to(torch.int64), tile)
    return _store(accs, out, scale)


def sparse_walk(d, work, out, scale=None):
    """Plain version of the worklist kernel: each item of ``work`` (a
    :class:`..ops.sparse_synth.SparseWork`) whose output subtile lies in
    the window evaluates its Rs x 128 subtile over its segments
    ``[work_s0, work_s1)`` and stores it into ``out`` (C, window_samples),
    f32, int16 or, in pair mode, complex64.  Nothing else of ``out`` is
    written: the caller passes it zeroed, as the kernel expects."""
    dev = d.seg_lo.device
    window = out.shape[1]
    tile = work.Rs * 128
    o = work.work_o.to(torch.int64)
    live = torch.nonzero(o < work.n_tiles).squeeze(1)
    if not live.numel():
        return out
    accs = [torch.zeros(out.shape, dtype=_F32, device=dev)
            for _ in range(2 if d.amp_im is not None else 1)]
    c = work.work_c.to(torch.int64)[live]
    obase = o[live] * tile
    _walk_items(d, accs, c, work.work_b.to(torch.int64)[live],
                work.work_t.to(torch.int64)[live] * tile, obase,
                work.work_s0.to(torch.int64)[live],
                work.work_s1.to(torch.int64)[live], tile)
    pos = (c * window + obase)[:, None] + torch.arange(tile, device=dev)
    pos = pos[(obase[:, None] + torch.arange(tile, device=dev)) < window]
    out.view(-1)[pos] = _stored([a.view(-1)[pos] for a in accs], out.dtype,
                                None if scale is None else scale[pos // window])
    return out


def _clamped(ks, K: int) -> list:
    return ks.to(torch.int64).clamp(0, K - 1).tolist()


def dense_walk_shots(t, ks, out, scale=None):
    """Plain version of the dense kernel's shot entry: ``out`` (n_shots,
    C, N) holds, at shot s, :func:`dense_walk` of schedule ``clamp(ks[s],
    0, K - 1)`` of the sequence table ``t`` (a :class:`..ops.Sequencer`,
    whose ``_schedule(k)`` is schedule k), f32, bf16, f16, int16
    (``scale`` per channel) or, in pair mode, complex64.  ``ks`` is a 1-D
    integer tensor."""
    K, C = t.seg_lo.shape[0], t.shape[0]
    if out.dim() != 3 or tuple(out.shape[1:]) != (C, t.n_samples):
        raise ValueError(f"out has shape {tuple(out.shape)}, expected "
                         f"(n_shots, {C}, {t.n_samples})")
    for s, k in enumerate(_clamped(ks, K)):
        dense_walk(t._schedule(k), out[s], scale)
    return out


def sparse_walk_shots(t, work, ks, out, scale=None):
    """Plain version of the worklist kernel's shot entry: ``out`` (n_shots,
    C, window), zeroed, receives at shot s :func:`sparse_walk` of schedule
    ``k = clamp(ks[s], 0, K - 1)`` of the sequence table ``t`` (as
    :func:`dense_walk_shots`') over row k of the stacked worklists ``work`` (a
    :class:`..ops.sparse_synth.SparseWork` whose ``work_*`` are (K, Kw))."""
    K = t.seg_lo.shape[0]
    names = ('work_c', 'work_b', 'work_t', 'work_o', 'work_s0', 'work_s1')
    for s, k in enumerate(_clamped(ks, K)):
        row = SimpleNamespace(Rs=work.Rs, n_tiles=work.n_tiles,
                              **{n: getattr(work, n)[k] for n in names})
        sparse_walk(t._schedule(k), row, out[s], scale)
    return out


def _instance_values(t, m, idx):
    """Stack instance ``m`` (per element) at sample ``idx``: the sum over
    its terms of ``amp_t * prod_f factor_f``, in the order of the JAX
    package's ``_eval_blocks`` (unmasked)."""
    nt = t.inst[:, 3][m]
    TF = t.op.shape[1]
    seg = torch.zeros(idx.shape, dtype=_F32, device=idx.device)
    f0 = torch.zeros_like(m)
    for tt in range(t.NT):
        live_t = tt < nt
        if not bool(live_t.any()):
            break
        prod = t.amp[m, tt]
        nf = t.term_nfac[m, tt].to(torch.int64)
        for k in range(int(nf.max())):
            live_f = live_t & (k < nf)
            ff = torch.where(live_f, m * TF + f0 + k, 0)
            prod = prod * _factor_values(t, ff, idx, live_f)
        seg = torch.where(live_t, prod if tt == 0 else seg + prod, seg)
        f0 = f0 + nf
    return seg


def _add_blocks(t, flat, n, j0, j1, w0=0):
    """Add blocks [j0, j1) of the instance tables ``t`` into ``flat``, the
    flat view of a (C, n) f32 plane whose column i holds sample w0 + i:
    block j adds instance ``blk_inst[j]``'s value, masked to its [lo, hi),
    over the 128 samples of row ``blk_row[j]`` of its channel, in table
    order."""
    for e0 in range(j0 * 128, j1 * 128, CHUNK):
        el = torch.arange(e0, min(e0 + CHUNK, j1 * 128), device=flat.device)
        j = el // 128
        m = t.blk_inst[j].to(torch.int64)
        idx = t.blk_row[j].to(torch.int64) * 128 + el % 128
        inst = t.inst[m].to(torch.int64)
        keep = (idx >= inst[:, 1]) & (idx < inst[:, 2])
        if not bool(keep.any()):
            continue
        vals = _instance_values(t, m[keep], idx[keep])
        flat.index_add_(0, inst[keep, 0] * n + idx[keep] - w0, vals)


def stack_eval(t, out, scale=None):
    """Plain version of the stack kernel: fill ``out`` (C, n_samples), f32
    or int16 (``scale`` per channel), with the sum of every block of the
    instance tables ``t`` (a :class:`..ops.stack_synth.StackTables`): block
    j adds instance ``blk_inst[j]``'s value, masked to its [lo, hi), over
    the 128 samples of row ``blk_row[j]`` of its channel.  Blocks are added
    in table order, as the kernel adds them per chunk."""
    accs = _planes(out, False)
    _add_blocks(t, accs[0].view(-1), out.shape[1], 0, t.n_blocks)
    return _store(accs, out, scale)


def stack_window(t, chunk0=0, n_chunks=None):
    """The sequence kernel's window over tables ``t``: chunks [chunk0,
    chunk0 + n_chunks) of every channel (``n_chunks`` defaulting to the
    rest) -> (chunk0, n_chunks, n_local), n_local the window's samples
    (it ends at the table's last sample).  A window outside the table's
    chunks raises, never clamped."""
    chunk0 = int(chunk0)
    n_chunks = t.n_chunks - chunk0 if n_chunks is None else int(n_chunks)
    if chunk0 < 0 or n_chunks < 0 or chunk0 + n_chunks > t.n_chunks:
        raise ValueError(f"chunks [{chunk0}, {chunk0 + n_chunks}) are "
                         f"outside the table's {t.n_chunks}")
    span = STACK_CHUNK_ROWS * 128
    return (chunk0, n_chunks,
            min(t.n_samples, (chunk0 + n_chunks) * span) - chunk0 * span)


def stack_seq_eval(t, ks, out, scale=None, chunk0=0, n_chunks=None):
    """Plain version of the stacked-table sequence kernel: fill ``out``
    (n_shots, C, n_local), f32 or int16 (``scale`` per channel), with
    shot s holding :func:`stack_eval` of schedule ``clamp(ks[s], 0, K-1)``
    of the stacked tables ``t`` (:class:`..ops.stack_synth.StackTables`
    whose (K, C * n_chunks + 1) ``chunk_start`` row k bounds schedule k's
    blocks), over the window :func:`stack_window` (by default the whole
    table): its samples, evaluated at their place in the schedule, go to
    columns from 0.  Each schedule that the shots play is evaluated once,
    quantized, and gathered into its shots."""
    K = t.chunk_start.shape[0]
    chunk0, n_win, n = stack_window(t, chunk0, n_chunks)
    C = t.n_channels
    if tuple(out.shape[1:]) != (C, n):
        raise ValueError(f"out has shape {tuple(out.shape)}, expected "
                         f"(n_shots, {C}, {n})")
    ks = ks.to(device=out.device, dtype=torch.int64).clamp(0, K - 1)
    pal = torch.zeros((K, C, n), dtype=_F32, device=out.device)
    for k in torch.unique(ks).tolist():
        if n == t.n_samples:               # the whole table at once
            _add_blocks(t, pal[k].view(-1), n, int(t.chunk_start[k, 0]),
                        int(t.chunk_start[k, -1]))
            continue
        cs = t.chunk_start[k].tolist()
        for c in range(C):                 # the window of each channel
            g = c * t.n_chunks + chunk0
            _add_blocks(t, pal[k].view(-1), n, cs[g], cs[g + n_win],
                        chunk0 * STACK_CHUNK_ROWS * 128)
    codes = _stored([pal], out.dtype,
                    None if scale is None else scale.reshape(1, -1, 1))
    return torch.index_select(codes, 0, ks, out=out)
