"""Plain float64 PyTorch versions of the double-tier kernels.

The JAX package's double tier (``waveforms_tpu.ops.hi_synth``) computes in
double-f32: every value a pair (hi, lo) of f32 numbers combined through
error-free transforms, because the TPU's vector unit has no f64 datapath.
The CUDA kernels of this tier (``csrc/synth_dense_hi.cu``,
``csrc/synth_panel_hi.cu``) and these plain versions compute the same
samples in native float64 instead.  Each formula of
:func:`op_builders_hi` follows the JAX ``op_builders_hi`` step by step,
with two kinds of change:

* integer steps stay as they are: the int32 carrier turns, the chirp's
  11-bit split and quadratic turns, the constant phase's ``cturns`` split
  and the quadrant reduction of ``df32.sincos_turns``;
* every df pair becomes one float64 (``args + args_lo``, ``amp + amp_lo``,
  the f64 ``ext``), and every ``df.*`` transcendental the float64 function
  on the same reduced argument (``exp``, ``sin``/``cos``, ``erf``).

The guards stay: the +-80 exp clamp, the mollifier's deep-edge zero, sinc's
``|pi x| < 1e-6``, ``sin 2x = 2 sin x cos x`` in DRAG, the drag_sin(x)
rise/flat/blend regions, negative powers, and clipping at the f32 rails
(a segment whose value rounds past a rail in f32 takes the rail exactly).

The walks are :mod:`.reference`'s, gathering in chunks of
``reference.CHUNK`` elements, which bounds the f64 temporaries at full
schedule size on the card.
"""

from __future__ import annotations

import numpy as np
import torch

from . import reference
from .lowering import (DRAG_SIN_NC, DRAG_SINX_MAXQ, OP_COS, OP_COSH, OP_DRAG,
                       OP_DRAG_SIN, OP_DRAG_SINX, OP_ERF, OP_EXP, OP_GAUSSIAN,
                       OP_LINEAR, OP_LINEARCHIRP, OP_MOLLIFIER, OP_POLY_GAUSS,
                       OP_SINC, OP_SINH, W_ARGS)
from .reference import wrap32

__all__ = ['op_builders_hi', 'dense_walk_hi', 'panel_walk_hi']

_F64 = torch.float64
_PHASE = 2 * np.pi / 2**32          # int32 turn -> radians
_TWO_PI = 2 * np.pi
_INV_TWO_PI = 1 / (2 * np.pi)
_TWO31 = float(2**31)
_EXP_CLAMP = 80.0


def _sincos_turns(turns, resid):
    """(sin, cos) of ``turns * 2pi/2^32 + resid``: the quadrant from the top
    two bits of the int32 turns, then f64 sin and cos of the remainder."""
    q = wrap32(turns + (1 << 29))
    quad = (q >> 30) & 3
    r = (q & 0x3FFFFFFF) - (1 << 29)
    x = r.to(_F64) * _PHASE + resid
    s, c = torch.sin(x), torch.cos(x)
    swap = (quad & 1) == 1
    csign = torch.where((quad == 1) | (quad == 2), -1.0, 1.0).to(_F64)
    ssign = torch.where(quad >= 2, -1.0, 1.0).to(_F64)
    return (torch.where(swap, c, s) * ssign, torch.where(swap, s, c) * csign)


def op_builders_hi(di, arg, q32, eread):
    """``{opcode: zero-arg builder}`` over one batch of elements, in f64.

    ``di`` is the int64 sample delta (idx - shift_hi, wrapped to int32);
    ``arg(k)`` the factor's f64 arg slot k (``args + args_lo``), ``q32(j)``
    its int32 phase slot j (as int64), ``eread(k)`` the f64 ext word at
    ``int(arg(7)) + k``.  The JAX function of the same name, per opcode of
    ``HI_OPS``."""
    dif = di.to(_F64)

    def u():
        return dif - arg(0)

    def x():
        return arg(1) * u()

    def exp_clamped(v):
        return torch.exp(torch.clamp(v, -_EXP_CLAMP, _EXP_CLAMP))

    def polyval_asc(v, first, count):
        acc = torch.zeros_like(v) + arg(first + count - 1)
        for k in range(count - 2, -1, -1):
            acc = acc * v + arg(first + k)
        return acc

    def carrier(eps_slot, ceps_slot):
        turns = wrap32(q32(0) * di + q32(1))
        return _sincos_turns(turns, arg(eps_slot) * dif + arg(ceps_slot))

    def op_linear():
        return x()

    def op_gaussian():
        xx = x()
        return torch.exp(torch.clamp(-(xx * xx), min=-_EXP_CLAMP))

    def op_exp():
        return exp_clamped(x())

    def op_erf():
        return torch.erf(x())

    def op_cosh():
        e = exp_clamped(x())
        return (e + 1.0 / e) * 0.5

    def op_sinh():
        e = exp_clamped(x())
        return (e - 1.0 / e) * 0.5

    def op_poly_gauss():
        xx = x()
        g = torch.exp(torch.clamp(-(xx * xx), min=-_EXP_CLAMP))
        return arg(2) * (polyval_asc(xx, 3, 9) * g)

    def op_mollifier():
        # the bump exp(1/(x^2-1) + 1) inside |x| < 1, or its d-th derivative
        # bump / (x^2-1)^(2d) * P_d(x) (d <= 3); deep-edge samples, where
        # the exp argument passes -80, are an exact 0
        xx = x()
        v = xx * xx - 1.0
        inside = v < 0
        s = torch.where(inside, v, -1.0)
        q = 1.0 / s + 1.0
        deep = q < -_EXP_CLAMP
        out = torch.exp(torch.clamp(q, min=-_EXP_CLAMP))
        d = arg(2)
        inv = 1.0 / torch.where(deep, 1.0, s * s)
        for k in (1, 2, 3):
            out = torch.where(d >= k, out * inv, out)
        out = torch.where(d > 0, out * polyval_asc(xx, 3, 9), out)
        return torch.where(inside & ~deep, out, 0.0)

    def op_cos():
        return carrier(2, 3)[1]

    def op_sinc():
        p = x() * np.pi
        small = torch.abs(p) < 1e-6
        safe = torch.where(small, 1.0, p)
        return torch.where(small, 1.0, torch.sin(safe) / safe)

    def op_linearchirp():
        # exact int32 quadratic phase, every product wrapped as it forms;
        # the residual polynomial and the constant phase in f64
        dh = di >> 11
        dl = di - (dh << 11)
        turns = wrap32(wrap32(wrap32(q32(0) * dh) * dh)
                       + wrap32(wrap32(q32(1) * dh) * dl)
                       + wrap32(wrap32(q32(2) * dl) * dl)
                       + wrap32(q32(3) * di))
        dhf, dlf = dh.to(_F64), dl.to(_F64)
        r = (arg(2) * dhf + arg(3) * dlf) * dhf
        r = r + (arg(4) * dlf) * dlf
        r = r + arg(5) * dif
        # constant phase [0, 2pi) -> int32 turns + f64 residual: the turns
        # come from the f32 rounding of phi / 2pi, as the JAX kernel takes
        # them from the hi part of its df product
        ph = arg(6)
        c = (ph * _INV_TWO_PI).to(torch.float32).to(_F64)
        ci = torch.round((c - torch.round(c)) * _TWO31).to(torch.int64)
        cturns = wrap32(ci * 2)
        cr = ph - cturns.to(_F64) * 2.0**-32 * _TWO_PI
        cr = cr - torch.round(cr * _INV_TWO_PI) * _TWO_PI
        return _sincos_turns(wrap32(turns + cturns), r + cr)[0]

    def op_drag():
        xx = x()
        sx, cx = torch.sin(xx), torch.cos(xx)
        env_x = sx * sx
        env_y = arg(5) * ((sx * cx) * 2.0)    # sin 2x = 2 sin x cos x
        sin_t, cos_t = carrier(3, 4)
        return env_x * cos_t + env_y * sin_t

    def drag_sin_like(with_blend):
        uu = u()
        lh = arg(5) * 0.5
        rl = lh + arg(6)
        rise = uu <= lh
        flat = ~rise & (uu < rl)
        ang = arg(1) * torch.where(rise, uu, uu - arg(6))
        s, c = torch.sin(ang), torch.cos(ang)
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

            def horner(base, v):
                acc = torch.zeros_like(v) + eread(base + DRAG_SINX_MAXQ - 1)
                for k in range(DRAG_SINX_MAXQ - 2, -1, -1):
                    acc = acc * v + eread(base + k)
                return acc

            stride = 1 + DRAG_SINX_MAXQ
            dl_ = uu - lh
            dr_ = uu - rl
            in_l = (-bh <= dl_) & (dl_ <= 0)
            in_r = (0 <= dr_) & (dr_ <= bh)
            ox = torch.where(in_l, horner(b0 + 2, dl_), ox)
            oy = torch.where(in_l, horner(b0 + 2 + stride, dl_), oy)
            ox = torch.where(in_r, horner(b0 + 2 + 2 * stride, dr_), ox)
            oy = torch.where(in_r, horner(b0 + 2 + 3 * stride, dr_), oy)
        sin_t, cos_t = carrier(3, 4)
        return ox * cos_t + oy * sin_t

    return {
        OP_LINEAR: op_linear,
        OP_GAUSSIAN: op_gaussian,
        OP_COS: op_cos,
        OP_EXP: op_exp,
        OP_SINC: op_sinc,
        OP_DRAG: op_drag,
        OP_LINEARCHIRP: op_linearchirp,
        OP_ERF: op_erf,
        OP_COSH: op_cosh,
        OP_SINH: op_sinh,
        OP_POLY_GAUSS: op_poly_gauss,
        OP_MOLLIFIER: op_mollifier,
        OP_DRAG_SIN: lambda: drag_sin_like(False),
        OP_DRAG_SINX: lambda: drag_sin_like(True),
    }


def _factor_values(d, ff, idx, live):
    """Factor ``ff`` (flat factor index per element) of HiSchedule ``d`` at
    sample ``idx``, raised to its power; 1.0 where ``live`` is False."""
    if idx.device.type == 'cpu':
        reference.warm_cpu_math()
    op = torch.where(live, d.op.reshape(-1)[ff], -1)
    out = torch.ones(idx.shape, dtype=_F64, device=idx.device)
    args = d.args64.reshape(-1)
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
            return d.ext64[arg(7).to(torch.int64) + k]

        v = op_builders_hi(di, arg, q, eread)[code]()
        out[m] = reference._raise_power(v, d.power.reshape(-1)[f])
    return out


def _segment_values(d, c, b, s, idx):
    """``[clip(sum_t amp_t * prod_f factor_f)]`` of slot (c, b, s) at idx,
    in f64, clipped at the channel's f32 rails: where the value rounds past
    a rail in f32, it is that rail exactly."""
    C, NB, S, T, F = d.shape
    row = (c * NB + b) * S + s
    nt = d.nterm.reshape(-1)[row]
    amp = d.amp64.reshape(-1)
    nfac = d.nfac.reshape(-1)
    seg = torch.zeros(idx.shape, dtype=_F64, device=idx.device)
    for t in range(T):
        live_t = t < nt
        if not bool(live_t.any()):
            break
        tf = row * T + t
        prod = amp[tf]
        nf = nfac[tf]
        for f in range(F):
            live_f = live_t & (f < nf)
            if not bool(live_f.any()):
                break
            prod = prod * _factor_values(d, tf * F + f, idx, live_f)
        seg = torch.where(live_t, seg + prod, seg)
    cmin = d.clip[c, 0]
    cmax = d.clip[c, 1]
    h = seg.to(torch.float32)
    seg = torch.where(h > cmax, cmax.to(_F64), seg)
    return [torch.where(h < cmin, cmin.to(_F64), seg)]


def _split_df32(x):
    """f64 -> the (hi, lo) f32 planes: ``hi = f32(x)``, ``lo = f32(x -
    hi)`` (the JAX tier's ``_combine_f64`` read backwards)."""
    hi = x.to(torch.float32)
    return hi, (x - hi.to(_F64)).to(torch.float32)


def _store_hi(acc, out, lo):
    """Store the f64 sums: into ``out`` itself (f64), or split into the f32
    planes ``out`` (hi) and ``lo``."""
    if lo is None:
        if acc is not out:
            out.copy_(acc)
        return out
    hi, low = _split_df32(acc)
    out.copy_(hi)
    lo.copy_(low)
    return out


def _acc_for(out, lo):
    return (out.zero_() if lo is None
            else torch.zeros(out.shape, dtype=_F64, device=out.device))


def dense_walk_hi(d, out, lo=None):
    """Plain version of the dense double-tier kernel: fill ``out`` (C,
    n_samples) from HiSchedule ``d``, as f64 (``lo`` None) or as the f32
    hi plane with ``lo`` the f32 lo plane.  Sample i reads bucket
    ``min(i // bucket_samples, NB - 1)`` and sums its segments in f64 in
    the bucket's lo-sorted order, as the kernel does."""
    C, NB, S, T, F = d.shape
    n = d.n_samples
    dev = d.seg_lo.device
    acc = _acc_for(out, lo)
    cc = torch.arange(C, device=dev).repeat_interleave(NB)
    bb = torch.arange(NB, device=dev).repeat(C)
    if NB > 1:
        b_lo = bb * d.bucket_samples
        b_hi = torch.clamp(b_lo + d.bucket_samples, max=n)
        b_hi = torch.where(bb == NB - 1, n, b_hi)
    else:
        b_lo = torch.zeros_like(bb)
        b_hi = torch.full_like(bb, n)
    for s in range(S):
        a = torch.maximum(d.seg_lo[:, :, s].reshape(-1).to(torch.int64), b_lo)
        e = torch.minimum(d.seg_hi[:, :, s].reshape(-1).to(torch.int64), b_hi)
        live = (d.nterm[:, :, s].reshape(-1) > 0) & (e > a)
        if not bool(live.any()):
            continue
        a, e = a[live], e[live]
        reference._accumulate(d, [acc], cc[live], bb[live],
                              torch.full_like(a, s), a, e, a,
                              _segment_values)
    return _store_hi(acc, out, lo)


def panel_walk_hi(d, work, out, lo=None):
    """Plain version of the panel double-tier kernel (one bucket): zeros
    everywhere, and the live subtiles of ``work`` (a
    :class:`.sparse_synth.PanelWork`) walked over their own segment ranges.
    Fills ``out`` (C, window_samples) as f64, or as f32 hi/lo planes."""
    if d.shape[1] != 1:
        raise ValueError("the hi panel walk takes single-bucket schedules")
    dev = d.seg_lo.device
    acc = _acc_for(out, lo)
    if work.n_live:
        k = torch.arange(work.n_live, device=dev)
        slot = torch.searchsorted(work.start.to(torch.int64), k,
                                  right=True) - 1
        tile = work.Rs * 128
        reference._walk_items(
            d, [acc], slot // work.n_panels, torch.zeros_like(slot),
            work.work_t[:work.n_live].to(torch.int64) * tile,
            work.work_o[:work.n_live].to(torch.int64) * tile,
            work.work_s0[:work.n_live].to(torch.int64),
            work.work_s1[:work.n_live].to(torch.int64), tile,
            _segment_values)
    return _store_hi(acc, out, lo)
