"""Host-side lowering: piecewise IR -> flat device descriptor arrays.

This is the compile-once production path: a multi-channel schedule lowers to
padded descriptor tensors (segments / terms / factors) that a single Pallas
kernel interprets, so *new schedules never recompile the kernel* -- only the
bucket sizes (max segments/terms/factors) key the kernel cache.

Layout (C channels, S segments, T terms, F factors, W=12 f32 args):

    seg_lo, seg_hi : i32[C, S]     segment sample-index ranges [lo, hi)
    nterm          : i32[C, S]     live terms per segment
    amp            : f32[C, S, T]  term amplitudes (real or imag part)
    nfac           : i32[C, S, T]  live factors per term
    op             : i32[C, S, T, F]   kernel opcode
    power          : i32[C, S, T, F]   small integer exponent
    shift_hi       : i32[C, S, T, F]   integer part of the factor shift, in samples
    args           : f32[C, S, T, F, W]

Numerical contract (the part that makes f32 viable at 2 GS/s x 1 ms):

* Time is carried as the **int32 sample index**; segment bounds become exact
  index ranges computed with ``np.searchsorted`` on the float64 grid -- the
  same boundary semantics as the host oracle.
* Each factor's time shift splits into ``shift_hi`` (int32 samples) plus a
  fractional f32 remainder (args[0]), so envelope arguments are computed
  from small exact integer deltas, never from large absolute times.
* Carrier (and chirp) phases are quantized to **int32 fixed-point turns**
  (2^32 == one turn): integer multiply-accumulate wraps to the exact phase
  modulo 2pi at any magnitude, and the sub-quantum residual (< pi * 2^-32
  per sample) is re-added linearly in f32 (see pallas_synth._carrier_phase).

The reference's unbuilt C engine sketches the same struct layout and
fixed-point time idea (``feihoo87/waveforms/src/waveform.h:13-81``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..core import WaveVStack
from ..ir import registry as _reg
from ..ir.algebra import ZERO

W_ARGS = 12

# Kernel opcodes (internal; independent of the registry's basis IDs).
OP_LINEAR = 0
OP_GAUSSIAN = 1
OP_ERF = 2
OP_COS = 3
OP_SINC = 4
OP_EXP = 5
OP_LINEARCHIRP = 6
OP_EXPCHIRP = 7
OP_HYPCHIRP = 8
OP_COSH = 9
OP_SINH = 10
OP_DRAG = 11
OP_POLY_GAUSS = 12
OP_MOLLIFIER = 13
# Extended opcodes read the ext side-buffer.  OP_INTERP is reserved (linear
# interpolation expands to affine segments before lowering, see
# _expand_interp); the multi-tone DRAG opcodes run on every engine.
OP_INTERP = 14
OP_DRAG_SIN = 15
OP_DRAG_SINX = 16
N_OPS = 17
PALLAS_OPS = frozenset(range(14)) | {OP_DRAG_SIN, OP_DRAG_SINX}
# fixed ext-block geometry for OP_DRAG_SIN/SINX
DRAG_SIN_MAXM = 12      # max sin-power order (m)
DRAG_SIN_NC = DRAG_SIN_MAXM + 1   # padded coefficients per quadrature
DRAG_SINX_MAXQ = 40     # padded blend-polynomial length
# SMEM budget for the ext buffer on the Pallas path (f32 words)
PALLAS_EXT_MAX = 8192
# SMEM budget for one bucket's descriptor block (bytes).  Dense schedules
# (a many-knot interp table expanding to per-knot affine segments, or
# >~50 fully-overlapping pulses whose terms all share one segment) exceed
# TPU scalar memory and crash the Mosaic compiler; such schedules stay on
# the native/XLA engines (pallas_ok=False) instead.  Empirical v5e limit:
# a 447 KB block compiles, ~1.7 MB kills the compiler -- 512 KB is the
# largest proven-safe round number.  Remedy for interp blow-up: shorter
# bucket_samples spreads knots across buckets.
PALLAS_SMEM_BUDGET = 512 * 1024


class _ExtBuf(list):
    """Ext side-buffer with a bytes-keyed dedup table.

    Identical coefficient blocks (e.g. an XY line of same-shape drag_sin
    gates at distinct phases) collapse to one shared copy; emission
    paths that receive a plain list simply skip the dedup."""

    def __init__(self):
        super().__init__()
        self.seen: dict[bytes, int] = {}


def _pallas_desc_bytes(Sb: int, T: int, F: int) -> int:
    """Bytes of one (channel, bucket) descriptor block in kernel SMEM."""
    per_segment = 3 + T * (2 + F * (7 + W_ARGS))   # i32/f32 words
    return 4 * Sb * per_segment


# Unused segment slots carry lo = hi = SEG_SENTINEL so each bucket's
# (disjoint, ascending) segment list stays sorted through padding -- the
# kernel bisects into it and early-exits past the tile (pallas_synth).
# Consumers that walk all slots skip them via nterm == 0 as before.
SEG_SENTINEL = 2**31 - 1

# descriptor format version (checkpoints carry it; load() upgrades):
#   1 -- carrier const phase as f32 radians in an arg slot
#   2 -- const phase split into int32 turns (q32 slot 1) + f32 residual
_DESC_VERSION = 2

_TWO_PI = 2 * np.pi


class UnsupportedFactor(Exception):
    """Factor has no kernel lowering; caller should use the XLA fallback."""


def _split_shift(offset_samples: float) -> tuple[int, float]:
    """Split a (possibly huge) shift in samples into int32 + small f32 frac.

    Raises :class:`UnsupportedFactor` beyond the int32 sample range
    (|shift - start| > ~1 s at 2 GS/s) rather than silently wrapping; such
    pathological factors fall back to the f64 XLA path.
    """
    hi = int(round(offset_samples))
    if not -2**31 < hi < 2**31:
        raise UnsupportedFactor(
            f"factor shift {offset_samples:.3g} samples exceeds the "
            "descriptor engines' int32 sample index range")
    return hi, float(offset_samples - hi)


def _phase_q32(dphi_rad: float) -> tuple[int, float]:
    """Quantize a per-sample phase increment to int32 fixed-point turns.

    Returns ``(q32, eps_rad)`` with ``dphi = q32 * 2pi/2^32 + eps`` and
    ``|eps| <= pi * 2^-32``; int32 multiplication by a sample delta then
    wraps to the exact phase modulo 2pi, and eps is added linearly in f32.
    """
    turns = dphi_rad / _TWO_PI
    q = round(turns * 2**32)
    eps = dphi_rad - q * (_TWO_PI / 2**32)
    q32 = ((q + 2**31) % 2**32) - 2**31
    return int(q32), float(eps)


@dataclass
class FactorDesc:
    op: int
    power: int
    shift_hi: int
    args: np.ndarray  # (W_ARGS,) float64 on the Python
    #   path (packed f32 + optional f32 lo residual), f32 from the
    #   native walker
    # int32 fixed-point phase increments (turns/2^32):
    #   [0] linear in di; [1] dh^2; [2] dh*dl; [3] dl^2  (di = dh*2^11 + dl)
    q32: tuple = (0, 0, 0, 0)


def _drag_sin_static(width, delta, block_freq, coeff_norm):
    """Host math for OP_DRAG_SIN(X): per-power coefficient vectors.

    Returns (o, C[2, m+1], flat[2]) with
    Omega_j(x) = sum_p C[j,p] * sin(o*bt)^p * (cos(o*bt) if p odd) off the
    plateau and Omega_j = flat[j] on it (cf. models/multy_drag.py).
    """
    # the model's own setup/normalization (models/multy_drag.py) IS the
    # oracle the kernel must match -- call it, never re-derive it here
    from ..models.multy_drag import _blocking_setup, _normalization
    bs, m, o, B_mat, A_mat = _blocking_setup(width, delta, block_freq)
    if m > DRAG_SIN_MAXM:
        raise UnsupportedFactor(f"drag_sin order {m} > {DRAG_SIN_MAXM}")

    C = np.einsum('ij,ip->jp', B_mat[:, :, 0], A_mat)  # (2, m+1)

    coeff = _normalization(B_mat, A_mat, m) if coeff_norm else 1.0

    # plateau: base_0 == 1, base_{p>0} == 0, and row 0 overridden to 1
    flat = (B_mat[0, :, 0]
            + B_mat[1:, :, 0].T @ A_mat[1:, 0]) / coeff
    return o, C / coeff, flat, bs, m, A_mat, B_mat


def _lower_factor(factor, power, start: float, dt: float,
                  ext: list) -> FactorDesc:
    """Lower one IR factor ``(fun_id, *args, shift)`` to a kernel descriptor.

    *ext* is the schedule's float64 side-buffer (tables, coefficient
    vectors); extended opcodes append to it and store (offset, length) in
    their arg slots.  Raises :class:`UnsupportedFactor` for bases the
    descriptor program cannot express; the schedule then falls back to the
    XLA path for that channel.
    """
    fun_id, *fargs, shift = factor
    if power != int(power):
        raise UnsupportedFactor(f"non-integer power {power}")
    power = int(power)
    if power == 0:
        # x**0 == 1 exactly, but the kernels' power unroll (fori 1..|p|)
        # and the C++ engine would evaluate it as x -- the algebra layer
        # cancels zero powers, so one can only arrive via hand-built IR;
        # fall back rather than diverge silently
        raise UnsupportedFactor("power 0 (constant factor) -- simplify "
                                "the IR first")
    a = np.zeros(W_ARGS, dtype=np.float64)

    def plain_shift():
        hi, frac = _split_shift((shift - start) / dt)
        a[0] = frac
        return hi

    if fun_id == _reg.LINEAR:
        hi = plain_shift()
        a[1] = dt
        return FactorDesc(OP_LINEAR, power, hi, a)

    if fun_id == _reg.GAUSSIAN:
        (std_sq2,) = fargs
        hi = plain_shift()
        a[1] = dt / std_sq2
        return FactorDesc(OP_GAUSSIAN, power, hi, a)

    if fun_id == _reg.ERF:
        (std_sq2,) = fargs
        hi = plain_shift()
        a[1] = dt / std_sq2
        return FactorDesc(OP_ERF, power, hi, a)

    if fun_id == _reg.COS:
        (w,) = fargs
        hi, frac = _split_shift((shift - start) / dt)
        a[0] = frac
        dphi = w * dt
        q32, eps = _phase_q32(dphi)
        a[2] = eps
        # phase at di = 0 (idx = shift_hi) is -w*dt*frac; split into int32
        # turns (q32 slot 1) + f32 residual so the kernel's total phase is
        # exactly range-reduced (host f64 split -> poly sin/cos on device)
        cq, ceps = _phase_q32(-dphi * frac)
        a[3] = ceps
        return FactorDesc(OP_COS, power, hi, a, (q32, cq, 0, 0))

    if fun_id == _reg.SINC:
        (bw,) = fargs
        hi = plain_shift()
        a[1] = bw * dt
        return FactorDesc(OP_SINC, power, hi, a)

    if fun_id == _reg.EXP:
        (alpha,) = fargs
        if isinstance(alpha, complex):
            raise UnsupportedFactor("complex exp factor")
        hi = plain_shift()
        a[1] = alpha * dt
        return FactorDesc(OP_EXP, power, hi, a)

    if fun_id == _reg.LINEARCHIRP:
        f0, f1, T, phi0 = fargs
        hi, frac = _split_shift((shift - start) / dt)
        a[0] = frac
        # phase(di) = A*(di-frac)^2 + B*(di-frac) + phi0
        #           = A*di^2 + (B - 2*A*frac)*di + const     (host f64)
        A = _TWO_PI * (f1 - f0) / (2 * T) * dt * dt
        B = _TWO_PI * f0 * dt
        # di = dh*2^11 + dl; A*di^2 = (A*2^22)*dh^2 + (A*2^12)*dh*dl + A*dl^2
        q_hh, e_hh = _phase_q32(A * 2**22)
        q_hl, e_hl = _phase_q32(A * 2**12)
        q_ll, e_ll = _phase_q32(A)
        q_lin, e_lin = _phase_q32(B - 2 * A * frac)
        a[2], a[3], a[4], a[5] = e_hh, e_hl, e_ll, e_lin
        # stored at full f64 (args_lo captures the residual for the hi
        # tier); the f32 kernel's view is identical to the old f32 cast
        a[6] = (A * frac * frac - B * frac + phi0) % _TWO_PI
        return FactorDesc(OP_LINEARCHIRP, power, hi, a,
                          (q_hh, q_hl, q_ll, q_lin))

    if fun_id == _reg.EXPONENTIALCHIRP:
        f0, alpha, phi0 = fargs
        if alpha == 0:
            # degenerate sweep endpoint: the oracle yields NaN phases
            # (0/0); route to the XLA path instead of ZeroDivisionError
            raise UnsupportedFactor("exponential chirp with alpha == 0")
        hi = plain_shift()
        a[1] = _TWO_PI * f0 / alpha
        a[2] = alpha * dt
        # full f64 (the assembly casts the kernel view to f32; storing
        # a pre-rounded value here would zero the hi tier's residual)
        a[3] = (phi0 - _TWO_PI * f0 / alpha) % _TWO_PI
        return FactorDesc(OP_EXPCHIRP, power, hi, a)

    if fun_id == _reg.HYPERBOLICCHIRP:
        f0, k, phi0 = fargs
        if k == 0:
            raise UnsupportedFactor("hyperbolic chirp with k == 0")
        hi = plain_shift()
        a[1] = _TWO_PI * f0 / k
        a[2] = k * dt
        a[3] = phi0 % _TWO_PI
        return FactorDesc(OP_HYPCHIRP, power, hi, a)

    if fun_id == _reg.COSH:
        (w,) = fargs
        hi = plain_shift()
        a[1] = w * dt
        return FactorDesc(OP_COSH, power, hi, a)

    if fun_id == _reg.SINH:
        (w,) = fargs
        hi = plain_shift()
        a[1] = w * dt
        return FactorDesc(OP_SINH, power, hi, a)

    if fun_id == _reg.DRAG:
        t0, freq, width, delta, block_freq, phase = fargs
        # envelope is a function of (t - shift - t0); carrier of (t - shift)
        hi, frac = _split_shift((shift + t0 - start) / dt)
        a[0] = frac
        o = np.pi / width
        a[1] = o * dt
        w = _TWO_PI * (freq + delta)
        q32, eps = _phase_q32(w * dt)
        a[3] = eps
        # carrier phase at idx = shift_hi (f64 host reduction):
        #   wt(idx) = w*(start + idx*dt - shift) - 2*pi*delta*t0 - phase
        # split into int32 turns (q32 slot 1) + f32 residual (see OP_COS)
        phi0 = (w * (start + hi * dt - shift)
                - _TWO_PI * delta * t0 - phase) % _TWO_PI
        cq, ceps = _phase_q32(phi0)
        a[4] = ceps
        if block_freq is None or block_freq - delta == 0:
            a[5] = 0.0
        else:
            a[5] = -o / (_TWO_PI * (block_freq - delta))
        return FactorDesc(OP_DRAG, power, hi, a, (q32, cq, 0, 0))

    if fun_id == _reg.D_GAUSSIAN:
        std_sq2, n = fargs
        if n > 8:
            raise UnsupportedFactor("hermite order > 8")
        hi = plain_shift()
        a[1] = dt / std_sq2
        a[2] = (-1) ** n / std_sq2 ** n
        coeffs = _reg.hermite_coefficients(int(n))
        a[3:3 + len(coeffs)] = coeffs[::-1]  # ascending order for the kernel
        return FactorDesc(OP_POLY_GAUSS, power, hi, a)

    if fun_id == _reg.MOLLIFIER:
        r, d = fargs
        if d > 3:
            raise UnsupportedFactor("mollifier derivative order > 3")
        hi = plain_shift()
        a[1] = dt / r
        a[2] = float(d)
        if d > 0:
            coeffs = _reg.mollifier_poly(int(d)).coeffs
            a[3:3 + len(coeffs)] = (coeffs / r ** d)[::-1]
        return FactorDesc(OP_MOLLIFIER, power, hi, a)

    # NB: INTERP factors never reach this point -- _expand_interp rewrites
    # them into affine segments before lowering (OP_INTERP stays reserved
    # for engines fed hand-built descriptors).

    try:
        from ..models.multy_drag import DRAG_SIN as _DS, DRAG_SINX as _DSX
    except ImportError:  # pragma: no cover
        _DS = _DSX = None

    if fun_id == _DS or fun_id == _DSX:
        if fun_id == _DS:
            t0, freq, width, delta, block_freq, phase, plateau = fargs
            tab = None
        else:
            t0, freq, width, delta, block_freq, phase, plateau, tab = fargs
        if isinstance(block_freq, float):
            block_freq = (block_freq,)
        o, C, flat, bs, m, A_mat, B_mat = _drag_sin_static(
            width, delta, block_freq, coeff_norm=(fun_id == _DS))

        hi, frac = _split_shift((shift + t0 - start) / dt)
        a[0] = frac
        a[1] = o * dt
        w = _TWO_PI * (freq + delta)
        q32, eps = _phase_q32(w * dt)
        a[3] = eps
        cq, ceps = _phase_q32((w * (start + hi * dt - shift)
                               - _TWO_PI * delta * t0 - phase) % _TWO_PI)
        a[4] = ceps
        a[5] = width / dt       # width in samples
        a[6] = plateau / dt     # plateau in samples
        # fixed-layout ext block:
        #   [m, cx[0..MAXM], cy[0..MAXM], flat_x, flat_y,
        #    (sinx: blend_half, {len, coeffs[MAXQ]} x4 for lx/ly/rx/ry)]
        cx = np.zeros(DRAG_SIN_NC)
        cy = np.zeros(DRAG_SIN_NC)
        cx[:m + 1] = C[0]
        cy[:m + 1] = C[1]
        block = [float(m)]
        block += cx.tolist() + cy.tolist()
        block += [float(flat[0]), float(flat[1])]

        if fun_id == _DSX:
            from ..models.multy_drag import edge_blend_poly

            def edge_rows(sign):
                x = np.sin(o * (1 + sign * tab) * width / 2) ** np.arange(
                    m + 1)
                x[1::2] = x[1::2] * np.cos(o * (1 + sign * tab) * width / 2)
                return A_mat @ x

            poly_left = edge_blend_poly(edge_rows(-1), -tab * width / 2)
            poly_right = edge_blend_poly(edge_rows(+1), tab * width / 2)
            # Q_j(dt) = sum_i B[i, j, 0] * d^i/dx^i P(dt): one polynomial
            # per quadrature per side
            def q_poly(poly, j):
                acc = np.poly1d([0.0])
                for i in range(len(bs) + 1):
                    acc = acc + B_mat[i, j, 0] * np.polyder(poly, m=i)
                c = acc.coeffs[::-1].copy()  # ascending, argument in seconds
                # rescale to sample units: Q(x_samp) = sum c_k (dt*x_samp)^k
                c *= dt ** np.arange(len(c))
                return c

            qxl = q_poly(poly_left, 0)
            qyl = q_poly(poly_left, 1)
            qxr = q_poly(poly_right, 0)
            qyr = q_poly(poly_right, 1)
            block += [tab * width / (2 * dt)]  # blend half-width in samples
            for qq in (qxl, qyl, qxr, qyr):
                if len(qq) > DRAG_SINX_MAXQ:
                    raise UnsupportedFactor(
                        f"drag_sinx blend degree {len(qq)} > {DRAG_SINX_MAXQ}")
                padded = np.zeros(DRAG_SINX_MAXQ)
                padded[:len(qq)] = qq
                block += [float(len(qq))] + padded.tolist()
        # the block depends only on (width, plateau, delta, block_freq,
        # tab) -- NOT on shift/t0/phase -- so identical blocks dedup by
        # bytes (an XY line of same-shape gates at distinct phases
        # otherwise multiplies the ext buffer past PALLAS_EXT_MAX: 64 ch
        # x 24 gates x 29 words = 44544 vs the 8192 budget).  The
        # template cache alone cannot catch this: its key includes the
        # phase argument.
        seen = getattr(ext, 'seen', None)
        key = np.asarray(block, np.float64).tobytes()
        goff = None if seen is None else seen.get(key)
        if goff is None:
            goff = len(ext)
            ext.extend(block)
            if seen is not None:
                seen[key] = goff
        a[7] = goff
        a[8] = len(block)
        op_code = OP_DRAG_SIN if fun_id == _DS else OP_DRAG_SINX
        return FactorDesc(op_code, power, hi, a, (q32, cq, 0, 0))

    raise UnsupportedFactor(f"basis id {fun_id}")


def _lower_factor_cached(factor, power, start, dt, ext, cache):
    """Template-cached factor lowering (per schedule).

    Factors that differ only in their time shift (the overwhelmingly common
    case in pulse trains) share one template; per instance only the shift
    split and the shift-dependent phase slots are recomputed, and identical
    ext blocks are emitted once.  Linear chirps fall through (their
    fixed-point decomposition mixes frac into several slots).
    """
    fun_id = factor[0]
    if fun_id == _reg.LINEARCHIRP:
        return _lower_factor(factor, power, start, dt, ext)
    key = (factor[:-1], power)
    shift = factor[-1]
    hit = cache.get(key)
    if hit is None:
        fd = _lower_factor(factor, power, start, dt, ext)
        cache[key] = (fd, shift)
        return fd
    T, shift0 = hit
    off = (T.shift_hi + float(T.args[0])) + (shift - shift0) / dt
    hi, frac = _split_shift(off)
    a = T.args.copy()
    q = T.q32
    a[0] = frac
    if T.op == OP_COS:
        dphi = factor[1] * dt
        cq, ce = _phase_q32(-dphi * frac)
        a[3] = ce
        q = (T.q32[0], cq, 0, 0)
    elif T.op in (OP_DRAG, OP_DRAG_SIN, OP_DRAG_SINX):
        freq, delta = factor[2], factor[4]
        wdt = _TWO_PI * (freq + delta) * dt
        # template const phase (turns + residual) back to f64 radians
        pc = (T.q32[1] * (_TWO_PI / 2**32) + float(T.args[4])
              + wdt * float(T.args[0])) % _TWO_PI
        cq, ce = _phase_q32((pc - wdt * frac) % _TWO_PI)
        a[4] = ce
        q = (T.q32[0], cq, 0, 0)
    return FactorDesc(T.op, T.power, hi, a, q)


@dataclass
class SegmentDesc:
    lo: int
    hi: int
    amps: list            # float amplitudes per term
    factors: list         # list[list[FactorDesc]] per term


@dataclass
class LoweredSchedule:
    """Padded descriptor tensors ready for the Pallas interpreter kernel.

    Descriptors are *time-bucketed*: the sample axis divides into
    ``n_buckets`` windows of ``bucket_samples`` each, and every bucket holds
    (copies of) exactly the segments overlapping it.  The kernel then only
    walks the segments near its tile, so per-step SMEM stays bounded no
    matter how many pulses a schedule carries (the device analog of the
    oracle's searchsorted segment windowing).  ``n_buckets == 1`` is the
    dense layout.
    """
    seg_lo: np.ndarray      # i32[C, NB, Sb]
    seg_hi: np.ndarray
    nterm: np.ndarray
    amp: np.ndarray         # f32[C, NB, Sb, T]
    nfac: np.ndarray
    op: np.ndarray          # i32[C, NB, Sb, T, F]
    power: np.ndarray
    shift_hi: np.ndarray
    q32: np.ndarray         # i32[C, NB, Sb, T, F, 4]
    args: np.ndarray        # f32[C, NB, Sb, T, F, W]
    clip_min: np.ndarray
    clip_max: np.ndarray
    n_samples: int
    start: float
    sample_rate: float
    bucket_samples: int
    ext: np.ndarray = None          # float64 side-buffer (tables, coeffs)
    amp_im: np.ndarray = None       # f32[C, NB, Sb, T]; set by part='complex'
    pallas_ok: bool = True          # all opcodes within the kernel's set
    # double-f32 residual planes (keep_f64=True lowering): args ~ args+args_lo
    # and amp ~ amp+amp_lo to f64 precision -- the hi kernel tier's inputs
    args_lo: np.ndarray = None      # f32[C, NB, Sb, T, F, W]
    amp_lo: np.ndarray = None       # f32[C, NB, Sb, T]

    @property
    def shape(self):
        return self.op.shape[:5]  # (C, NB, Sb, T, F)

    @property
    def n_buckets(self):
        return self.op.shape[1]

    def occupancy(self) -> float:
        """Fraction of samples inside a live segment (per-channel interval
        union over [lo, hi) of every nterm>0 slot; segments spanning
        several buckets appear once per bucket with the same global
        window, so the union dedups them)."""
        C = self.shape[0]
        lo = self.seg_lo.reshape(C, -1)
        hi = self.seg_hi.reshape(C, -1)
        nt = self.nterm.reshape(C, -1)
        live = 0
        for c in range(C):
            ivals = sorted(
                (max(int(a), 0), min(int(b), self.n_samples))
                for a, b, n in zip(lo[c], hi[c], nt[c]) if n > 0 and b > a)
            end = 0
            for a, b in ivals:
                if b <= end:
                    continue
                live += b - max(a, end)
                end = b
        return live / max(C * self.n_samples, 1)

    def stats(self) -> dict:
        """Observability snapshot: sizes, occupancy, memory footprints."""
        C, NB, Sb, T, F = self.shape
        live_fac = np.arange(F) < self.nfac[..., None]
        return {
            "channels": C, "n_samples": self.n_samples,
            "duration_s": self.n_samples / self.sample_rate,
            "buckets": NB, "bucket_samples": self.bucket_samples,
            "segments_padded": Sb, "terms_padded": T, "factors_padded": F,
            "live_segments": int((self.nterm > 0).sum()),
            "occupancy": round(self.occupancy(), 6),
            "opcodes": sorted(int(o) for o in np.unique(self.op[live_fac])),
            "descriptor_block_bytes": _pallas_desc_bytes(Sb, T, F),
            "ext_f64_words": 0 if self.ext is None else int(self.ext.size),
            "pair_mode": self.amp_im is not None,
            "pallas_ok": self.pallas_ok,
        }

    def describe(self) -> str:
        """One-line human-readable summary (formats :meth:`stats`)."""
        st = self.stats()
        return (f"{st['channels']} ch x {st['n_samples']} samples "
                f"({st['duration_s']:.3g} s @ {self.sample_rate:.3g} S/s), "
                f"{st['buckets']} bucket(s) x {st['segments_padded']} segs "
                f"(live {st['live_segments']}), T={st['terms_padded']} "
                f"F={st['factors_padded']}, opcodes {st['opcodes']}, "
                f"ext {st['ext_f64_words']} f64, "
                f"{'complex' if st['pair_mode'] else 'real'}, "
                f"pallas_ok={st['pallas_ok']}")

    def save(self, path) -> None:
        """Checkpoint the lowered schedule (np.savez archive).

        Lab stations re-run the same schedule across many shots and hosts;
        saving the *lowered* form skips both symbolic rebuild and lowering
        on load (the analog of the reference's wire-format transport, at
        the descriptor level).
        """
        np.savez_compressed(
            path, seg_lo=self.seg_lo, seg_hi=self.seg_hi,
            nterm=self.nterm, amp=self.amp, nfac=self.nfac, op=self.op,
            power=self.power, shift_hi=self.shift_hi, q32=self.q32,
            args=self.args, clip_min=self.clip_min, clip_max=self.clip_max,
            ext=self.ext if self.ext is not None else np.zeros(0),
            meta=np.array([self.n_samples, self.start, self.sample_rate,
                           self.bucket_samples, float(self.pallas_ok),
                           _DESC_VERSION]),
            **({'amp_im': self.amp_im} if self.amp_im is not None else {}),
            **({'args_lo': self.args_lo, 'amp_lo': self.amp_lo}
               if self.args_lo is not None else {}))

    @classmethod
    def load(cls, path) -> 'LoweredSchedule':
        z = np.load(path)
        meta = z['meta']
        out = cls(
            seg_lo=z['seg_lo'], seg_hi=z['seg_hi'], nterm=z['nterm'],
            amp=z['amp'], nfac=z['nfac'], op=z['op'], power=z['power'],
            shift_hi=z['shift_hi'], q32=z['q32'], args=z['args'],
            clip_min=z['clip_min'], clip_max=z['clip_max'],
            ext=z['ext'], n_samples=int(meta[0]), start=float(meta[1]),
            sample_rate=float(meta[2]), bucket_samples=int(meta[3]),
            amp_im=z['amp_im'] if 'amp_im' in z.files else None,
            args_lo=z['args_lo'] if 'args_lo' in z.files else None,
            amp_lo=z['amp_lo'] if 'amp_lo' in z.files else None,
            pallas_ok=bool(meta[4]))
        version = int(meta[5]) if len(meta) > 5 else 1
        if version < 2:
            out._upgrade_const_phase_v2()
        out._normalize_segment_order()
        return out

    def _upgrade_const_phase_v2(self) -> None:
        """v1 checkpoints stored carrier const phase as f32 radians in an
        arg slot; v2 splits it into int32 turns (q32 slot 1) + residual so
        the kernel's polynomial sin/cos gets an exactly range-reduced
        argument.  Exact in-place conversion."""
        for op_code, slot in ((OP_COS, 3), (OP_DRAG, 4),
                              (OP_DRAG_SIN, 4), (OP_DRAG_SINX, 4)):
            sel = self.op == op_code
            if not sel.any():
                continue
            rad = self.args[..., slot][sel].astype(np.float64)
            q = np.round(rad / _TWO_PI * 2**32)
            eps = rad - q * (_TWO_PI / 2**32)
            self.q32[..., 1][sel] = ((q.astype(np.int64) + 2**31)
                                     % 2**32 - 2**31).astype(np.int32)
            self.args[..., slot][sel] = eps.astype(np.float32)

    def _normalize_segment_order(self) -> None:
        """Re-establish the kernel's bucket-list invariant in place.

        The bisecting kernels require every (channel, bucket) segment list
        sorted by lo with SEG_SENTINEL in unused slots.  Checkpoints
        written before this invariant existed (zero-padded, piece-order
        lists) would otherwise synthesize silently wrong, so loading
        always re-normalizes -- a stable no-op for current-format files.
        """
        C, NB, Sb, T, F = self.shape
        live = self.nterm > 0                       # (C, NB, Sb)
        key_lo = np.where(live, self.seg_lo, SEG_SENTINEL)
        key_hi = np.where(live, self.seg_hi, SEG_SENTINEL)
        order = np.lexsort((key_hi.reshape(-1, Sb),
                            key_lo.reshape(-1, Sb)))  # (C*NB, Sb)
        rows = np.arange(order.shape[0])[:, None]

        def permute(arr):
            flat = arr.reshape((order.shape[0], Sb) + arr.shape[3:])
            arr[...] = flat[rows, order].reshape(arr.shape)

        for name in ('seg_lo', 'seg_hi', 'nterm', 'amp', 'nfac', 'op',
                     'power', 'shift_hi', 'q32', 'args'):
            permute(getattr(self, name))
        for opt in (self.amp_im, self.args_lo, self.amp_lo):
            if opt is not None:
                permute(opt)
        dead = ~(self.nterm > 0)
        self.seg_lo[dead] = SEG_SENTINEL
        self.seg_hi[dead] = SEG_SENTINEL


def _waveform_pieces(wav):
    """Yield (bounds, seq, vmin, vmax) pieces of a Waveform or WaveVStack."""
    if isinstance(wav, WaveVStack):
        if wav.shift != 0:
            # bake the scalar delay into each component in O(N): a full
            # simplify() here would wave_sum-merge all components into
            # one segment with N terms -- T explodes and pallas_ok flips
            # False for exactly the common 'delayed schedule' case
            wav = wav._spawn(WaveVStack._baked(wav.wlist, wav.shift),
                             offset=wav.offset)
        if wav.offset != 0:
            from ..ir.algebra import const as _cst
            yield (np.inf,), (_cst(complex(wav.offset)),), -np.inf, np.inf
        for bounds, seq in wav.wlist:
            yield bounds, seq, -np.inf, np.inf
        return
    yield wav.bounds, wav.seq, wav.min, wav.max


def _interp_affine(factor, k):
    """IR expression for knot interval k of a linear-interp factor.

    ``k < 0`` / ``k >= n-1`` give the clamped end values (np.interp
    semantics); interior intervals give ``y_k + m_k*((t-s) - x_k)``.
    """
    from ..ir.algebra import add as _add, const as _cst
    _, xstart, xstop, points, s = (None, *factor[1:])
    pts = np.asarray(points, dtype=float)
    n = len(pts)
    if n < 2:        # degenerate table: np.interp returns the constant
        return _cst(float(pts[0]) if n else 0.0)
    step = (xstop - xstart) / (n - 1)
    if k < 0:
        return _cst(float(pts[0]))
    if k >= n - 1:
        return _cst(float(pts[-1]))
    x_k = xstart + k * step
    m = (pts[k + 1] - pts[k]) / step
    if m == 0:
        return _cst(float(pts[k]))
    return _add(_cst(float(pts[k] - m * x_k)),
                (((((_reg.LINEAR, s),), (1,)),), (m,)))


def _expand_interp(bounds, seq):
    """Rewrite INTERP factors into exact per-knot affine segments.

    Linear interpolation IS piecewise-linear, so it lowers losslessly onto
    the IR's own piecewise structure: each segment containing an INTERP
    factor splits at the table knots, and within each piece the factor
    becomes an affine (or clamped constant) expression.  No descriptor
    engine needs a table gather.
    """
    from ..ir.algebra import add as _add, mul as _mul, pow as _pow
    if not any(f[0] == _reg.INTERP
               for expr in seq if expr != ZERO
               for term in expr[0] for f in term[0]):
        return bounds, seq

    new_bounds: list = []
    new_seq: list = []
    lo = -np.inf
    for b, expr in zip(bounds, seq):
        knots: set = set()
        if expr != ZERO:
            for term in expr[0]:
                for f in term[0]:
                    if f[0] == _reg.INTERP:
                        _, xstart, xstop, points, s = (None, *f[1:])
                        n = len(points)
                        if n < 2:   # constant table: no knots to insert
                            continue
                        step = (xstop - xstart) / (n - 1)
                        for k in range(n):
                            x = s + xstart + k * step
                            if lo < x < b:
                                knots.add(x)
        pieces = sorted(knots) + [b]
        piece_lo = lo
        for piece_hi in pieces:
            if expr == ZERO:
                sub = ZERO
            else:
                sub = ZERO
                for term, v in zip(*expr):
                    if v == 0:
                        continue
                    piece = ((((), ()),), (v,))
                    for f, nn in zip(*term):
                        if f[0] == _reg.INTERP:
                            _, xstart, xstop, points, s = (None, *f[1:])
                            n = len(points)
                            if n < 2:
                                k = 0   # _interp_affine: constant table
                                step = 1.0
                            # the piece lies within one knot interval of
                            # f: index by the piece MIDPOINT when both
                            # edges are finite -- edge-based floor is one
                            # ulp from a knot and can off-by-one at large
                            # |s| (a 1-ulp sliver would then carry the
                            # neighbor interval's slope)
                            elif piece_lo != -np.inf and piece_hi != np.inf:
                                step = (xstop - xstart) / (n - 1)
                                k = int(np.floor(
                                    (0.5 * (piece_lo + piece_hi)
                                     - s - xstart) / step))
                            else:
                                # semi-infinite piece: one finite edge,
                                # usually AT a knot -- snap near-integer
                                # ratios before floor/ceil so ulp noise
                                # at large |s| can't off-by-one (the
                                # trailing clamp piece would otherwise
                                # extrapolate an interior slope)
                                step = (xstop - xstart) / (n - 1)
                                if piece_lo != -np.inf:
                                    r = (piece_lo - s - xstart) / step
                                    k = (int(round(r))
                                         if abs(r - round(r)) < 1e-6
                                         else int(np.floor(r)))
                                else:
                                    r = (piece_hi - s - xstart) / step
                                    k = (int(round(r))
                                         if abs(r - round(r)) < 1e-6
                                         else int(np.ceil(r))) - 1
                            fac_expr = _interp_affine(f, k)
                            piece = _mul(piece, _pow(fac_expr, nn)
                                         if nn != 1 else fac_expr)
                        else:
                            piece = _mul(piece, ((((f,), (nn,)),), (1.0,)))
                    sub = _add(sub, piece)
            if new_seq and sub == new_seq[-1]:
                new_bounds[-1] = piece_hi
            else:
                new_bounds.append(piece_hi)
                new_seq.append(sub)
            piece_lo = piece_hi
        lo = b
    return tuple(new_bounds), tuple(new_seq)


# -- exotic-chirp windowing ------------------------------------------------
#
# Exponential/hyperbolic chirp phases are transcendental in t, so a direct
# f32 kernel evaluation carries the full accumulated phase (1e3..1e4 rad)
# through f32 exp/log -- a ~1e-4 output-accuracy tier.  Instead of a
# double-f32 transcendental path, the schedule lowers them the same way it
# lowers interp tables: rewrite at lowering time into adaptively-sized time
# windows whose phase is an f64-fit quadratic, each emitted as a standard
# LINEARCHIRP factor.  Quadratic phase is the one thing the descriptor
# engines evaluate EXACTLY (int32 fixed-point, wraps mod 2pi), so the only
# residual error is the fit tolerance below plus the usual f32 eps slots.

_CHIRP_TOL = 3e-8           # rad; max |quadratic fit - true phase| / window
# hi-tier (keep_f64) fit tolerance: the 1e-9 output contract needs the
# phase fit under ~1e-9 rad.  err ~ h^3, so 60x tighter costs ~60^(1/3) =
# 3.9x the windows.  f64 evaluation of the phase itself floors the
# achievable fit near eps * |phi| -- schedules accumulating >~1e6 rad of
# absolute phase saturate at that floor (documented in docs/PRECISION.md).
_CHIRP_TOL_HI = 5e-10
_CHIRP_MAX_WINDOWS = 4096   # per factor per segment (adaptive-split cap)


def _chirp_phase_fn(f):
    """f64 phase of an exotic-chirp factor as a function of absolute time."""
    if f[0] == _reg.EXPONENTIALCHIRP:
        _, f0, alpha, phi0, s = f
        return lambda t: phi0 + _TWO_PI * f0 * np.expm1(alpha * (t - s)) \
            / alpha
    _, f0, k, phi0, s = f

    def phase(t):
        with np.errstate(invalid='ignore', divide='ignore'):
            return phi0 + _TWO_PI * f0 / k * np.log1p(k * (t - s))
    return phase


def _quad_fit_vec(phi, was, wbs):
    """3-point quadratic phase fits on windows [wa, wb), vectorized.

    Returns (A, B, C, err): phase(wa + u) ~ A*u^2 + B*u + C with err the
    max deviation over 9 probe points per window.
    """
    was = np.asarray(was, float)
    h = np.asarray(wbs, float) - was
    u = np.linspace(0.0, 1.0, 9)[:, None] * h          # (9, N)
    y = phi(was + u)
    A = 2.0 * (y[8] - 2.0 * y[4] + y[0]) / (h * h)
    B = (4.0 * y[4] - 3.0 * y[0] - y[8]) / h
    C = y[0]
    err = np.max(np.abs(A * u * u + B * u + C - y), axis=0)
    return A, B, C, err


def _chirp_windows(phi, a, b, dt, tol=_CHIRP_TOL):
    """Adaptive window boundaries on [a, b): bisect until the quadratic
    fit meets ``tol`` (or the window is <= 2 samples / the cap hits).

    The window cap scales with the tolerance (err ~ h^3, so a k-times
    tighter fit needs ~k^(1/3) more windows): the hi tier's 5e-10 rad
    fit gets the same effective coverage the default cap gives 3e-8."""
    cap = _CHIRP_MAX_WINDOWS
    if tol < _CHIRP_TOL:
        cap = int(np.ceil(cap * (_CHIRP_TOL / tol) ** (1 / 3)))
    out = []
    stack = [(a, b)]
    capped = False
    while stack:
        wa, wb = stack.pop()
        _, _, _, err = _quad_fit_vec(phi, [wa], [wb])
        if (err[0] <= tol or not np.isfinite(err[0])
                or wb - wa <= 2 * dt
                or len(out) + len(stack) >= cap):
            capped = capped or (err[0] > tol and np.isfinite(err[0])
                                and len(out) + len(stack)
                                >= cap)
            out.append(wa)
        else:
            mid = 0.5 * (wa + wb)
            stack.append((mid, wb))
            stack.append((wa, mid))
    if capped:
        import warnings
        warnings.warn(
            f"exotic-chirp windowing hit the {cap}-window "
            "cap; residual phase error exceeds the fit tolerance on some "
            "windows (use the xla engine for exact synthesis)")
    return out  # ascending window starts; windows end at the next start / b


def _expand_exotic_chirps(bounds, seq, t_lo, t_hi, dt, tol=_CHIRP_TOL):
    """Rewrite exp/hyperbolic chirp factors into quadratic-phase windows.

    Each factor instance splits the portion of its segment inside the
    synthesis range [t_lo, t_hi) into windows carrying an exact-quadratic
    LINEARCHIRP replacement; portions outside the range (never sampled)
    keep the original factor.  Windows whose phase is non-finite (outside
    a hyperbolic chirp's domain) also keep the original factor, preserving
    reference NaN semantics.
    """
    from ..ir.algebra import add as _add, mul as _mul
    ids = (_reg.EXPONENTIALCHIRP, _reg.HYPERBOLICCHIRP)
    if t_hi <= t_lo or not any(
            f[0] in ids for expr in seq if expr != ZERO
            for term in expr[0] for f in term[0]):
        return bounds, seq

    new_bounds: list = []
    new_seq: list = []

    def emit(hi, sub):
        if new_seq and sub == new_seq[-1]:
            new_bounds[-1] = hi
        else:
            new_bounds.append(hi)
            new_seq.append(sub)

    lo = -np.inf
    for b, expr in zip(bounds, seq):
        facs = ([f for term in expr[0] for f in term[0] if f[0] in ids]
                if expr != ZERO else [])
        wa0, wb0 = max(lo, t_lo), min(b, t_hi)
        if not facs or wb0 <= wa0:
            emit(b, expr)
            lo = b
            continue

        cuts: set = set()
        fits: dict = {}
        for f in set(facs):
            phi = _chirp_phase_fn(f)
            starts = _chirp_windows(phi, wa0, wb0, dt, tol)
            fits[f] = phi
            cuts.update(starts[1:])
        if wa0 > lo:
            cuts.add(wa0)
        if wb0 < b:
            cuts.add(wb0)
        pieces = sorted(x for x in cuts if lo < x < b) + [b]

        # vectorized refit of every factor on the final window grid
        inner = [(p_lo, p_hi) for p_lo, p_hi in
                 zip([lo] + pieces[:-1], pieces)
                 if p_lo >= wa0 and p_hi <= wb0]
        refit = {}
        if inner:
            was = [w[0] for w in inner]
            wbs = [w[1] for w in inner]
            for f, phi in fits.items():
                refit[f] = dict(zip(was, zip(*_quad_fit_vec(phi, was, wbs))))

        piece_lo = lo
        for piece_hi in pieces:
            in_range = piece_lo >= wa0 and piece_hi <= wb0
            if not in_range or expr == ZERO:
                emit(piece_hi, expr)
                piece_lo = piece_hi
                continue
            sub = ZERO
            for term, v in zip(*expr):
                if v == 0:
                    continue
                piece = ((((), ()),), (v,))
                for f, nn in zip(*term):
                    if f[0] in ids:
                        A, B, C, err = refit[f][piece_lo]
                        if np.isfinite(err):
                            T = piece_hi - piece_lo
                            f0L = B / _TWO_PI
                            f1L = f0L + A * T / np.pi
                            f = (_reg.LINEARCHIRP, float(f0L), float(f1L),
                                 float(T), float(C), float(piece_lo))
                    piece = _mul(piece, ((((f,), (nn,)),), (1.0,)))
                sub = _add(sub, piece)
            emit(piece_hi, sub)
            piece_lo = piece_hi
        lo = b
    return tuple(new_bounds), tuple(new_seq)


def lower_channel(wav, grid: np.ndarray, start: float, dt: float,
                  part: str = 'real',
                  ext: list | None = None,
                  cache: dict | None = None,
                  pieces=None,
                  chirp_tol: float = _CHIRP_TOL,
                  ) -> tuple[list[SegmentDesc], float, float]:
    """Lower one channel; returns its segment descriptors and clip limits.

    ``part`` selects the real or imaginary component of complex amplitudes
    (factors themselves are always real-valued).  ``pieces`` supplies
    ALREADY-EXPANDED ``(bounds, seq, vmin, vmax)`` tuples so the native
    path's fallback does not re-run the interp/chirp expansions (the
    adaptive chirp windowing is the expensive part)."""
    if ext is None:
        ext = []
    if cache is None:
        cache = {}
    segments: list[SegmentDesc] = []
    vmin, vmax = -np.inf, np.inf

    def expanded():
        if pieces is not None:
            yield from pieces
            return
        for bounds, seq, bmin, bmax in _waveform_pieces(wav):
            bounds, seq = _expand_interp(bounds, seq)
            if len(grid):
                bounds, seq = _expand_exotic_chirps(bounds, seq, grid[0],
                                                    grid[-1] + dt, dt,
                                                    chirp_tol)
            yield bounds, seq, bmin, bmax

    for bounds, seq, bmin, bmax in expanded():
        vmin, vmax = bmin, bmax
        edges = np.searchsorted(grid, np.asarray(bounds, dtype=float))
        lo = 0
        for hi, expr in zip(edges, seq):
            if lo < hi and expr != ZERO:
                amps, facs = [], []
                for (factors, powers), v in zip(*expr):
                    v = complex(v)
                    if part == 'complex':
                        amp = v
                    else:
                        amp = v.real if part == 'real' else v.imag
                    if amp == 0:
                        continue
                    amps.append(amp)
                    facs.append([
                        _lower_factor_cached(f, n, start, dt, ext, cache)
                        for f, n in zip(factors, powers)
                    ])
                if amps:
                    segments.append(SegmentDesc(int(lo), int(hi), amps, facs))
            lo = hi
    return segments, vmin, vmax


def lower_schedule(channels, start: float, stop: float, sample_rate: float,
                   part: str = 'real',
                   pad_to: tuple[int, int, int] | None = None,
                   bucket_samples='auto',
                   keep_f64: bool = False) -> LoweredSchedule:
    """Lower a list of channels into padded, time-bucketed descriptors.

    ``bucket_samples`` sets the time-window size: None = one bucket
    spanning everything, 'auto' picks a window once segment counts are
    known (many-pulse schedules get short per-tile walks), an int sets it
    explicitly (must be a multiple of the synthesis tile,
    rows_per_tile * 128).  ``pad_to = (Sb, T, F)`` overrides bucket sizes
    to stabilize the kernel cache across similar schedules.

    ``keep_f64=True`` additionally packs double-f32 residual planes
    (``args_lo``, ``amp_lo``) for the kernels' high-precision tier; it
    forces the Python lowering path (the native walker emits f32 args).
    """
    dt = 1.0 / sample_rate
    grid = np.arange(start, stop, dt)
    n = len(grid)

    def resolve_bucket(max_segments):
        if bucket_samples == 'auto':
            # worth bucketing when a channel's segment list is long enough
            # that per-tile walks would dominate; window ~16 tiles for long
            # schedules, ~2 tiles for mid-size dense ones (e.g. windowed
            # exotic chirps)
            if max_segments > 48 and n > 65536:
                return 32768, max(-(-n // 32768), 1)
            if max_segments > 48 and n > 8192:
                return 4096, max(-(-n // 4096), 1)
            return max(n, 1), 1
        if bucket_samples is None:
            return max(n, 1), 1
        return bucket_samples, max(-(-n // bucket_samples), 1)

    # the native (C++) walker lowers channels directly to flat arrays
    # (channels with bases it declines lower on the Python path into the
    # same vectorized assembly); it builds at first use and raises if it
    # cannot
    ext = _ExtBuf()
    cache: dict = {}
    # the native walker emits real f32 amplitudes; part='complex' (fused
    # re/im synthesis) lowers on the Python path with complex amps
    flat = (None if part == 'complex' or keep_f64 else
            _lower_schedule_native(channels, grid, start, dt, part, ext,
                                   cache))
    if flat is not None:
        max_seg = max((len(res[0]) for res, _, _ in flat), default=0)
        bs, NB = resolve_bucket(max_seg)
        return _assemble_from_flat(flat, n, NB, bs, start,
                                   sample_rate, pad_to,
                                   np.asarray(ext, dtype=np.float64))

    # keep_f64 (hi tier) tightens the exotic-chirp fit so the expanded
    # quadratic windows stay within the 1e-9 output contract
    lowered = [lower_channel(ch, grid, start, dt, part, ext, cache,
                             chirp_tol=(_CHIRP_TOL_HI if keep_f64
                                        else _CHIRP_TOL))
               for ch in channels]
    C = len(lowered)
    bucket_samples, NB = resolve_bucket(
        max((len(segs) for segs, _, _ in lowered), default=0))

    # distribute segments into every bucket they overlap
    buckets: list[list[list[SegmentDesc]]] = [
        [[] for _ in range(NB)] for _ in range(C)]
    for c, (segs, _, _) in enumerate(lowered):
        for seg in segs:
            b0 = seg.lo // bucket_samples
            b1 = -(-seg.hi // bucket_samples)
            for b in range(max(b0, 0), min(b1, NB)):
                buckets[c][b].append(seg)
    # each bucket's list sorted by lo: the kernel bisects into it (stack
    # channels emit overlapping per-component segments in piece order)
    for bc in buckets:
        for bl in bc:
            bl.sort(key=lambda s: (s.lo, s.hi))

    Sb = max((len(bl) for bc in buckets for bl in bc), default=1)
    T = max((len(s.amps) for segs, _, _ in lowered for s in segs), default=1)
    F = max((len(fl) for segs, _, _ in lowered for s in segs
             for fl in s.factors), default=1)
    Sb, T, F = max(Sb, 1), max(T, 1), max(F, 1)
    if F > 32:
        raise UnsupportedFactor(
            f"{F} factors in one term exceeds the engines' limit (32); "
            "simplify() the waveform first")
    if pad_to is not None:
        if pad_to[0] < Sb or pad_to[1] < T or pad_to[2] < F:
            raise ValueError(f"pad_to {pad_to} smaller than required "
                             f"{(Sb, T, F)}")
        Sb, T, F = pad_to

    out = LoweredSchedule(
        seg_lo=np.full((C, NB, Sb), SEG_SENTINEL, np.int32),
        seg_hi=np.full((C, NB, Sb), SEG_SENTINEL, np.int32),
        nterm=np.zeros((C, NB, Sb), np.int32),
        amp=np.zeros((C, NB, Sb, T), np.float32),
        nfac=np.zeros((C, NB, Sb, T), np.int32),
        op=np.zeros((C, NB, Sb, T, F), np.int32),
        power=np.ones((C, NB, Sb, T, F), np.int32),
        shift_hi=np.zeros((C, NB, Sb, T, F), np.int32),
        q32=np.zeros((C, NB, Sb, T, F, 4), np.int32),
        args=np.zeros((C, NB, Sb, T, F, W_ARGS), np.float32),
        clip_min=np.full((C,), -np.inf, np.float32),
        clip_max=np.full((C,), np.inf, np.float32),
        n_samples=n, start=start, sample_rate=sample_rate,
        bucket_samples=bucket_samples,
        ext=np.asarray(ext, dtype=np.float64),
        amp_im=(np.zeros((C, NB, Sb, T), np.float32)
                if part == 'complex' else None),
    )

    # vectorized scatter fill: collect flat index/value lists, assign once
    si, sv = [], []            # segment rows: (c, b, s) -> lo, hi, nterm
    ti, tv = [], []            # term rows: amp, nfac
    fi = []                    # factor rows
    f_op, f_pw, f_sh, f_q32, f_args = [], [], [], [], []
    for c, (segs, vmin, vmax) in enumerate(lowered):
        out.clip_min[c] = vmin
        out.clip_max[c] = vmax
        for b in range(NB):
            for s, seg in enumerate(buckets[c][b]):
                si.append((c, b, s))
                sv.append((seg.lo, seg.hi, len(seg.amps)))
                for t, (amp, facs) in enumerate(zip(seg.amps, seg.factors)):
                    ti.append((c, b, s, t))
                    tv.append((amp, len(facs)))
                    for f, fd in enumerate(facs):
                        fi.append((c, b, s, t, f))
                        f_op.append(fd.op)
                        f_pw.append(fd.power)
                        f_sh.append(fd.shift_hi)
                        f_q32.append(fd.q32)
                        f_args.append(fd.args)
    if si:
        ci, bi, sj = np.array(si, np.intp).T
        svv = np.array(sv)
        out.seg_lo[ci, bi, sj] = svv[:, 0]
        out.seg_hi[ci, bi, sj] = svv[:, 1]
        out.nterm[ci, bi, sj] = svv[:, 2]
    if keep_f64:
        out.args_lo = np.zeros_like(out.args)
        out.amp_lo = np.zeros_like(out.amp)
    if ti:
        ci, bi, sj, tj = np.array(ti, np.intp).T
        tvv = np.array(tv)
        out.amp[ci, bi, sj, tj] = tvv[:, 0].real
        if out.amp_lo is not None:
            a64 = tvv[:, 0].real
            out.amp_lo[ci, bi, sj, tj] = (a64 - a64.astype(np.float32)
                                          ).astype(np.float32)
        if out.amp_im is not None:
            out.amp_im[ci, bi, sj, tj] = tvv[:, 0].imag
        out.nfac[ci, bi, sj, tj] = tvv[:, 1].real.astype(np.int32)
    if fi:
        ci, bi, sj, tj, fj = np.array(fi, np.intp).T
        out.op[ci, bi, sj, tj, fj] = f_op
        out.power[ci, bi, sj, tj, fj] = f_pw
        out.shift_hi[ci, bi, sj, tj, fj] = f_sh
        out.q32[ci, bi, sj, tj, fj] = np.array(f_q32, np.int64).astype(
            np.int32)
        a64 = np.stack(f_args)
        out.args[ci, bi, sj, tj, fj] = a64
        if out.args_lo is not None:
            out.args_lo[ci, bi, sj, tj, fj] = (
                a64 - a64.astype(np.float32)).astype(np.float32)
    out.pallas_ok = bool(np.all(np.isin(out.op, list(PALLAS_OPS)))
                         and len(ext) <= PALLAS_EXT_MAX
                         and _pallas_desc_bytes(Sb, T, F)
                         <= PALLAS_SMEM_BUDGET)
    return out


def _segments_to_flat(segments):
    """Convert Python-path SegmentDescs to the native walker's flat form."""
    seg_lo = np.array([s.lo for s in segments], np.int64)
    seg_hi = np.array([s.hi for s in segments], np.int64)
    seg_nt = np.array([len(s.amps) for s in segments], np.int32)
    amps, nfac = [], []
    f_op, f_pw, f_sh, f_q, f_a = [], [], [], [], []
    for s in segments:
        for amp, facs in zip(s.amps, s.factors):
            amps.append(amp)
            nfac.append(len(facs))
            for fd in facs:
                f_op.append(fd.op)
                f_pw.append(fd.power)
                f_sh.append(fd.shift_hi)
                f_q.append(fd.q32)
                f_a.append(fd.args)
    return (seg_lo, seg_hi, seg_nt,
            np.array(amps, np.float32), np.array(nfac, np.int32),
            np.array(f_op, np.int32), np.array(f_pw, np.int32),
            np.array(f_sh, np.int32),
            (np.array(f_q, np.int64).astype(np.int32)
             if f_q else np.zeros((0, 4), np.int32)),
            (np.stack(f_a).astype(np.float32)
             if f_a else np.zeros((0, W_ARGS), np.float32)))


def _merge_channel_ext(res, ext, ext_seen):
    """Rebase a native channel's local ext blocks into the shared buffer.

    The native walker emits channel-local (offset, length) pairs in
    args[:, 7:9] of extended-opcode rows; identical blocks across channels
    collapse to one shared copy (keyed on the block's f64 bytes).
    """
    ch_ext = res[10]
    res = res[:10]
    if ch_ext.size == 0:
        return res
    f_op, f_a = res[5], res[9].copy()
    mask = np.flatnonzero((f_op == OP_DRAG_SIN) | (f_op == OP_DRAG_SINX))
    for i in mask:
        off, ln = int(f_a[i, 7]), int(f_a[i, 8])
        block = ch_ext[off:off + ln]
        key = block.tobytes()
        goff = ext_seen.get(key)
        if goff is None:
            goff = len(ext)
            ext.extend(block.tolist())
            ext_seen[key] = goff
        f_a[i, 7] = goff
    return res[:9] + (f_a,)


def _lower_schedule_native(channels, grid, start, dt, part, ext, cache):
    """Flat-array lowering of all channels (native walker where possible).

    Channels outside the walker's basis set lower on the Python path and
    convert to the same flat form, so the vectorized assembly always runs.
    Raises RuntimeError when the walker does not build.
    """
    from ..native import lower_channel_flat
    want_imag = 1 if part == 'imag' else 0
    # share the dedup table with the Python emission path (_ExtBuf.seen)
    # so blocks entered by either path collapse to one copy
    ext_seen = getattr(ext, 'seen', None)
    if ext_seen is None:
        ext_seen = {}
    flat = []
    for ch in channels:
        pieces = []
        pieces4 = []
        vmin, vmax = -np.inf, np.inf
        for bounds, seq, bmin, bmax in _waveform_pieces(ch):
            vmin, vmax = bmin, bmax
            bounds, seq = _expand_interp(bounds, seq)
            if len(grid):
                bounds, seq = _expand_exotic_chirps(bounds, seq, grid[0],
                                                    grid[-1] + dt, dt)
            pieces.append((bounds, seq))
            pieces4.append((bounds, seq, bmin, bmax))
        res = lower_channel_flat(pieces, grid, start, dt, want_imag)
        if res is None:
            # reuse the expansion above -- re-running the adaptive chirp
            # windowing doubled lowering time for fallback channels
            segments, vmin, vmax = lower_channel(ch, grid, start, dt, part,
                                                 ext, cache,
                                                 pieces=pieces4)
            res = _segments_to_flat(segments)
        else:
            res = _merge_channel_ext(res, ext, ext_seen)
        flat.append((res, vmin, vmax))
    return flat


def _grouped_arange(counts):
    """[0..c0-1, 0..c1-1, ...] for counts c_i (vectorized intra-indices)."""
    counts = np.asarray(counts, np.intp)
    total = int(counts.sum())
    if total == 0:
        return np.zeros(0, np.intp)
    starts = np.zeros(len(counts), np.intp)
    np.cumsum(counts[:-1], out=starts[1:])
    return np.arange(total, dtype=np.intp) - np.repeat(starts, counts)


def _assemble_from_flat(flat, n, NB, bucket_samples, start, sample_rate,
                        pad_to, ext=None):
    """Bucket + pad flat per-channel descriptor arrays (all vectorized)."""
    C = len(flat)

    # per-channel bucket expansion (segments replicated per bucket window)
    expanded = []
    Sb = T = F = 1
    for res, _, _ in flat:
        seg_lo, seg_hi, seg_nt, t_amp, t_nf = res[:5]
        ns = len(seg_lo)
        if ns == 0:
            expanded.append(None)
            continue
        b0 = np.maximum(seg_lo // bucket_samples, 0)
        b1 = np.minimum(-(-seg_hi // bucket_samples), NB)
        reps = np.maximum(b1 - b0, 1).astype(np.intp)
        row_seg = np.repeat(np.arange(ns, dtype=np.intp), reps)
        row_b = np.repeat(b0, reps).astype(np.intp) + _grouped_arange(reps)
        # slot index: lo-sorted within each bucket (the kernel bisects;
        # stack channels emit overlapping segments out of order)
        order = np.lexsort((seg_hi[row_seg], seg_lo[row_seg], row_b))
        sorted_b = row_b[order]
        new_group = np.flatnonzero(np.diff(sorted_b)) + 1
        starts = np.concatenate([[0], new_group])
        counts = np.diff(np.concatenate([starts, [len(sorted_b)]]))
        slot_sorted = _grouped_arange(counts)
        slot = np.empty(len(row_b), np.intp)
        slot[order] = slot_sorted
        expanded.append((row_seg, row_b, slot))
        if len(slot):
            Sb = max(Sb, int(slot.max()) + 1)
        if ns:
            T = max(T, int(seg_nt.max()))
        if len(t_nf):
            F = max(F, int(t_nf.max()))
    if F > 32:
        raise UnsupportedFactor(
            f"{F} factors in one term exceeds the engines' limit (32); "
            "simplify() the waveform first")
    if pad_to is not None:
        if pad_to[0] < Sb or pad_to[1] < T or pad_to[2] < F:
            raise ValueError(f"pad_to {pad_to} smaller than required "
                             f"{(Sb, T, F)}")
        Sb, T, F = pad_to

    out = LoweredSchedule(
        seg_lo=np.full((C, NB, Sb), SEG_SENTINEL, np.int32),
        seg_hi=np.full((C, NB, Sb), SEG_SENTINEL, np.int32),
        nterm=np.zeros((C, NB, Sb), np.int32),
        amp=np.zeros((C, NB, Sb, T), np.float32),
        nfac=np.zeros((C, NB, Sb, T), np.int32),
        op=np.zeros((C, NB, Sb, T, F), np.int32),
        power=np.ones((C, NB, Sb, T, F), np.int32),
        shift_hi=np.zeros((C, NB, Sb, T, F), np.int32),
        q32=np.zeros((C, NB, Sb, T, F, 4), np.int32),
        args=np.zeros((C, NB, Sb, T, F, W_ARGS), np.float32),
        clip_min=np.full((C,), -np.inf, np.float32),
        clip_max=np.full((C,), np.inf, np.float32),
        n_samples=n, start=start, sample_rate=sample_rate,
        bucket_samples=bucket_samples,
        ext=(ext if ext is not None else np.zeros(0, dtype=np.float64)),
    )

    for c, ((res, vmin, vmax), exp) in enumerate(zip(flat, expanded)):
        out.clip_min[c] = vmin
        out.clip_max[c] = vmax
        if exp is None:
            continue
        seg_lo, seg_hi, seg_nt, t_amp, t_nf, f_op, f_pw, f_sh, f_q, f_a = res
        row_seg, row_b, slot = exp

        seg_t0 = np.zeros(len(seg_lo), np.intp)
        np.cumsum(seg_nt[:-1], out=seg_t0[1:])
        term_f0 = np.zeros(len(t_nf), np.intp)
        np.cumsum(t_nf[:-1], out=term_f0[1:])

        out.seg_lo[c, row_b, slot] = seg_lo[row_seg]
        out.seg_hi[c, row_b, slot] = seg_hi[row_seg]
        out.nterm[c, row_b, slot] = seg_nt[row_seg]

        # term rows, expanded per bucket replica
        nterm_e = seg_nt[row_seg].astype(np.intp)
        e_idx = np.repeat(np.arange(len(row_seg), dtype=np.intp), nterm_e)
        t_intra = _grouped_arange(nterm_e)
        t_flat = np.repeat(seg_t0[row_seg], nterm_e) + t_intra
        tb, ts = row_b[e_idx], slot[e_idx]
        out.amp[c, tb, ts, t_intra] = t_amp[t_flat]
        out.nfac[c, tb, ts, t_intra] = t_nf[t_flat]

        # factor rows
        nfac_e = t_nf[t_flat].astype(np.intp)
        te_idx = np.repeat(np.arange(len(t_flat), dtype=np.intp), nfac_e)
        f_intra = _grouped_arange(nfac_e)
        f_flat = np.repeat(term_f0[t_flat], nfac_e) + f_intra
        fb, fs, ft = tb[te_idx], ts[te_idx], t_intra[te_idx]
        out.op[c, fb, fs, ft, f_intra] = f_op[f_flat]
        out.power[c, fb, fs, ft, f_intra] = f_pw[f_flat]
        out.shift_hi[c, fb, fs, ft, f_intra] = f_sh[f_flat]
        out.q32[c, fb, fs, ft, f_intra] = f_q[f_flat]
        out.args[c, fb, fs, ft, f_intra] = f_a[f_flat]

    out.pallas_ok = bool(np.all(np.isin(out.op, list(PALLAS_OPS)))
                         and out.ext.size <= PALLAS_EXT_MAX
                         and _pallas_desc_bytes(*out.shape[2:])
                         <= PALLAS_SMEM_BUDGET)
    return out
