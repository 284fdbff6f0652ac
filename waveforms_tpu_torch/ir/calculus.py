"""Exact symbolic differentiation of IR expressions.

``D(expr)`` applies the sum and product rules over the sum-of-products IR,
delegating the derivative of each basis factor to a per-ID rule registered in
:mod:`waveforms_tpu.ir.registry`.  Rule outputs are themselves expressions,
so arbitrarily chained derivatives stay symbolic and sample exactly.

Semantics match the reference (``feihoo87/waveforms/waveforms/_waveform.pyx:
238-261,391-480``) with one documented fix: the reference's sinc rule is
unusable (it indexes a second argument sinc factors do not carry and uses an
un-scaled frequency, ``_waveform.pyx:410-413``); the rule here is the correct
closed form, validated against numerical differentiation in the test suite.
"""

from __future__ import annotations

import numpy as np
from numpy import pi

from .algebra import ONE, ZERO, add, const, is_const, mul
from .registry import (COS, COSH, D_GAUSSIAN, ERF, EXP, EXPONENTIALCHIRP,
                       GAUSSIAN, HYPERBOLICCHIRP, INTERP, LINEAR, LINEARCHIRP,
                       MOLLIFIER, SINC, SINH, derivativeBaseFunc,
                       registerDerivative)



def _derive_factor(factor):
    """Derivative (as an expression) of a single basis factor at power 1."""
    fun_id, *args, shift = factor
    return derivativeBaseFunc[fun_id](shift, *args)


def D(x):
    """Differentiate an expression w.r.t. time, exactly.

    Recursion: split off the first term (sum rule); within a term split off
    the first factor (product rule); a factor at power n reduces via
    ``d(f^n) = n f^(n-1) df``.
    """
    if is_const(x):
        return ZERO
    terms, amps = x
    if len(amps) > 1:
        return add(D((terms[:1], amps[:1])), D((terms[1:], amps[1:])))

    (factors, powers), v = terms[0], amps[0]
    if len(factors) > 1:
        head = (((factors[:1], powers[:1]),), (v,))
        tail = (((factors[1:], powers[1:]),), (1,))
        return add(mul(head, D(tail)), mul(D(head), tail))

    factor, n = factors[0], powers[0]
    if n == 1:
        return mul(_derive_factor(factor), const(v))
    reduced = ((((factor,), (n - 1,)),), (n * v,))
    return mul(reduced, D(((((factor,), (1,)),), (1,))))


# ---------------------------------------------------------------------------
# Per-basis derivative rules.  Each returns a raw expression tuple; formulas
# follow feihoo87/waveforms/waveforms/_waveform.pyx:391-463 (sinc excepted, see
# module docstring).
# ---------------------------------------------------------------------------


def _d_linear(shift, *args):
    return ONE


def _d_gaussian(shift, std_sq2):
    return (((((LINEAR, shift), (GAUSSIAN, std_sq2, shift)), (1, 1)),),
            (-2 / std_sq2**2,))


def _d_erf(shift, std_sq2):
    return (((((GAUSSIAN, std_sq2, shift),), (1,)),),
            (2 / std_sq2 / np.sqrt(pi),))


def _d_cos(shift, w):
    return (((((COS, w, shift - pi / w / 2),), (1,)),), (w,))


_D_SINC_ID = None


def _d_sinc_body(t, bw):
    """d/dt sinc(bw*t) = (cos(pi*bw*t) - sinc(bw*t)) / t, stable at 0.

    The removable singularity evaluates via its series (-(pi b)^2 t/3
    * (1 - x^2/10)) below |x| < 1e-4; the closed form's two ~1/t terms
    would otherwise cancel catastrophically (NaN at the center, ~1e2
    absolute error a few samples away with a LINEAR^-1 pole
    representation)."""
    t = np.asarray(t, float)
    x = np.pi * bw * t
    small = np.abs(x) < 1e-4
    safe_t = np.where(small, 1.0, t)
    closed = (np.cos(x) - np.sinc(bw * t)) / safe_t
    series = -(np.pi * bw) ** 2 * t / 3.0 * (1.0 - x * x / 10.0)
    return np.where(small, series, closed)


def _d_sinc(shift, bw):
    # a DEDICATED basis, registered lazily on first use so the built-in
    # ID block (1..15 at registry import, 16/17 at multy_drag import)
    # keeps its serialization-stable numbering.  Second derivatives of
    # sinc have no rule (raises like any unregistered derivative).
    global _D_SINC_ID
    if _D_SINC_ID is None:
        from .registry import registerBaseFunc
        _D_SINC_ID = registerBaseFunc(_d_sinc_body)
    return ((((_D_SINC_ID, bw, shift),), (1,)),), (1.0,)


def _d_exp(shift, alpha):
    return (((((EXP, alpha, shift),), (1,)),), (alpha,))


def _d_interp(shift, start, stop, points):
    grad = tuple(np.gradient(np.asarray(points)))
    return (((((INTERP, start, stop, grad, shift),), (1,)),),
            ((len(points) - 1) / (stop - start),))


def _d_cosh(shift, w):
    return (((((SINH, w, shift),), (1,)),), (w,))


def _d_sinh(shift, w):
    return (((((COSH, w, shift),), (1,)),), (w,))


def _d_linear_chirp(shift, f0, f1, T, phi0):
    terms = (
        (((LINEARCHIRP, f0, f1, T, phi0 + pi / 2, shift),), (1,)),
        (((LINEAR, shift), (LINEARCHIRP, f0, f1, T, phi0 + pi / 2, shift)),
         (1, 1)),
    )
    amps = (2 * pi * f0, 2 * pi * (f1 - f0) / T)
    if f0 == 0:
        return terms[1:], amps[1:]
    return terms, amps


def _d_exponential_chirp(shift, f0, alpha, phi0):
    return (((((EXP, alpha, shift),
               (EXPONENTIALCHIRP, f0, alpha, phi0 + pi / 2, shift)),
              (1, 1)),), (2 * pi * f0,))


def _d_hyperbolic_chirp(shift, f0, k, phi0):
    # d/dt sin(phi0 + 2 pi f0/k log(1+k(t-s)))
    #   = 2 pi f0 / k * (t-s+1/k)^-1 * sin(phi0+pi/2 + ...)
    # NB: the reference rule (_waveform.pyx:453-455) omits the 1/k factor;
    # validated against numerical differentiation in tests/test_calculus.py.
    return (((((LINEAR, shift - 1 / k),
               (HYPERBOLICCHIRP, f0, k, phi0 + pi / 2, shift)),
              (-1, 1)),), (2 * pi * f0 / k,))


def _d_mollifier(shift, r, d):
    return (((((MOLLIFIER, r, d + 1, shift),), (1,)),), (1,))


def _d_d_gaussian(shift, std_sq2, n):
    return (((((D_GAUSSIAN, std_sq2, n + 1, shift),), (1,)),), (1,))


registerDerivative(LINEAR, _d_linear)
registerDerivative(GAUSSIAN, _d_gaussian)
registerDerivative(ERF, _d_erf)
registerDerivative(COS, _d_cos)
registerDerivative(SINC, _d_sinc)
registerDerivative(EXP, _d_exp)
registerDerivative(INTERP, _d_interp)
registerDerivative(COSH, _d_cosh)
registerDerivative(SINH, _d_sinh)
registerDerivative(LINEARCHIRP, _d_linear_chirp)
registerDerivative(EXPONENTIALCHIRP, _d_exponential_chirp)
registerDerivative(HYPERBOLICCHIRP, _d_hyperbolic_chirp)
registerDerivative(MOLLIFIER, _d_mollifier)
registerDerivative(D_GAUSSIAN, _d_d_gaussian)
