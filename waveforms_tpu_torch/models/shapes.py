"""Pulse-shape constructors: the qubit-control "model zoo".

Every constructor returns a lazy :class:`~waveforms_tpu.core.Waveform`; no
samples are computed here.  Shapes, segment layouts, and rounding match the
reference constructors (``feihoo87/waveforms/waveforms/waveform.py:882-1484``)
so the wire formats agree, with two documented fixes noted inline (``poly``
with zero coefficients, ``t()``).
"""

from __future__ import annotations

import numpy as np
from numpy import inf, pi
from numpy.typing import NDArray

from ..core import Waveform, const, one, zero
from ..ir.algebra import HALF, NDIGITS, ZERO, add, basic_wave, const as \
    _const, mul
from ..ir.registry import (COS, COSH, D_GAUSSIAN, DRAG, ERF,
                           EXPONENTIALCHIRP, GAUSSIAN, HYPERBOLICCHIRP,
                           INTERP, LINEAR, LINEARCHIRP, MOLLIFIER, SINC,
                           EXP, SINH, registerBaseFunc)

__all__ = [
    'convolve', 'sign', 'step', 'square', 'gaussian', 'cos', 'sin', 'exp', 'sinc',
    'cosPulse', 'hanning', 'cosh', 'sinh', 'coshPulse', 'general_cosine',
    'slepian', 'mollifier', 'poly', 't', 'drag', 'chirp', 'interp', 'cut',
    'function', 'samplingPoints',
]


def convolve(a, b):
    """Symbolic convolution is not defined for this IR (the reference
    ships the same unimplemented stub, waveform.py:1074-1075); use
    :func:`waveforms_tpu.ops.fft.fft_convolve_centered` on samples."""
    return None


def sign() -> Waveform:
    """-1 for t<0, +1 for t>=0."""
    return Waveform(bounds=(0, +inf), seq=(_const(-1), _const(1.0)))


def step(edge, type='erf') -> Waveform:
    """Unit step with a smooth rising edge of the given width and shape.

    type: "erf", "cos", or "linear".
    """
    if edge == 0:
        return Waveform(bounds=(0, +inf), seq=(ZERO, _const(1.0)))
    if type == 'cos':
        rise = add(HALF,
                   mul(HALF, basic_wave(COS, pi / edge, shift=0.5 * edge)))
        return Waveform(bounds=(round(-edge / 2, NDIGITS),
                                round(edge / 2, NDIGITS), +inf),
                        seq=(ZERO, rise, _const(1.0)))
    if type == 'linear':
        rise = add(HALF, mul(_const(1 / edge), basic_wave(LINEAR)))
        return Waveform(bounds=(round(-edge / 2, NDIGITS),
                                round(edge / 2, NDIGITS), +inf),
                        seq=(ZERO, rise, _const(1.0)))
    # erf edge: rise = 1/2 + 1/2*erf(t/(edge/5))
    std_sq2 = edge / 5
    rise = ((((), ()), (((ERF, std_sq2, 0),), (1,))), (0.5, 0.5))
    return Waveform(bounds=(-round(edge, NDIGITS), round(edge, NDIGITS),
                            +inf),
                    seq=(ZERO, rise, _const(1.0)))


def square(width: float, edge: float = 0, type: str = 'erf') -> Waveform:
    """Flat-top pulse of the given width, optional smooth edges."""
    if width <= 0:
        return zero()
    if edge == 0:
        return Waveform(bounds=(round(-0.5 * width, NDIGITS),
                                round(0.5 * width, NDIGITS), +inf),
                        seq=(ZERO, _const(1.0), ZERO))
    return ((step(edge, type=type) << width / 2) -
            (step(edge, type=type) >> width / 2))


def gaussian(width: float, plateau: float = 0.0,
             d: int | None = None) -> Waveform:
    """Gaussian pulse; *width* is twice the FWHM; optional flat plateau.

    With ``d`` set, uses the d-th gaussian derivative as the edge shape.
    """
    if width <= 0 and plateau <= 0.0:
        return zero()
    # width = 2*FWHM  =>  std*sqrt(2) = width / (4*sqrt(log(2)))
    std_sq2 = width / 3.3302184446307908
    if d is None:
        def base(shift):
            return basic_wave(GAUSSIAN, std_sq2, shift=shift)
    else:
        def base(shift):
            return basic_wave(D_GAUSSIAN, std_sq2, d, shift=shift)

    if round(0.5 * plateau, NDIGITS) <= 0.0:
        return Waveform(bounds=(round(-0.75 * width, NDIGITS),
                                round(0.75 * width, NDIGITS), +inf),
                        seq=(ZERO, base(0), ZERO))
    return Waveform(bounds=(round(-0.75 * width - 0.5 * plateau, NDIGITS),
                            round(-0.5 * plateau, NDIGITS),
                            round(0.5 * plateau, NDIGITS),
                            round(0.75 * width + 0.5 * plateau, NDIGITS),
                            +inf),
                    seq=(ZERO, base(-0.5 * plateau), _const(1.0),
                         base(0.5 * plateau), ZERO))


def cos(w: float, phi: float = 0) -> Waveform:
    """cos(w*t + phi), stored as a shifted COS basis factor."""
    if w == 0:
        return const(np.cos(phi))
    if w < 0:
        phi = -phi
        w = -w
    return Waveform(seq=(basic_wave(COS, w, shift=-phi / w),))


def sin(w: float, phi: float = 0) -> Waveform:
    """sin(w*t + phi) == cos shifted by a quarter period."""
    if w == 0:
        return const(np.sin(phi))
    if w < 0:
        phi = -phi + pi
        w = -w
    return Waveform(seq=(basic_wave(COS, w, shift=(pi / 2 - phi) / w),))


def exp(alpha) -> Waveform:
    """exp(alpha*t); complex alpha expands to exp·(cos + j sin)."""
    if isinstance(alpha, complex):
        if alpha.real == 0:
            return cos(alpha.imag) + 1j * sin(alpha.imag)
        return exp(alpha.real) * (cos(alpha.imag) + 1j * sin(alpha.imag))
    return Waveform(seq=(basic_wave(EXP, alpha),))


def sinc(bw: float) -> Waveform:
    """sinc(bw*t), truncated at |t| = 50/bw."""
    if bw <= 0:
        return zero()
    width = 100 / bw
    return Waveform(bounds=(round(-0.5 * width, NDIGITS),
                            round(0.5 * width, NDIGITS), +inf),
                    seq=(ZERO, basic_wave(SINC, bw), ZERO))


def cosPulse(width: float, plateau: float = 0.0) -> Waveform:
    """Hann (raised-cosine) pulse: (1 + cos(2 pi t/width)) / 2."""
    if round(0.5 * plateau, NDIGITS) > 0:
        return square(plateau + 0.5 * width, edge=0.5 * width, type='cos')
    if width <= 0:
        return zero()
    pulse = ((((), ()), (((COS, 2 * pi / width, 0),), (1,))), (0.5, 0.5))
    return Waveform(bounds=(round(-0.5 * width, NDIGITS),
                            round(0.5 * width, NDIGITS), +inf),
                    seq=(ZERO, pulse, ZERO))


def hanning(width: float, plateau: float = 0.0) -> Waveform:
    return cosPulse(width, plateau=plateau)


def cosh(w: float) -> Waveform:
    return Waveform(seq=(basic_wave(COSH, w),))


def sinh(w: float) -> Waveform:
    return Waveform(seq=(basic_wave(SINH, w),))


def coshPulse(width: float, eps: float = 1.0,
              plateau: float = 0.0) -> Waveform:
    """Hyperbolic-secant-style pulse with edge steepness *eps*.

    Edge shape ``(cosh(eps/2) - cosh(eps*t/T)) / (cosh(eps/2) - 1)`` on
    t in [-T/2, T/2]; optional plateau splits it into rise/flat/fall.
    """
    if width <= 0 and plateau <= 0:
        return zero()
    if width <= 0:      # plateau-only: a flat-top pulse, like gaussian's
        return square(plateau)
    w = eps / width
    A = np.cosh(eps / 2)
    amps = (A / (A - 1), -1 / (A - 1))

    if plateau == 0.0 or round(-0.5 * plateau, NDIGITS) == round(
            0.5 * plateau, NDIGITS):
        pulse = ((((), ()), (((COSH, w, 0),), (1,))), amps)
        return Waveform(bounds=(round(-0.5 * width, NDIGITS),
                                round(0.5 * width, NDIGITS), +inf),
                        seq=(ZERO, pulse, ZERO))
    raising = ((((), ()), (((COSH, w, -0.5 * plateau),), (1,))), amps)
    falling = ((((), ()), (((COSH, w, 0.5 * plateau),), (1,))), amps)
    return Waveform(bounds=(round(-0.5 * width - 0.5 * plateau, NDIGITS),
                            round(-0.5 * plateau, NDIGITS),
                            round(0.5 * plateau, NDIGITS),
                            round(0.5 * width + 0.5 * plateau, NDIGITS),
                            +inf),
                    seq=(ZERO, raising, _const(1.0), falling, ZERO))


def general_cosine(duration: float, *arg: float) -> Waveform:
    """Windowed sum-of-harmonics pulse (coefficients normalized)."""
    wav = zero()
    arg_ = np.asarray(arg, dtype=float)
    norm = arg_[::2].sum()
    if norm == 0:
        raise ValueError(
            "general_cosine: even-indexed coefficients sum to 0 -- the "
            "normalization is undefined (an all-NaN waveform otherwise)")
    arg_ /= norm
    for i, a in enumerate(arg_, start=1):
        wav += a / 2 * (1 - (-1)**i * cos(i * 2 * pi / duration))
    return wav * square(duration)


def slepian(duration: float, *arg: float) -> Waveform:
    """Alias family of general_cosine (reference keeps both names)."""
    return general_cosine(duration, *arg)


def mollifier(width: float, plateau: float = 0.0, d: int = 0) -> Waveform:
    """Smooth bump: 1 at the origin, identically 0 outside |t| > width/2.

    ``d`` selects the d-th derivative of the bump.
    """
    assert d >= 0 and isinstance(d, int), "d must be a non-negative integer"
    assert width > 0, "width must be positive"

    if plateau <= 0:
        return Waveform(bounds=(-0.5 * width, 0.5 * width, inf),
                        seq=(ZERO, basic_wave(MOLLIFIER, width / 2, d), ZERO))
    return Waveform(bounds=(-0.5 * width - 0.5 * plateau, -0.5 * plateau,
                            0.5 * plateau, 0.5 * width + 0.5 * plateau, inf),
                    seq=(ZERO,
                         basic_wave(MOLLIFIER, width / 2, d,
                                    shift=-0.5 * plateau), _const(1.0),
                         basic_wave(MOLLIFIER, width / 2, d,
                                    shift=0.5 * plateau), ZERO))


def _poly_expr(coeffs):
    """a[0] + a[1]*t + a[2]*t**2 + ... as one IR expression.

    NB: the reference (waveform.py:1320-1333) pairs the filtered term list
    with the *unfiltered* amplitude list, silently mis-evaluating any
    polynomial with internal zero coefficients; here amplitudes are filtered
    consistently.
    """
    terms, amps = [], []
    if not coeffs:
        return ZERO        # poly([]) is the zero polynomial
    if coeffs[0] != 0:
        terms.append(((), ()))
        amps.append(coeffs[0])
    for n, a in enumerate(coeffs[1:], start=1):
        if a != 0:
            terms.append((((LINEAR, 0),), (n,)))
            amps.append(a)
    return tuple(terms), tuple(amps)


def poly(a) -> Waveform:
    """Polynomial waveform: ``a[0] + a[1]*t + a[2]*t**2 + ...``."""
    return Waveform(seq=(_poly_expr(tuple(a)),))


def t() -> Waveform:
    """The identity waveform f(t) = t.

    NB: the reference's ``t()`` (waveform.py:1343-1344) builds a malformed
    seq tuple that crashes on evaluation; this is the intended expression.
    """
    return Waveform(seq=(basic_wave(LINEAR),))


def drag(freq: float, width: float, plateau: float = 0, delta: float = 0,
         block_freq: float | None = None, phase: float = 0,
         t0: float = 0) -> Waveform:
    """sin^2-envelope DRAG pulse with optional plateau and Y-quadrature.

    Three-case layout as the reference (waveform.py:1347-1379): envelope
    only, carrier only, or rise/carrier/fall.
    """
    phase += pi * delta * (width + plateau)
    if plateau <= 0:
        return Waveform(seq=(ZERO,
                             basic_wave(DRAG, t0, freq, width, delta,
                                        block_freq, phase), ZERO),
                        bounds=(round(t0, NDIGITS),
                                round(t0 + width, NDIGITS), +inf))
    if width <= 0:
        w = 2 * pi * (freq + delta)
        return Waveform(
            seq=(ZERO,
                 basic_wave(COS, w, shift=(phase + 2 * pi * delta * t0) / w),
                 ZERO),
            bounds=(round(t0, NDIGITS), round(t0 + plateau, NDIGITS), +inf))
    w = 2 * pi * (freq + delta)
    return Waveform(
        seq=(ZERO,
             basic_wave(DRAG, t0, freq, width, delta, block_freq, phase),
             basic_wave(COS, w, shift=(phase + 2 * pi * delta * t0) / w),
             basic_wave(DRAG, t0 + plateau, freq, width, delta, block_freq,
                        phase - 2 * pi * delta * plateau), ZERO),
        bounds=(round(t0, NDIGITS), round(t0 + width / 2, NDIGITS),
                round(t0 + width / 2 + plateau, NDIGITS),
                round(t0 + width + plateau, NDIGITS), +inf))


def chirp(f0: float, f1: float, T: float, phi0: float = 0,
          type: str = 'linear') -> Waveform:
    """Frequency sweep from f0 to f1 over T; linear/exponential/hyperbolic."""
    if T <= 0:
        raise ValueError('T must be positive')
    if f0 == f1:
        # constant-frequency limit: keep the chirp convention
        # (sin(2 pi f t + phi0), windowed to [0, T]) -- the reference
        # fell back to sin(f0, phi0), dropping BOTH the 2 pi factor and
        # the window, a discontinuous jump as f1 -> f0 (documented
        # divergence, docs/PARITY.md)
        return cut(sin(2 * pi * f0, phi0), start=0, stop=T)

    if type == 'linear':
        return Waveform(bounds=(0, round(T, NDIGITS), +inf),
                        seq=(ZERO, basic_wave(LINEARCHIRP, f0, f1, T, phi0),
                             ZERO))
    if type in ('exp', 'exponential', 'geometric'):
        if f0 == 0:
            raise ValueError('f0 must be non-zero')
        alpha = np.log(f1 / f0) / T
        return Waveform(bounds=(0, round(T, NDIGITS), +inf),
                        seq=(ZERO,
                             basic_wave(EXPONENTIALCHIRP, f0, alpha, phi0),
                             ZERO))
    if type in ('hyperbolic', 'hyp'):
        if f0 * f1 == 0:
            return const(np.sin(phi0))
        k = (f0 - f1) / (f1 * T)
        return Waveform(bounds=(0, round(T, NDIGITS), +inf),
                        seq=(ZERO, basic_wave(HYPERBOLICCHIRP, f0, k, phi0),
                             ZERO))
    raise ValueError(f'unknown type {type}')


def interp(x: NDArray[np.float64], y: NDArray[np.float64]) -> Waveform:
    """Piecewise-linear interpolation through the points (x, y)."""
    seq, bounds = [ZERO], [x[0]]
    for x1, x2, y1, y2 in zip(x[:-1], x[1:], y[:-1], y[1:]):
        if x2 == x1:
            continue
        seq.append(
            add(mul(_const((y2 - y1) / (x2 - x1)),
                    basic_wave(LINEAR, shift=x1)), _const(y1)))
        bounds.append(x2)
    bounds.append(inf)
    seq.append(ZERO)
    return Waveform(seq=tuple(seq),
                    bounds=tuple(round(b, NDIGITS)
                                 for b in bounds)).simplify()


def cut(wav: Waveform, start: float | None = None, stop: float | None = None,
        head: float | None = None, tail: float | None = None,
        min: float | None = None, max: float | None = None) -> Waveform:
    """Window a waveform in time and optionally clip its range.

    ``head``/``tail`` add a constant offset so the value at the cut point
    matches the requested level.
    """
    offset = 0
    if start is not None and head is not None:
        offset = head - wav(np.array([1.0 * start]))[0]
    elif stop is not None and tail is not None:
        offset = tail - wav(np.array([1.0 * stop]))[0]
    wav = wav + offset

    if start is not None:
        wav = wav * (step(0) >> start)
    if stop is not None:
        wav = wav * ((1 - step(0)) >> stop)
    if min is not None:
        wav.min = min
    if max is not None:
        wav.max = max
    return wav


def function(fun, *args, start=None, stop=None) -> Waveform:
    """Wrap an arbitrary callable ``fun(t, *args)`` as a waveform.

    Registers *fun* as a new basis function (host-evaluated; on-device
    sampling of user functions goes through ``jax.pure_callback`` unless a
    traceable lowering is registered, see ``waveforms_tpu.ops``).
    """
    type_id = registerBaseFunc(fun)
    wav = Waveform(seq=(basic_wave(type_id, *args),))
    if start is not None:
        wav = wav * (step(0) >> start)
    if stop is not None:
        wav = wav * ((1 - step(0)) >> stop)
    return wav


def samplingPoints(start, stop, points) -> Waveform:
    """Waveform defined by uniformly spaced samples (linear interp basis)."""
    return Waveform(bounds=(round(start, NDIGITS), round(stop, NDIGITS), inf),
                    seq=(ZERO, basic_wave(INTERP, start, stop, tuple(points)),
                         ZERO))
