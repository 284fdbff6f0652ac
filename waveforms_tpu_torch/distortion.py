"""Transmission-line distortion pre-compensation toolbox (host layer).

Filter *design* (polynomial construction, matched-z transforms, stability
pruning) is tiny host-side math and stays numpy/scipy; the reference
package's toolbox (``waveforms/distortion.py``) defines the API and the
numerics this module reproduces.  Filter *application* at scale (IIR
over millions of samples, FFT deconvolution) has GPU-resident
implementations in :mod:`waveforms_tpu_torch.ops.iir` and
:mod:`waveforms_tpu_torch.ops.fft`; the scipy paths here are the parity
oracles.  Carried over from the JAX package's ``distortion.py`` unchanged
(numpy and scipy only; :func:`correct_reflection` takes this package's own
:class:`~waveforms_tpu_torch.core.Waveform`).
"""

from __future__ import annotations

import warnings
from functools import reduce
from itertools import zip_longest
from typing import Sequence

import numpy as np
from scipy.signal import fftconvolve, lfilter, lfiltic, tf2zpk, zpk2sos, \
    zpk2tf

from .utils.signal import shift  # noqa: F401  (re-export, reference parity)

__all__ = [
    'shift', 'extractKernel', 'zDistortKernel', 'high_pass_filter',
    'exp_decay_filter', 'exp_decay_filter_old', 'reflection_filter',
    'reflection',
    'correct_reflection', 'combine_filters', 'factor_filter', 'stable_filter',
    'predistort', 'distort', 'phase_curve',
]


def extractKernel(sig_in, sig_out, sample_rate, bw=None, skip=0):
    """Deconvolution kernel from a measured (input, output) pair.

    The spectral ratio in(f)/out(f) is the inverse response; its centered
    impulse response, optionally smoothed by a gaussian window of bandwidth
    ``bw``, is the correction kernel.  ``skip`` trims edge artifacts.
    """
    ratio = np.fft.fft(sig_in) / np.fft.fft(sig_out)
    ker = np.fft.ifftshift(np.fft.ifft(ratio)).real
    if bw is not None and bw < 0.5 * sample_rate:
        n_win = int(2 * sample_rate / bw)
        win = np.exp(-0.5 * np.linspace(-3.0, 3.0, n_win) ** 2)
        ker = np.convolve(ker, win / win.sum(), mode='same')
    skip = int(skip)
    return ker[skip:len(ker) - skip]


def zDistortKernel(dt: float, params: Sequence[tuple]) -> np.ndarray:
    """Inverse kernel for a sum of single-pole Z-line distortions.

    Each ``(tau, A)`` contributes jwAτ/(jwτ+1) to the transfer function;
    the kernel is the impulse response of 1/H, long enough (3x the slowest
    τ) for the tails to decay.
    """
    taus = np.asarray(params)[:, 0]
    n = int(3 * taus.max() / dt) + 1
    jw = 2j * np.pi * np.fft.fftfreq(n, dt)
    H = np.ones(n, complex)
    for tau, A in params:
        H = H + A * jw * tau / (jw * tau + 1)
    return np.fft.ifftshift(np.fft.ifft(1 / H)).real


def high_pass_filter(tau, sample_rate):
    """First-order high-pass (b, a): bilinear transform of s/(s + 1/tau)."""
    k = 2.0 * tau * sample_rate
    c = 1.0 / (1.0 + k)
    return [k * c, -k * c], [1.0, (1.0 - k) * c]


def exp_decay_filter_old(amp, tau, sample_rate):
    """Legacy single-exponential design (kept for reference API parity).

    H(w) = A / (1 - 1j/(w*tau)); superseded by :func:`exp_decay_filter`.
    """
    alpha = 1 - np.exp(-1 / (abs(sample_rate * tau) * (1 + amp)))

    if amp >= 0:
        k = amp / (1 + amp - alpha)
        a = [(1 - k + k * alpha), -(1 - k) * (1 - alpha)]
    else:
        k = -amp / (1 + amp) / (1 - alpha)
        a = [(1 + k - k * alpha), -(1 + k) * (1 - alpha)]

    b = [1 / a[0], -(1 - alpha) / a[0]]
    a = [1, a[1] / a[0]]
    return b, a


def exp_decay_filter(
    amp: float | Sequence[float],
    tau: float | Sequence[float],
    sample_rate: float,
    inv: bool = False,
    output='ba',
):
    """Multi-exponential-decay IIR filter (or its inverse pre-compensation).

    Models a line whose step response is ``1 - sum_i A_i exp(-t/tau_i)``,
    i.e. the continuous-time transfer function

        H(s) = 1 - sum_i A_i s / (s + 1/tau_i).

    Over the common denominator D(s) = prod_i (s + 1/tau_i), the poles are
    the known -1/tau_i and the zeros are the roots of

        N(s) = D(s) - sum_i A_i s prod_{j != i} (s + 1/tau_j).

    Both map to Z by the matched-z transform z = exp(s/fs); the gain is
    fixed so the discrete filter has unit DC response.  ``inv=True`` swaps
    zeros and poles, giving the *pre*-compensation filter; poles on or
    outside the unit circle are dropped to keep the result stable (the
    reference applies the same pruning, distortion.py:167-174).  ``output``
    selects 'ba', 'sos', or 'zpk'.
    """
    if isinstance(amp, (int, float, complex)):
        amp, tau = [amp], [tau]

    D = reduce(np.polymul, (np.poly1d([1.0, 1.0 / t]) for t in tau),
               np.poly1d([1.0]))
    N = np.poly1d(D)
    for i, (A, t) in enumerate(zip(amp, tau)):
        others = [np.poly1d([1.0, 1.0 / t_])
                  for j, t_ in enumerate(tau) if j != i]
        N = N - np.poly1d([A, 0.0]) * reduce(np.polymul, others,
                                             np.poly1d([1.0]))

    z = np.exp(np.poly1d(N).roots / sample_rate)
    p = np.exp(-1.0 / (np.asarray(tau) * sample_rate))

    if inv:
        z, p = p, z
    p = p[np.abs(p) < 1]                       # stability pruning
    k = (np.prod(1 - p) / np.prod(1 - z)).real  # unit gain at z = 1 (DC)

    if output == 'sos':
        return zpk2sos(z, p, k)
    if output == 'ba':
        return zpk2tf(z, p, k)
    if output == 'zpk':
        return z, p, k
    raise ValueError(f"Invalid output type: {output}")


def reflection_filter(f, A, tau):
    """Transfer function of an impedance reflection of amplitude A, delay tau.

    out(t) = (1-A) * sum_k A^k in(t - k*tau), normalized to unit DC gain.
    """
    return (1 - A) / (1 - A * np.exp(-2j * np.pi * f * tau))


def _through_spectrum(sig, sample_rate, tf, invert=False):
    """Multiply (or divide) a sampled signal by a transfer function."""
    f = np.fft.fftfreq(len(sig), 1 / sample_rate)
    H = tf(f)
    spec = np.fft.fft(sig)
    spec = spec / H if invert else spec * H
    return np.fft.ifft(spec).real


def reflection(sig, A, tau, sample_rate):
    """Apply a reflection to a sampled signal (FFT domain)."""
    return _through_spectrum(sig, sample_rate,
                             lambda f: reflection_filter(f, A, tau))


def correct_reflection(sig, A, tau, sample_rate=None):
    """Undo a reflection; symbolic on a Waveform, FFT-domain on samples.

    The symbolic branch uses the first-order inverse
    1/(1-A)*sig - A/(1-A)*(sig >> tau) (exact for a single bounce),
    cf. reference distortion.py:216-217.
    """
    from .core import Waveform

    if isinstance(sig, Waveform):
        return 1 / (1 - A) * sig - A / (1 - A) * (sig >> tau)
    if sample_rate is None:
        raise ValueError('sample_rate is not given')
    return _through_spectrum(sig, sample_rate,
                             lambda f: reflection_filter(f, A, tau),
                             invert=True)


def combine_filters(filters):
    """Cascade (b, a) filters: coefficient convolution == polynomial product."""
    b = reduce(np.convolve, (np.atleast_1d(f[0]) for f in filters),
               np.ones(1))
    a = reduce(np.convolve, (np.atleast_1d(f[1]) for f in filters),
               np.ones(1))
    return b, a


def factor_filter(b, a):
    """Split a (b, a) filter into first-order (zero, pole) sections.

    Each section carries an equal share of the overall gain (the n-th root),
    so the cascade reproduces b/a; unmatched roots pair with 0.

    The gain is the ratio of LEADING coefficients (``.coeffs[0]``): the
    reference reads ``b[0]/a[0]``, which on ``np.poly1d`` indexes the
    CONSTANT (x^0) terms -- the cascade then reproduces b/a only when
    prod(zeros) == prod(poles), and a zero at the origin collapses every
    section to the zero filter (documented divergence, docs/PARITY.md).
    """
    b, a = np.poly1d(b), np.poly1d(a)
    n = max(len(b.roots), len(a.roots))
    g = (b.coeffs[0] / a.coeffs[0]) ** (1 / n)
    return [([g, -g * zero], [1, -pole])
            for pole, zero in zip_longest(a.roots, b.roots, fillvalue=0)]


def stable_filter(exp_decay_filters: list, sample_rate: float) -> bool:
    """True iff the inverse (pre-compensation) cascade is stable.

    Pre-distortion runs the *inverse* of the modeled line, whose poles are
    the forward cascade's zeros -- hence the (b, a) swap before the pole
    check.  (The forward filters' own poles exp(-1/(tau*fs)) are inside the
    unit circle by construction.)
    """
    sections = [exp_decay_filter(amp, tau, sample_rate)
                for amp, tau in exp_decay_filters]
    num, den = combine_filters([(a, b) for b, a in sections])
    _, poles, _ = tf2zpk(num, den)
    return bool(np.all(np.abs(poles) < 1))


def _steady_state_zi(b, a, initial, initial_x, initial_y):
    """lfilter initial conditions from pre-history (default: DC ``initial``)."""
    if initial_x is None:
        initial_x = np.full(len(b) - 1, initial)
    else:
        initial_x = np.asarray(initial_x)[:len(b) - 1]
    if initial_y is None:
        initial_y = np.full(len(a) - 1, initial)
    else:
        initial_y = np.asarray(initial_y)[:len(a) - 1]
    return lfiltic(b, a, initial_y, initial_x)


def predistort(
    sig: np.ndarray,
    filters: list | None = None,
    ker: np.ndarray | None = None,
    initial: float = 0.0,
    initial_x: np.ndarray | None = None,
    initial_y: np.ndarray | None = None,
    zi: np.ndarray | None = None,
    return_zf: bool = False,
) -> np.ndarray | tuple[np.ndarray, np.ndarray]:
    """Apply IIR pre-compensation filters and/or an FFT deconvolution kernel.

    The IIR stage starts from steady state at ``initial`` (or the explicit
    ``initial_x``/``initial_y`` histories) unless ``zi`` is given;
    ``return_zf`` also yields the final state for chunked streaming.  The
    kernel stage zero-pads one signal length on each side so the circular
    artifacts of the convolution land outside the retained window.
    """
    zf = None
    if filters is not None:
        b, a = combine_filters(filters)
        if not np.all(np.abs(tf2zpk(b, a)[1]) < 1):
            warnings.warn('Warning: filter is unstable')
        if zi is None:
            zi = _steady_state_zi(b, a, initial, initial_x, initial_y)
        sig, zf = lfilter(b, a, sig, zi=zi)

    if ker is not None:
        size = len(sig)
        padded = np.pad(sig, size)
        first = size + len(ker) // 2
        sig = fftconvolve(padded, ker, mode='full')[first:first + size]

    return (sig, zf) if return_zf else sig


def distort(points, params, sample_rate, initial=0.0):
    """Apply the *forward* exp-decay distortion described by (amp, tau) pairs."""
    sections = [exp_decay_filter(amp, abs(tau), sample_rate)
                for amp, tau in np.asarray(params).reshape(-1, 2)]
    return predistort(points, sections, initial=initial)


def phase_curve(t, params, df_dphi, pulse_width, start, wav, sample_rate):
    """Model of a measured phase-vs-delay curve for distortion-parameter fits.

    The probe pulse integrates the (distorted) flux excursion over a window
    of ``pulse_width`` ending ``start`` after each delay point; the
    accumulated phase is 2*pi*df_dphi times that integral.  Used as the
    model function for ``scipy.optimize.curve_fit`` when measuring a line's
    (amp, tau) distortion parameters (cf. reference distortion.py:349-366).
    """
    half_span = max(np.max(np.abs(t)), 20e-6)
    grid = np.arange(round(2 * half_span * sample_rate)) / sample_rate \
        - half_span
    flux = distort(wav(grid), params, sample_rate)

    n_pulse = round(pulse_width * sample_rate)
    n_lag = round((start + pulse_width) * sample_rate) - 1
    window = np.zeros(n_pulse + n_lag)
    window[:n_pulse] = 1.0 / sample_rate

    phase = np.convolve(2 * np.pi * df_dphi * flux, window, mode='same')
    return np.interp(t, grid, phase)
