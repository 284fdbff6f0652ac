"""Multi-tone DRAG: pulses that notch out several blocking frequencies.

Builds sin^m-envelope X/Y quadrature pairs whose spectrum has zeros at every
requested blocking frequency, via a matrix power-series in the antisymmetric
blocking matrix (``B_series_mat``) applied to tables of sin-power derivatives.
``drag_sinx`` additionally blends polynomial patches at the pulse edges
(``tab`` controls the blend fraction) so the envelope leaves zero smoothly.

Algorithms match ``feihoo87/waveforms/waveforms/multy_drag.py`` numerically; the
basis functions register as IDs 16 (DRAG_SIN) and 17 (DRAG_SINX) on import,
as the wire format requires.  On device the same math runs at trace time
(the matrices depend only on static pulse parameters), leaving a pure
elementwise kernel over t -- see ``waveforms_tpu.ops.jax_basis``.
"""

from __future__ import annotations

import math

import numpy as np
from numpy import inf, pi

from ..core import Waveform
from ..ir.algebra import NDIGITS, ZERO, basic_wave
from ..ir.registry import registerBaseFunc

__all__ = ['drag_sin', 'drag_sinx', 'DRAG_SIN', 'DRAG_SINX']


def B_series_mat(bs: np.ndarray) -> np.ndarray:
    """Stack of matrix power-series terms in the 2x2 blocking rotation.

    ``aa[k] = sum over k-subsets of the product of [[0,b],[-b,0]]`` built
    incrementally; aa[0] = I.
    """
    aa = np.zeros([len(bs) + 1, 2, 2])
    aa[0] = np.identity(2)
    for b in bs:
        bb = np.array([[0, b], [-b, 0]])
        aa[1:] = aa[1:] + aa[:-1] @ bb
    return aa


def sin_power_derivative_table(m: int, n: int, a: float = 1) -> np.ndarray:
    """Coefficients expressing d^i/dt^i of sin(a t)^p over the sin-power basis.

    Row i, column p: after i derivatives of the length-(m+1) monomial vector
    ``sin^p`` (odd rows carry an implicit cos factor).  Same recurrence as
    the reference's ``_derivatives_sin_m``.
    """
    aa = np.zeros([n + 1, m + 1])
    aa[0, m] = 1
    for i in range(1, n + 1):
        if i % 2:
            aa[i][:-1] = aa[i - 1][1:] * np.arange(1, m + 1) * a
        else:
            aa[i][:-2] = aa[i - 2][2:] * np.arange(1, m) * np.arange(2, m + 1)
            aa[i] = aa[i] - aa[i - 2] * np.arange(m + 1)**2
            aa[i] = aa[i] * (a**2)
    return aa


def _blocking_setup(width: float, delta: float, block_freq):
    """Common setup: blocking coefficients, envelope order, matrices."""
    bs, m = [], 2
    if block_freq is not None:
        if not hasattr(block_freq, '__len__'):
            block_freq = (float(block_freq),)   # int/np scalars too
        diff = np.asarray(block_freq, float) - delta
        if np.any(diff == 0):
            # the single-tone _drag guards this; inf coefficients here
            # flowed NaNs silently into every sample
            raise ValueError(
                "drag_sin: a blocking frequency equals delta -- the "
                "blocking coefficient 1/(2 pi (f_b - delta)) diverges")
        bs = 1 / np.pi / 2 / diff
        m = max((len(bs) + 2) >> 1 << 1, m)
    B_mat = B_series_mat(np.asarray(bs))
    o = np.pi / width
    A_mat = sin_power_derivative_table(m, len(bs), o)
    return np.asarray(bs), m, o, B_mat, A_mat


def _envelope_powers(t, t0, width, plateau, o, m):
    """sin^p(o*(t-t0)) basis rows with the plateau region zeroed.

    Odd rows carry the extra cos factor (they represent odd derivatives).
    """
    rise = t <= t0 + width / 2
    flat = (t > t0 + width / 2) & (t < t0 + plateau + width / 2)
    base_t = np.where(rise, t - t0, t - t0 - plateau)
    s = np.where(flat, 0.0, np.sin(o * base_t))
    c = np.where(flat, 0.0, np.cos(o * base_t))
    ps = np.arange(m + 1)
    rows = s[None, :] ** ps[:, None]
    rows[1::2] = rows[1::2] * c[None, :]
    return rows, flat


def _normalization(B_mat, A_mat, m):
    """Peak normalization so the X quadrature has unit envelope maximum."""
    peak = np.ones([m + 1])
    peak[1::2] = 0
    peak = A_mat @ peak
    coe = np.einsum('ijk,ki->j', B_mat,
                    np.array([peak, np.zeros_like(peak)]))
    return np.sqrt(np.sum(np.abs(coe)**2))


def drag_omega_sin(t: np.ndarray, t0: float, width: float, delta: float,
                   block_freq=None, plateau: float = 0) -> np.ndarray:
    """(Omega_x, Omega_y) envelope pair for the sin^m multi-tone DRAG."""
    if isinstance(block_freq, float):
        block_freq = (block_freq,)
    bs, m, o, B_mat, A_mat = _blocking_setup(width, delta, block_freq)
    rows, flat = _envelope_powers(t, t0, width, plateau, o, m)
    rows = A_mat @ rows
    coeff = _normalization(B_mat, A_mat, m)

    ccc = np.array([rows, np.zeros_like(rows)])
    ccc[0, 0][flat] = 1
    return np.einsum('ijk,kim->jm', B_mat, ccc) / coeff


def edge_blend_poly(f: np.ndarray, x: float) -> np.poly1d:
    """Polynomial matching the envelope's value/derivatives at an edge point.

    Solves for the lowest-order polynomial whose value and first n
    derivatives at *x* equal ``f`` (with f[0] offset so the blend starts at
    1), as the reference's ``_derivatives_x_m_poly_a``.
    """
    fff = np.copy(f)
    fff[0] -= 1
    m = f.shape[0]
    C = np.zeros([m, m])
    for n in range(m):
        for l in range(m):
            C[n, l] = (x**(m + l - n)) * math.factorial(m + l) / \
                math.factorial(m + l - n)
    C_inv = np.linalg.inv(C)
    return np.poly1d([*np.flip(C_inv @ fff), *np.zeros_like(f[:-1]), 1])


def drag_omega_sin_x(t: np.ndarray, t0: float, width: float, delta: float,
                     block_freq=None, plateau: float = 0,
                     tab: float = 0.618) -> np.ndarray:
    """(Omega_x, Omega_y) with polynomial edge blending over a *tab* fraction."""
    if isinstance(block_freq, float):
        block_freq = (block_freq,)
    bs, m, o, B_mat, A_mat = _blocking_setup(width, delta, block_freq)
    rows, flat = _envelope_powers(t, t0, width, plateau, o, m)
    rows = A_mat @ rows

    def edge_rows(sign):
        x = np.sin(o * (1 + sign * tab) * width / 2) ** np.arange(m + 1)
        x[1::2] = x[1::2] * np.cos(o * (1 + sign * tab) * width / 2)
        return A_mat @ x

    poly_left = edge_blend_poly(edge_rows(-1), -tab * width / 2)
    poly_right = edge_blend_poly(edge_rows(+1), tab * width / 2)

    coeff = _normalization(B_mat, A_mat, m)

    ccc = np.array([rows, np.zeros_like(rows)])
    ccc[0, 0][flat] = 1
    left = (t >= t0 + width / 2 - tab * width / 2) & (t <= t0 + width / 2)
    right = ((t >= t0 + plateau + width / 2)
             & (t <= t0 + plateau + width / 2 + tab * width / 2))
    for n in range(len(bs) + 1):
        ccc[0, n][left] = np.polyder(poly_left, m=n)(
            t[left] - t0 - width / 2)
        ccc[0, n][right] = np.polyder(poly_right, m=n)(
            t[right] - t0 - plateau - width / 2)
    return np.einsum('ijk,kim->jm', B_mat, ccc)

# NB: coeff normalization intentionally *not* applied in the sinx variant,
# matching the reference (multy_drag.py:155 returns without /coeff).


def _drag_sin(t, t0, freq, width, delta, block_freq, phase, plateau=0):
    omega_x, omega_y = drag_omega_sin(t=np.asarray(t, dtype=float), t0=t0,
                                      width=width, delta=delta,
                                      block_freq=block_freq, plateau=plateau)
    wt = 2 * np.pi * (freq + delta) * t - (2 * np.pi * delta * t0 + phase)
    return omega_x * np.cos(wt) + omega_y * np.sin(wt)


def _drag_sinx(t, t0, freq, width, delta, block_freq, phase, plateau=0,
               tab=0.618):
    omega_x, omega_y = drag_omega_sin_x(t=np.asarray(t, dtype=float), t0=t0,
                                        width=width, delta=delta,
                                        block_freq=block_freq,
                                        plateau=plateau, tab=tab)
    wt = 2 * np.pi * (freq + delta) * t - (2 * np.pi * delta * t0 + phase)
    return omega_x * np.cos(wt) + omega_y * np.sin(wt)


DRAG_SIN = registerBaseFunc(_drag_sin)      # 16
DRAG_SINX = registerBaseFunc(_drag_sinx)    # 17


def drag_sin(freq, width, plateau=0, delta=0, block_freq=None, phase=0,
             t0=0) -> Waveform:
    """Multi-tone DRAG pulse with sin^m envelope."""
    phase += pi * delta * (width + plateau)
    if block_freq is not None and not hasattr(block_freq, '__len__'):
        block_freq = (float(block_freq),)
    _blocking_setup(width, delta, block_freq)   # eager validation
    return Waveform(seq=(ZERO,
                         basic_wave(DRAG_SIN, t0, freq, width, delta,
                                    block_freq, phase, plateau), ZERO),
                    bounds=(round(t0, NDIGITS),
                            round(t0 + width + plateau, NDIGITS), +inf))


def drag_sinx(freq, width, plateau=0, delta=0, block_freq=None, phase=0,
              t0=0, tab=0.618) -> Waveform:
    """Multi-tone DRAG pulse with polynomial-blended envelope edges."""
    phase += pi * delta * (width + plateau)
    if block_freq is not None and not hasattr(block_freq, '__len__'):
        block_freq = (float(block_freq),)
    _blocking_setup(width, delta, block_freq)   # eager validation
    return Waveform(seq=(ZERO,
                         basic_wave(DRAG_SINX, t0, freq, width, delta,
                                    block_freq, phase, plateau, tab), ZERO),
                    bounds=(round(t0, NDIGITS),
                            round(t0 + width + plateau, NDIGITS), +inf))
