"""Basis-function registry: integer IDs -> numpy ufunc bodies.

The IR stores only integer function IDs; this module owns the table mapping
IDs to host (numpy) implementations, to symbolic-derivative rules, and to
LaTeX pretty-printers.  IDs are assigned sequentially at registration time
and the 15 built-ins below register in a fixed order, giving the stable IDs
1..15 that the wire format depends on (the multi-tone DRAG module registers
16 and 17 on import).  This mirrors the contract of the reference library
(``feihoo87/waveforms/waveforms/_waveform.pyx:264-388``); implementations are
freshly written.

The numpy table is the *oracle* path (exact float64 semantics, used by
``Waveform.__call__`` and by parity tests).  Device execution does not use
this table: the JAX/Pallas evaluators own their own traceable lowerings keyed
by the same IDs (see ``waveforms_tpu.ops``).
"""

from __future__ import annotations

import pickle
import threading

import numpy as np
from scipy.special import erf as _scipy_erf

__all__ = [
    "registerBaseFunc", "registerDerivative", "registerBaseFuncLatex",
    "packBaseFunc", "updateBaseFunc", "baseFunc", "derivativeBaseFunc",
    "baseFuncLatex", "LINEAR", "GAUSSIAN", "ERF", "COS", "SINC", "EXP",
    "INTERP", "LINEARCHIRP", "EXPONENTIALCHIRP", "HYPERBOLICCHIRP", "COSH",
    "SINH", "DRAG", "MOLLIFIER", "D_GAUSSIAN",
]

#: id -> callable(t, *args) -> ndarray        (the numpy oracle table)
baseFunc: dict = {}
#: id -> callable(shift, *args) -> expression (symbolic d/dt rules)
derivativeBaseFunc: dict = {}
#: id -> callable(shift, *args) -> str        (LaTeX formatters)
baseFuncLatex: dict = {}

_next_id = 1
# Freethreaded CPython (3.13t+) runs registrations from concurrent threads
# without a GIL serializing the id counter; per-key dict writes are atomic
# there, but the read-increment of _next_id is not -- hence the lock.
_reg_lock = threading.Lock()


def registerBaseFunc(func) -> int:
    """Register a basis function, returning its freshly assigned ID.

    Thread-safe (free-threaded CPython): concurrent registrations
    get distinct IDs."""
    global _next_id
    with _reg_lock:
        fun_id = _next_id
        _next_id += 1
        baseFunc[fun_id] = func
    return fun_id


def registerDerivative(fun_id: int, dfunc) -> None:
    """Attach a symbolic-derivative rule ``(shift, *args) -> expr``."""
    derivativeBaseFunc[fun_id] = dfunc


def registerBaseFuncLatex(fun_id: int, formatter) -> None:
    """Attach a LaTeX formatter ``(shift, *args) -> str``."""
    baseFuncLatex[fun_id] = formatter


def packBaseFunc() -> bytes:
    """Pickle the whole numpy table for transport to another process."""
    return pickle.dumps(baseFunc)


def updateBaseFunc(buf: bytes) -> None:
    """Merge a table pickled by :func:`packBaseFunc` (instrument-server use).

    Also bumps the id counter past merged IDs so a later local
    registration can never collide with a merged remote one (thread-safe
    under freethreading)."""
    global _next_id
    table = pickle.loads(buf)
    with _reg_lock:
        baseFunc.update(table)
        if table:
            _next_id = max(_next_id, max(table) + 1)


# ---------------------------------------------------------------------------
# Built-in basis functions (IDs 1..15, registration order is load-bearing).
# Formulas follow feihoo87/waveforms/waveforms/_waveform.pyx:290-371.
# ---------------------------------------------------------------------------


def hermite_coefficients(n: int) -> list[int]:
    """Coefficients (highest power first) of the physicists' Hermite H_n.

    Computed by the integer recurrence ``H_{n+1} = 2x H_n - 2n H_{n-1}``;
    exact in float64 for all orders used in practice.
    """
    h_prev, h = [1], [2, 0]  # H_0, H_1
    if n == 0:
        return h_prev
    for k in range(1, n):
        # 2x * H_k  -> shift coefficients left by one
        nxt = [2 * c for c in h] + [0]
        # minus 2k * H_{k-1}, aligned at the low end
        for i, c in enumerate(reversed(h_prev)):
            nxt[len(nxt) - 1 - i] -= 2 * k * c
        h_prev, h = h, nxt
    return h


def _linear(t):
    return t


def _gaussian(t, std_sq2):
    return np.exp(-((t / std_sq2) ** 2))


def _erf(t, std_sq2):
    return _scipy_erf(t / std_sq2)


def _cos(t, w):
    return np.cos(w * t)


def _sinc(t, bw):
    return np.sinc(bw * t)


def _exp(t, alpha):
    return np.exp(alpha * t)


def _interp(t, start, stop, points):
    return np.interp(t, np.linspace(start, stop, len(points)), points)


def _linear_chirp(t, f0, f1, T, phi0):
    return np.sin(phi0 + 2 * np.pi * ((f1 - f0) / (2 * T) * t**2 + f0 * t))


def _exponential_chirp(t, f0, alpha, phi0):
    return np.sin(phi0 + 2 * np.pi * f0 * (np.exp(alpha * t) - 1) / alpha)


def _hyperbolic_chirp(t, f0, k, phi0):
    return np.sin(phi0 + 2 * np.pi * f0 / k * np.log(1 + k * t))


def _cosh(t, w):
    return np.cosh(w * t)


def _sinh(t, w):
    return np.sinh(w * t)


def _drag(t, t0, freq, width, delta, block_freq, phase):
    """sin^2-envelope DRAG pulse, optional Y-quadrature blocking a frequency.

    Matches feihoo87/waveforms/waveforms/_waveform.pyx:343-356.
    """
    o = np.pi / width
    omega_x = np.sin(o * (t - t0)) ** 2
    wt = 2 * np.pi * (freq + delta) * t - (2 * np.pi * delta * t0 + phase)
    if block_freq is None or block_freq - delta == 0:
        return omega_x * np.cos(wt)
    b = 1 / np.pi / 2 / (block_freq - delta)
    omega_y = -b * o * np.sin(2 * o * (t - t0))
    return omega_x * np.cos(wt) + omega_y * np.sin(wt)


def mollifier_poly(d: int) -> np.poly1d:
    """The polynomial factor of the d-th mollifier derivative (d >= 1).

    Recurrence from feihoo87/waveforms/waveforms/_waveform.pyx:365-368:
    ``p_1 = -2x``; ``p_{n+1} = (x^2-1)^2 p' + (-4n x^3 + (4n-2) x) p``.
    """
    p = np.poly1d([-2, 0])
    for n in range(1, d):
        p = np.poly1d([1, 0, -2, 0, 1]) * p.deriv() + np.poly1d(
            [-4 * n, 0, 4 * n - 2, 0]) * p
    return p


def _mollifier(t, r, d):
    """Bump function exp(1/((t/r)^2-1)+1) inside |t|<r, or its d-th derivative."""
    x = t / r
    xx_1 = np.abs(x) ** 2 - 1
    if d == 0:
        return np.where(xx_1 >= 0, 0, np.exp(1 / xx_1 + 1))
    p = mollifier_poly(d)
    return np.where(xx_1 >= 0, 0,
                    np.exp(1 / xx_1 + 1) / (-xx_1) ** (2 * d)) * p(x) / r**d


def _d_gaussian(t, std_sq2, n):
    """n-th derivative of the unit gaussian, via Hermite polynomials."""
    u = t / std_sq2
    h = np.polyval(np.asarray(hermite_coefficients(n), dtype=float), u)
    return (-1) ** n / std_sq2**n * h * np.exp(-(u**2))


LINEAR = registerBaseFunc(_linear)                      # 1
GAUSSIAN = registerBaseFunc(_gaussian)                  # 2
ERF = registerBaseFunc(_erf)                            # 3
COS = registerBaseFunc(_cos)                            # 4
SINC = registerBaseFunc(_sinc)                          # 5
EXP = registerBaseFunc(_exp)                            # 6
INTERP = registerBaseFunc(_interp)                      # 7
LINEARCHIRP = registerBaseFunc(_linear_chirp)           # 8
EXPONENTIALCHIRP = registerBaseFunc(_exponential_chirp)  # 9
HYPERBOLICCHIRP = registerBaseFunc(_hyperbolic_chirp)   # 10
COSH = registerBaseFunc(_cosh)                          # 11
SINH = registerBaseFunc(_sinh)                          # 12
DRAG = registerBaseFunc(_drag)                          # 13
MOLLIFIER = registerBaseFunc(_mollifier)                # 14
D_GAUSSIAN = registerBaseFunc(_d_gaussian)              # 15
