"""Trigonometric canonicalization (``simplify``) and frequency filtering.

``simplify`` rewrites each expression into a canonical phasor form so that
algebraically equal waveforms become representationally equal:

1. cos powers expand to first-harmonic sums (``cos^n -> sum_k cos(k w t)``),
2. products of cosines expand via product-to-sum,
3. exp factors within a term merge into a single exponential,
4. gaussian powers merge into a single gaussian with scaled width,
5. terms sharing the same residual factors and carrier frequency merge as
   phasors (amplitude/phase recombination), real and imaginary parts
   tracked separately.

Behavior matches the reference (``feihoo87/waveforms/waveforms/_waveform.pyx:
483-654``) including its final-loop quirk: the DC-term threshold test reads
the amplitude variable *leaked from the previous loop* rather than the DC
amplitude itself (``_waveform.pyx:615``).  We reproduce that deliberately --
equality (`Waveform.__eq__`) and the golden serialization tests depend on
bit-identical simplify output.
"""

from __future__ import annotations

from itertools import chain, product
from math import comb

import numpy as np

from .algebra import ONE, ZERO, add, basic_wave, const, is_const, mul
from .registry import COS, EXP, GAUSSIAN



def _cos_power_to_harmonics(factor, n):
    """Expand ``cos(w(t-s))^n`` into a sum of first-power cosines."""
    _, w, s = factor
    out = ZERO
    for k in range(0, n // 2 + 1):
        if n == 2 * k:
            out = add(out, const(comb(n, k) / 2**n))
        else:
            term = (((((COS, (n - 2 * k) * w, s),), (1,)),),
                    (comb(n, k) / 2 ** (n - 1),))
            out = add(out, term)
    return out


def _cos_pair_product(fx, fy, v):
    """``v*cos(a)cos(b) -> v/2*cos(a+b) + v/2*cos(a-b)`` as an expression."""
    _, w1, t1 = fx
    _, w2, t2 = fy
    if w2 > w1:
        t1, t2 = t2, t1
        w1, w2 = w2, w1
    hi = (COS, w1 + w2, (w1 * t1 + w2 * t2) / (w1 + w2))
    if w1 == w2:
        c = v * np.cos(w1 * t1 - w2 * t2) / 2
        if c == 0:
            return (((hi,), (1,)),), (0.5 * v,)
        return (((), ()), ((hi,), (1,))), (c, 0.5 * v)
    lo = (COS, w1 - w2, (w1 * t1 - w2 * t2) / (w1 - w2))
    if lo[1] > hi[1]:
        lo, hi = hi, lo
    return (((lo,), (1,)), ((hi,), (1,))), (0.5 * v, 0.5 * v)


def _trig_mul(x, y):
    """Multiply two expressions, keeping at most one COS factor per term.

    Precondition (holds for every call site in this module): each term of
    either operand carries at most one COS factor.
    """
    if is_const(x) or is_const(y):
        return mul(x, y)
    out = ZERO
    for (tx, ty), (vx, vy) in zip(product(x[0], y[0]), product(x[1], y[1])):
        v = vx * vy
        rest = ONE
        cosines = []
        for factor, n in zip(chain(tx[0], ty[0]), chain(tx[1], ty[1])):
            if factor[0] == COS:
                cosines.append(factor)
            else:
                rest = mul(rest, ((((factor,), (n,)),), (1,)))
        if len(cosines) == 1:
            piece = mul(rest, ((((cosines[0],), (1,)),), (v,)))
        elif len(cosines) == 2:
            piece = mul(rest, _cos_pair_product(cosines[0], cosines[1], v))
        else:
            piece = mul(rest, const(v))
        out = add(out, piece)
    return out


def _reduce_term(term, v):
    """Canonicalize one term: expand cos powers, merge exp and gaussian."""
    trig = ONE
    alpha = 0
    wsum = 0            # accumulated n_i * alpha_i * shift_i
    factors, powers = [], []
    for factor, n in zip(*term):
        if factor[0] == COS and isinstance(n, (int, np.integer)) and n >= 1:
            # only positive integer powers expand to harmonics; the
            # reference's binomial walk silently ZEROED cos**-1 (empty
            # range) and crashed on fractional powers -- those pass
            # through unexpanded (documented divergence, docs/PARITY.md)
            trig = _trig_mul(trig, _cos_power_to_harmonics(factor, n))
        elif factor[0] == EXP:
            # prod e^{n_i a_i (t - s_i)} = e^{A t - W}: track A and W
            # directly -- the reference's running-shift form zeroed W
            # whenever A passed through 0, silently dropping the
            # residual constant e^{-W} (documented divergence,
            # docs/PARITY.md)
            wsum += n * factor[1] * factor[-1]
            alpha += n * factor[1]
        elif factor[0] == GAUSSIAN and n != 1:
            factors.append((factor[0], factor[1] / np.sqrt(n), factor[2]))
            powers.append(1)
        else:
            factors.append(factor)
            powers.append(n)
    amp = v if alpha != 0 or wsum == 0 else v * np.exp(-wsum)
    out = (((tuple(factors), tuple(powers)),), (amp,))
    if alpha != 0:
        out = mul(out, basic_wave(EXP, alpha, shift=wsum / alpha))
    return mul(out, trig)


def _split_carrier(term):
    """Pull the unique COS factor out of a term: ``(freq, shift, rest)``."""
    rest_factors, rest_powers = [], []
    freq, shift = 0, 0
    for factor, n in zip(*term):
        if factor[0] == COS and n == 1:
            # non-unit cos powers (negative/fractional pass-throughs)
            # stay in ``rest``: treating them as the carrier would merge
            # phasors at the wrong harmonic
            if freq != 0:
                raise ValueError("run _reduce_term first")
            freq = factor[1]
            shift = factor[-1]
        else:
            rest_factors.append(factor)
            rest_powers.append(n)
    return freq, shift, (tuple(rest_factors), tuple(rest_powers))


def simplify(expr, eps):
    """Canonicalize an expression; see module docstring for the passes."""
    merged: dict = {}
    v = 0  # NB: deliberately read after the loops (reference quirk).
    for term, v in zip(*expr):
        for term, v in zip(*_reduce_term(term, v)):
            freq, shift, rest = _split_carrier(term)
            v_r, v_i, shift_r, shift_i = v.real, v.imag, shift, shift
            if (rest, freq) in merged:
                v0_r, shift0_r, v0_i, shift0_i = merged[(rest, freq)]
                if freq == 0:
                    v_r, v_i = v.real + v0_r, v.imag + v0_i
                else:
                    a = v0_r * np.cos(freq * shift0_r) + v_r * np.cos(
                        freq * shift_r)
                    b = v0_r * np.sin(freq * shift0_r) + v_r * np.sin(
                        freq * shift_r)
                    shift_r = np.arctan2(b, a) / freq
                    v_r = np.sqrt(a**2 + b**2)

                    a = v0_i * np.cos(freq * shift0_i) + v_i * np.cos(
                        freq * shift_i)
                    b = v0_i * np.sin(freq * shift0_i) + v_i * np.sin(
                        freq * shift_i)
                    shift_i = np.arctan2(b, a) / freq
                    v_i = np.sqrt(a**2 + b**2)
            merged[(rest, freq)] = v_r, shift_r, v_i, shift_i

    out = ZERO
    for (rest, freq), (v_r, shift_r, v_i, shift_i) in merged.items():
        if freq == 0 and abs(v) >= eps:  # sic: stale `v`, see docstring
            if v_i == 0:
                out = add(out, ((rest,), (v_r,)))
            else:
                out = add(out, ((rest,), (v_r + 1j * v_i,)))
        else:
            if abs(v_i) < eps and abs(v_r) < eps:
                continue
            if abs(v_i) < eps:
                carrier = (((((COS, freq, shift_r),), (1,)),), (v_r,))
            elif abs(v_r) < eps:
                carrier = (((((COS, freq, shift_i),), (1,)),), (v_i * 1j,))
            else:
                carrier = (((((COS, freq, shift_r),), (1,)),
                            (((COS, freq, shift_i),), (1,))),
                           (v_r, v_i * 1j))
            out = add(out, mul(((rest,), (1,)), carrier))
    return out


def filter(expr, low, high, eps):  # noqa: A001 - mirrors the public name
    """Band-pass an expression by the frequency of its COS carrier.

    Terms carrying a cosine keep iff ``low <= freq < high``; carrier-free
    (DC) terms keep iff ``low <= 0``.
    """
    expr = simplify(expr, eps)
    out = ZERO
    for term, v in zip(*expr):
        carrier = next((f for f in term[0] if f[0] == COS), None)
        if carrier is not None:
            if low <= carrier[1] < high:
                out = add(out, ((term,), (v,)))
        elif low <= 0:
            out = add(out, ((term,), (v,)))
    return out
