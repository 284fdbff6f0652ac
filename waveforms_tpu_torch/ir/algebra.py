"""Symbolic sum-of-products expression algebra (the lazy host-side IR).

An *expression* describes a function of time ``t`` as a sum of products of
analytic basis functions::

    expr = (terms, amps)          meaning   sum_i amps[i] * term_i(t)
    term = (factors, powers)      meaning   prod_j factor_j(t) ** powers[j]
    factor = (fun_id, *args, shift)   meaning   F[fun_id](t - shift, *args)

Everything is nested tuples, hence hashable and safely shareable.  Both
association lists (``terms``/``amps`` and ``factors``/``powers``) are kept
sorted by key with exact cancellation of zero values, so structurally equal
expressions are *representationally* equal (``==`` works, caching works).

The data layout is wire-compatible with the reference library
(``feihoo87/waveforms/waveforms/_waveform.pyx:15-127``): the flat-list and tree
serialization formats round-trip bit-for-bit against it.  The implementation
here is freshly written pure Python; on TPU the IR is never walked per-sample
-- it is lowered once to flat descriptor arrays (see
``waveforms_tpu.ops.lowering``) and sampled by fused XLA/Pallas kernels.
"""

from __future__ import annotations

from bisect import bisect_left
from itertools import product

from numpy import e, inf, pi  # noqa: F401  (re-exported convenience constants)

# Piecewise bounds are rounded to this many decimal digits wherever waveforms
# are shifted or constructed, killing float jitter when equal bounds produced
# by different arithmetic paths must compare equal
# (cf. feihoo87/waveforms/waveforms/_waveform.pyx:9).
NDIGITS = 15

#: The canonical zero expression (empty sum).
ZERO = ((), ())

#: A term with no factors: the unit constant "1" as a *term* key.
UNIT_TERM = ((), ())


def const(c):
    """Expression for the constant function ``t -> c`` (canonical form)."""
    if c == 0:
        return ZERO
    return ((UNIT_TERM,), (c,))


ONE = const(1.0)
HALF = const(1 / 2)
TWO = const(2.0)
PI = const(pi)
TWO_PI = const(2 * pi)
HALF_PI = const(pi / 2)


def is_const(expr) -> bool:
    """True if *expr* is the zero expression or a single constant term."""
    return expr == ZERO or expr[0] == (UNIT_TERM,)


def basic_wave(fun_id, *args, shift=0):
    """Expression wrapping a single registered basis function.

    Evaluates as ``F[fun_id](t - shift, *args)`` with unit amplitude.
    """
    return ((((fun_id, *args, shift),), (1,)),), (1.0,)


def _insert_pair(keys: list, vals: list, key, val, lo: int, hi: int):
    """Insert ``(key, val)`` into parallel sorted association lists.

    Values on an equal key are summed; a sum of exactly zero removes the
    entry (cancellation keeps the representation canonical).  Returns the
    new ``(lo, hi)`` search window, valid because successive inserted keys
    are themselves ascending.
    """
    i = bisect_left(keys, key, lo, hi)
    if i < hi and keys[i] == key:
        s = vals[i] + val
        if s == 0:
            del keys[i]
            del vals[i]
            return i, hi - 1
        vals[i] = s
        return i, hi
    keys.insert(i, key)
    vals.insert(i, val)
    return i, hi + 1


def add(x, y):
    """Sum of two expressions (also merges factor lists of two terms).

    Because a *term* has the same ``(sorted keys, values)`` shape as an
    expression, this single sorted-merge-with-cancellation implements both
    expression addition (amplitudes add) and term multiplication (powers of
    equal factors add; zero powers cancel).
    """
    keys, vals = list(x[0]), list(x[1])
    lo, hi = 0, len(keys)
    for k, v in zip(y[0], y[1]):
        lo, hi = _insert_pair(keys, vals, k, v, lo, hi)
    return tuple(keys), tuple(vals)


def mul(x, y):
    """Product of two expressions: cartesian product of their terms.

    Each insert searches the FULL term list: the merged keys
    ``add(tx, ty)`` are not monotone over the cartesian product, so the
    ascending-window reuse that ``add`` enjoys is invalid here -- the
    reference carried the window anyway and emitted unsorted/duplicate
    term lists for multi-term products, breaking exact cancellation and
    structural equality (documented divergence, docs/PARITY.md)."""
    keys: list = []
    vals: list = []
    for (tx, ty), (vx, vy) in zip(product(x[0], y[0]), product(x[1], y[1])):
        v = vx * vy
        if v == 0:
            continue
        _insert_pair(keys, vals, add(tx, ty), v, 0, len(keys))
    return tuple(keys), tuple(vals)


def shift(x, time):
    """Translate an expression in time: ``x(t) -> x(t - time)``.

    Implemented by adding *time* to the trailing shift slot of every factor.
    """
    if is_const(x):
        return x
    terms = []
    for factors, powers in x[0]:
        moved = tuple((fid, *args, s + time) for fid, *args, s in factors)
        terms.append((moved, powers))
    return tuple(terms), x[1]


def pow(x, n):  # noqa: A001 - mirrors the reference's public name
    """Raise an expression to a power.

    Single-term expressions accept any exponent (powers and amplitude are
    exponentiated directly); multi-term expressions require a positive
    integer and expand by repeated multiplication.
    """
    if x == ZERO:
        return ZERO
    if n == 0:
        return ONE
    if is_const(x):
        return const(x[1][0] ** n)

    if len(x[0]) == 1:
        terms, amps = [], []
        for (factors, powers), v in zip(*x):
            terms.append((factors, tuple(n * m for m in powers)))
            amps.append(v ** n)
        return tuple(terms), tuple(amps)

    assert isinstance(n, int) and n > 0
    out = ONE
    for _ in range(n):
        out = mul(out, x)
    return out
