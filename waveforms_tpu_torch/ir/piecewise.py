"""Piecewise structure: segment mergers and the numpy oracle evaluator.

A *piecewise waveform* is ``(bounds, seq)``: ``bounds`` is an ascending tuple
of segment upper bounds, always ending in ``+inf``; ``seq`` is an equal-length
tuple of IR expressions.  Sample points fall into segment ``i`` when
``bounds[i-1] <= t < bounds[i]`` (realized by ``np.searchsorted``).

This module provides:

* :func:`merge_piecewise` -- zipper-merge two piecewise waveforms under any
  binary expression operator (used by every ``+ - * | &`` on waveforms),
* :func:`wave_sum` -- N-way sum used to collapse channel stacks,
* :func:`calc_parts` -- the host-side (numpy, float64) evaluator.  This is
  the *parity oracle*; production sampling happens on TPU via the compiled
  evaluators in :mod:`waveforms_tpu.ops`.

Semantics track ``feihoo87/waveforms/waveforms/_waveform.pyx:130-235``.
"""

from __future__ import annotations

from bisect import bisect_left

import numpy as np
from numpy import inf

from .algebra import ZERO, add
from .registry import baseFunc


def merge_piecewise(b1, s1, b2, s2, oper):
    """Merge two piecewise waveforms under binary expression operator *oper*.

    Two-pointer zipper over both bound lists; adjacent segments whose merged
    expressions compare equal coalesce into one.
    """
    bounds: list = []
    seq: list = []
    i1, i2 = 0, 0
    n1, n2 = len(b1), len(b2)
    while i1 < n1 or i2 < n2:
        expr = oper(s1[i1], s2[i2])
        b = min(b1[i1], b2[i2])
        if seq and expr == seq[-1]:
            bounds[-1] = b
        else:
            bounds.append(b)
            seq.append(expr)
        if b == b1[i1]:
            i1 += 1
        if b == b2[i2]:
            i2 += 1
    return tuple(bounds), tuple(seq)


def wave_sum(waves):
    """Sum a list of ``(bounds, seq)`` piecewise waveforms.

    Incremental bisect-insert of each incoming bound; equal adjacent
    segments dedup at the end.  Matches ``_waveform.pyx:172-213`` exactly,
    including its traversal order.
    """
    if not waves:
        return ((+inf,), (ZERO,))

    bounds, seq = waves[0]
    if len(waves) == 1:
        return bounds, seq
    bounds, seq = list(bounds), list(seq)

    for bounds_, seq_ in waves[1:]:
        if len(bounds_) == 1:
            for i, s in enumerate(seq):
                seq[i] = add(s, seq_[0])
        elif len(bounds) == 1:
            only = seq[0]
            bounds = list(bounds_)
            seq = [add(only, s) for s in seq_]
        else:
            # lo = -1 for the FIRST incoming segment so the accumulated
            # leading segment (index 0) receives it too; the reference's
            # walk (lo = 0, bare insert at i == 0) dropped one side's
            # leading segment -- simplify() then DISAGREED with direct
            # evaluation left of the first bound (documented divergence,
            # docs/PARITY.md)
            lo = -1
            for b, s in zip(bounds_, seq_):
                i = bisect_left(bounds, b, lo=max(lo, 0))
                if bounds[i] > b:
                    bounds.insert(i, b)
                    seq.insert(i, add(s, seq[i]))
                    up = i - 1
                else:
                    up = i
                for j in range(lo + 1, up + 1):
                    seq[j] = add(seq[j], s)
                lo = i

    i = 0
    while i < len(bounds) - 1:
        if seq[i] == seq[i + 1]:
            del seq[i]
            del bounds[i]
        else:
            i += 1

    return tuple(bounds), tuple(seq)


def _eval_term_product(expr, x, function_lib):
    """Evaluate one segment expression on sample grid *x* (numpy path).

    Repeated factors across terms are computed once per call via a local
    memo keyed on the factor tuple.
    """
    memo: dict = {}

    def factor_values(factor):
        hit = memo.get(factor)
        if hit is None:
            fun_id, *args, shift = factor
            hit = function_lib[fun_id](x - shift, *args)
            memo[factor] = hit
        return hit

    acc = 0
    for (factors, powers), v in zip(*expr):
        prod = 1
        for factor, n in zip(factors, powers):
            vals = factor_values(factor)
            prod = prod * (vals if n == 1 else vals**n)
        acc = acc + v * prod
    return acc


def calc_parts(bounds, seq, x, function_lib=None, min=-inf, max=inf):
    """Evaluate a piecewise waveform on sorted sample grid *x*.

    Returns ``(parts, dtype)`` where ``parts`` is a list of
    ``(start, stop, values)`` covering only the non-zero segments (values may
    be a scalar for constant segments, which broadcasts on fill), and
    ``dtype`` is ``complex`` iff any part is complex.
    """
    if function_lib is None:
        function_lib = baseFunc
    edges = np.searchsorted(x, bounds)
    parts = []
    start = 0
    dtype = float
    for i, stop in enumerate(edges):
        if start < stop and seq[i] != ZERO:
            part = np.clip(_eval_term_product(seq[i], x[start:stop],
                                              function_lib), min, max)
            if (isinstance(part, complex)
                    or isinstance(part, np.ndarray)
                    and isinstance(part[0], complex)):
                dtype = complex
            parts.append((start, stop, part))
        start = stop
    return parts, dtype
