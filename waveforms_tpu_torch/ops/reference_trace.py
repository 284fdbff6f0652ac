"""Plain PyTorch version of kernel T1, the trace evaluator on the card.

:func:`trace_eval` reads the same tape as ``csrc/trace_eval.cu``
(:mod:`.trace_tape`: the int32 records and the float64 pool) and evaluates
it segment by segment over the whole grid through the tensor halves of
:mod:`.torch_basis` (``TAPE_BASES``' ``apply``), as the eager evaluator
did: each live segment's terms -- factor values (memoized per waveform),
powers, products, the coefficient -- summed in order, clipped, masked to
the segment and summed; a ``WaveVStack`` channel its offset plus its
members over the grid less its shift, then its real part.  So the tape's
encoding is what the CPU tests hold to the JAX package, and what the
kernel is held to on the card.
"""

from __future__ import annotations

import numpy as np
import torch

from .torch_basis import TAPE_BASES
from .trace_tape import COEF_COMPLEX, COEF_ONE, Records

__all__ = ['trace_eval']


def _complex_of(dtype):
    return torch.complex128 if dtype == torch.float64 else torch.complex64


class _Reader(Records):
    def __init__(self, prog, pool, ext_re, ext_im, real):
        super().__init__(prog, pool)
        self.ext_re, self.ext_im = ext_re, ext_im
        self.real = real

    def factor(self, uf, t):
        code, shift, p = self.args(uf)
        if code == 0:
            _, _, slot, cplx = self.rec('uf', uf)
            if cplx:
                return torch.complex(self.ext_re[slot], self.ext_im[slot])
            return self.ext_re[slot]
        return TAPE_BASES[code][1](t - shift, p)

    def expr(self, tm0, nt, t, memo):
        """One segment's expression over ``t`` (the eager evaluator's
        ``_eval_expr``)."""
        acc = None
        for k in range(tm0, tm0 + nt):
            f0, nf, coff, flags = self.rec('tm', k)
            prod = None
            for j in range(f0, f0 + nf):
                uf, kind, poff, _ = self.rec('tf', j)
                vals = memo.get(uf)
                if vals is None:
                    vals = memo[uf] = self.factor(uf, t)
                if kind != 1:
                    n = self.D[poff]
                    vals = vals ** (int(n) if n.is_integer() else n)
                prod = vals if prod is None else prod * vals
            re, im = self.D[coff:coff + 2]
            v = complex(re, im) if flags & COEF_COMPLEX else re
            term = (v if prod is None else
                    prod if flags & COEF_ONE else prod * v)
            acc = term if acc is None else acc + term
        if not isinstance(acc, torch.Tensor) or acc.shape != t.shape:
            dtype = (_complex_of(t.dtype) if torch.is_tensor(acc)
                     and acc.is_complex() or isinstance(acc, complex)
                     else t.dtype)
            acc = torch.as_tensor(acc, dtype=dtype,
                                  device=t.device).expand(t.shape)
        if self.real and acc.is_complex():
            raise ValueError("a tape flagged real produced a complex value")
        return acc

    def wave(self, w, t):
        """A waveform over ``t``: each live segment clipped and masked to
        [bounds[i-1], bounds[i]), summed."""
        s0, ns, boff, clip = self.rec('wv', w)
        bounds = self.D[boff:boff + ns]
        vmin, vmax = self.D[boff + ns:boff + ns + 2]
        whole = ns == 1 and bounds[0] == np.inf
        if not whole:
            seg = torch.searchsorted(
                torch.tensor(bounds, dtype=t.dtype, device=t.device), t,
                right=True)
        memo: dict = {}
        out = None
        for s in range(ns):
            tm0, nt = self.rec('sg', s0 + s)
            if nt == 0:
                continue
            vals = self.expr(tm0, nt, t, memo)
            if clip:
                vals = torch.clamp(vals, vmin, vmax)
            part = vals if whole else torch.where(seg == s, vals, 0)
            out = part if out is None else out + part
        if out is None:
            return torch.zeros(t.shape, dtype=t.dtype, device=t.device)
        return out

    def channel(self, c, grid):
        w0, nw, coff, kind = self.rec('ch', c)
        if kind == 0:
            return self.wave(w0, grid)
        re, im, shift = self.D[coff:coff + 3]
        acc = torch.zeros(grid.shape, dtype=_complex_of(grid.dtype),
                          device=grid.device) + complex(re, im)
        t = grid - shift if shift != 0 else grid
        for w in range(w0, w0 + nw):
            acc = acc + self.wave(w, t)
        return acc.real


def trace_eval(prog, pool, grid, ext_re, ext_im, out, mode, real):
    """T1's plain version: every channel of the tape (``prog``, ``pool``)
    over ``grid`` (N,) into ``out`` (C, N) -- ``mode`` 0 the real part, 1
    the imaginary part (0 for a real channel), 2 the complex value; the
    external slots' values are ``ext_re`` (n_ext, N) and ``ext_im`` (None
    where no slot is complex).  ``real``: the tape's ``Tape.real``, which
    T1 takes as its build; raises if such a tape gives a complex value.
    Returns ``out``."""
    r = _Reader(prog, pool, ext_re, ext_im, real)
    for c in range(r.n_ch):
        v = r.channel(c, grid)
        if mode == 2:
            out[c] = v.to(out.dtype)
        elif mode == 1:
            out[c] = v.imag if v.is_complex() else 0
        else:
            out[c] = v.real if v.is_complex() else v
    return out
