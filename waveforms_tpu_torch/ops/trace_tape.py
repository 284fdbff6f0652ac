"""The trace evaluator's IR as a tape: flat tensors that kernel T1 reads.

A tape flattens one or more channels (each a ``Waveform`` with its
``bounds``, ``seq``, ``min`` and ``max``, or a ``WaveVStack`` with its
``offset``, ``shift`` and ``wlist`` members) into two arrays, uploaded once
per device:

``prog`` (int32)
    a header of :data:`HEADER` words -- the channel count, the offset of
    each record table below, the number of external slots -- then the
    tables, fixed-size records each:

    * channels (:data:`R_CH`): first waveform, waveform count, pool offset
      of (offset re, offset im, time shift), kind (0 Waveform, 1 WaveVStack);
    * waveforms (:data:`R_WV`): first segment, segment count, pool offset
      of the segment bounds (then the clip rails), whether it clips;
    * segments (:data:`R_SG`): first term, term count (0: a ZERO segment,
      no work);
    * terms (:data:`R_TM`): first term factor, factor count, pool offset of
      the coefficient (re, im), flags (:data:`COEF_COMPLEX`: a complex
      coefficient; :data:`COEF_ONE`: equal to one, no multiply);
    * term factors (:data:`R_TF`): factor, power kind (:data:`POW_KINDS`,
      8 the general ``pow``), pool offset of the power;
    * factors (:data:`R_UF`): basis ID (0: an external slot), pool offset
      of (shift, then the basis's pool slice, ``torch_basis.TAPE_BASES``'s
      ``pack``), the slice's length or the external slot, whether the
      values are complex (an external slot's plane; a built-in's slice
      holds complex arguments: its real parts, then its imaginary parts).

``pool`` (float64)
    every real number the records point at.

:class:`Records` decodes the records; the kernel is their only other
reader.

A factor whose ID has no built-in lowering (a user basis, or a user's
lowering that replaced a built-in one), or a built-in with a complex
argument that T1 does not evaluate (``torch_basis.complex_on_card``), is
an *external* slot: its values over the grid come from its lowering before
the launch -- a built-in's on the grid's device, a user basis's the host
callback, as JAX's ``pure_callback`` -- and are uploaded into an
``(n_ext, N)`` plane, with an imaginary plane beside it where a slot is
complex.  So every channel is one launch, and no channel is declined.

Tapes are cached by the IR tuples (as ``compile_waveform``'s
``lru_cache``); a tape uploads its arrays once per device.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..core import WaveVStack
from ..ir.algebra import ZERO
from .torch_basis import TAPE_BASES, complex_on_card, get_traceable, \
    is_builtin

__all__ = ['Tape', 'Records', 'tape_of', 'channel_key', 'run', 'ext_planes',
           'MODES', 'HEADER', 'POW_KINDS']

HEADER = 8
R_CH, R_WV, R_SG, R_TM, R_TF, R_UF = 4, 4, 2, 4, 4, 4
COEF_COMPLEX, COEF_ONE = 1, 2
#: power -> kind; any other power is kind 8, ``pow(x, n)``
POW_KINDS = {1: 1, 2: 2, 3: 3, -1: 4, -2: 5, 0.5: 6, -0.5: 7}
#: what a launch writes of each channel's (complex) value
MODES = {'real': 0, 'imag': 1, 'complex': 2}


class Tape:
    """One or more channels' IR as flat arrays (see the module's docstring).

    ``complex[c]`` says whether ``evaluate`` returns channel c complex
    (a complex amplitude or a complex external slot in a live segment of a
    ``Waveform``; a ``WaveVStack`` evaluates to its real part).  ``real``
    says whether every value the tape can produce is real: no complex
    coefficient, no complex external slot and no complex pool slice in any
    channel or ``WaveVStack`` member (T1 then takes its real build).
    ``ext`` holds each external slot as (basis ID, arguments, the shifts
    its grid takes, in order, complex)."""

    def __init__(self, prog, pool, complex_, ext, real):
        self.prog = prog
        self.pool = pool
        self.complex = complex_
        self.ext = ext
        self.real = real
        self._on = {}

    @property
    def n_channels(self) -> int:
        return int(self.prog[0])

    def tensors(self, device):
        """(prog, pool) on ``device``, uploaded once ('cuda' is the current
        card, as a tensor on it names it)."""
        device = torch.device(device)
        if device.type == 'cuda' and device.index is None:
            device = torch.device('cuda', torch.cuda.current_device())
        hit = self._on.get(device)
        if hit is None:
            hit = (torch.from_numpy(self.prog).to(device),
                   torch.from_numpy(self.pool).to(device))
            self._on[device] = hit
        return hit


class _Builder:
    def __init__(self):
        self.tables = {k: [] for k in ('ch', 'wv', 'sg', 'tm', 'tf', 'uf')}
        self.pool: list = []
        self.waves: dict = {}
        self.factors: dict = {}
        self.ext: list = []

    def put(self, *values) -> int:
        off = len(self.pool)
        self.pool.extend(float(v) for v in values)
        return off

    def channel(self, key) -> bool:
        if key[0] == 'w':
            _, bounds, seq, vmin, vmax = key
            w, cplx = self.wave(bounds, seq, vmin, vmax, 0.0)
            first, count, kind, offset, shift = w, 1, 0, 0, 0.0
        else:
            _, wlist, offset, shift = key
            shift = float(shift)
            idx = [self.wave(b, s, -np.inf, np.inf, shift)[0]
                   for b, s in wlist]
            # members are consecutive records: place copies where shared
            first = len(self.tables['wv']) // R_WV
            for i in idx:
                self.tables['wv'].extend(
                    self.tables['wv'][i * R_WV:(i + 1) * R_WV])
            count, kind, cplx = len(idx), 1, False
        off = self.put(complex(offset).real, complex(offset).imag, shift)
        self.tables['ch'].extend((first, count, off, kind))
        return cplx

    def wave(self, bounds, seq, vmin, vmax, vshift):
        key = (bounds, seq, vmin, vmax, vshift)
        hit = self.waves.get(key)
        if hit is not None:
            return hit
        clip = vmin != -np.inf or vmax != np.inf
        segs, cplx = [], False
        for expr in seq:
            if expr == ZERO:
                segs.append((0, 0))
                continue
            first = len(self.tables['tm']) // R_TM
            for (factors, powers), v in zip(*expr):
                cplx |= self.term(factors, powers, v, vshift)
            segs.append((first, len(expr[0])))
        if clip and cplx:
            raise RuntimeError("clamp is not supported for complex types: "
                               "a complex waveform with min/max")
        first = len(self.tables['sg']) // R_SG
        for s in segs:
            self.tables['sg'].extend(s)
        off = self.put(*bounds, vmin, vmax)
        w = len(self.tables['wv']) // R_WV
        self.tables['wv'].extend((first, len(bounds), off, int(clip)))
        self.waves[key] = (w, cplx)
        return w, cplx

    def term(self, factors, powers, v, vshift) -> bool:
        flags = (COEF_COMPLEX if isinstance(v, complex) else 0) | (
            0 if v != 1.0 else COEF_ONE)
        cplx = bool(flags & COEF_COMPLEX)
        tf = []
        for factor, n in zip(factors, powers):
            uf, fc = self.factor(factor, vshift)
            cplx |= fc
            kind = POW_KINDS.get(n, 8) if not isinstance(n, bool) else 8
            tf.extend((uf, kind, self.put(n), 0))
        first = len(self.tables['tf']) // R_TF
        self.tables['tf'].extend(tf)
        off = self.put(complex(v).real, complex(v).imag)
        self.tables['tm'].extend((first, len(factors), off, flags))
        return cplx

    def factor(self, factor, vshift):
        fun_id, *args, shift = factor
        p = TAPE_BASES[fun_id][0](*args) if is_builtin(fun_id) else None
        real = p is not None and all(isinstance(v, float) for v in p)
        card = real or (p is not None and complex_on_card(fun_id, p))
        key = (factor, None if card else vshift)
        hit = self.factors.get(key)
        if hit is not None:
            return hit
        if real:
            rec, cplx = (fun_id, self.put(shift, *p), len(p), 0), False
        elif card:
            p = [complex(v) for v in p]
            off = self.put(shift, *(v.real for v in p), *(v.imag for v in p))
            rec, cplx = (fun_id, off, len(p), 1), True
        else:
            probe = get_traceable(fun_id)(
                torch.zeros(1, dtype=torch.float64), *args)
            cplx = bool(torch.as_tensor(probe).is_complex())
            shifts = ((vshift,) if vshift != 0 else ()) + (shift,)
            self.ext.append((fun_id, tuple(args), shifts, cplx))
            rec = (0, self.put(shift), len(self.ext) - 1, int(cplx))
        uf = len(self.tables['uf']) // R_UF
        self.tables['uf'].extend(rec)
        self.factors[key] = (uf, cplx)
        return uf, cplx

    def finish(self, complex_) -> Tape:
        order = ('ch', 'wv', 'sg', 'tm', 'tf', 'uf')
        head, off = [len(complex_)], HEADER
        for k in order:
            head.append(off)
            off += len(self.tables[k])
        head.append(len(self.ext))
        prog = np.asarray(head + sum((self.tables[k] for k in order), []),
                          dtype=np.int64)
        if prog.max(initial=0) > 2**31 - 1 or len(self.pool) > 2**31 - 1:
            raise ValueError("the tape holds more than 2**31 - 1 words")
        real = not any(self.tables['uf'][3::R_UF]) and not any(
            f & COEF_COMPLEX for f in self.tables['tm'][3::R_TM])
        return Tape(prog.astype(np.int32),
                    np.asarray(self.pool, dtype=np.float64),
                    tuple(complex_), tuple(self.ext), real)


class Records:
    """A tape's records, decoded: ``rec(table, i)`` is record ``i`` of
    table 'ch', 'wv', 'sg', 'tm', 'tf' or 'uf' (the layouts above), ``D``
    the pool as a list."""

    SIZES = {'ch': R_CH, 'wv': R_WV, 'sg': R_SG, 'tm': R_TM, 'tf': R_TF,
             'uf': R_UF}

    def __init__(self, prog, pool):
        self.P = prog.tolist()
        self.D = pool.tolist()
        self.n_ch, self.n_ext = self.P[0], self.P[7]
        self.off = dict(zip(self.SIZES, self.P[1:7]))

    def rec(self, table, i):
        size = self.SIZES[table]
        at = self.off[table] + i * size
        return self.P[at:at + size]

    def args(self, uf):
        """Factor ``uf``'s (basis ID, shift, pool slice: complex values
        where the record says so; None for an external slot)."""
        code, at, n, cplx = self.rec('uf', uf)
        if code == 0:
            return 0, self.D[at], None
        p = self.D[at + 1:at + 1 + n]
        if cplx:
            p = [complex(r, i) for r, i in
                 zip(p, self.D[at + 1 + n:at + 1 + 2 * n])]
        return code, self.D[at], p


def channel_key(wav):
    """The hashable IR of a channel, as the tape cache keys it."""
    if isinstance(wav, WaveVStack):
        return ('v', tuple(tuple(m) for m in wav.wlist), wav.offset,
                wav.shift)
    return ('w', wav.bounds, wav.seq, wav.min, wav.max)


@lru_cache(maxsize=1024)
def tape_of(keys) -> Tape:
    """The tape of the channels whose :func:`channel_key`\\ s are ``keys``
    (cached)."""
    b = _Builder()
    return b.finish([b.channel(k) for k in keys])


def ext_planes(tape, grid):
    """The external slots' values over ``grid`` -> (re (n_ext, N), im or
    None), in the grid's dtype on its device; each slot's lowering sees the
    grid less its shifts, as the eager evaluator's does."""
    if not tape.ext:
        return None, None
    n = grid.shape[0]
    re = torch.empty((len(tape.ext), n), dtype=grid.dtype,
                     device=grid.device)
    im = (torch.zeros_like(re) if any(e[3] for e in tape.ext) else None)
    for i, (fun_id, args, shifts, cplx) in enumerate(tape.ext):
        t = grid
        for s in shifts:
            t = t - s
        vals = torch.as_tensor(get_traceable(fun_id)(t, *args)).to(
            grid.device)
        if vals.is_complex() and not cplx:
            raise ValueError(f"basis {fun_id} returned complex values where "
                             "its probe was real")
        vals = vals.expand(n)
        if vals.is_complex():
            re[i] = vals.real
            im[i] = vals.imag
        else:
            re[i] = vals
    return re, im


def _complex_of(dtype):
    return torch.complex128 if dtype == torch.float64 else torch.complex64


def run(tape, grid, mode) -> torch.Tensor:
    """Every channel of ``tape`` over the 1-D float64 or float32 ``grid``
    in one launch of T1 (on a CPU tensor its plain version) -> (C, N):
    the real part (``mode`` 'real'), the imaginary part ('imag', real
    channels 0) in the grid's dtype, or the complex value ('complex'); a
    real tape (``tape.real``) in T1's real build."""
    from .. import kernels
    if grid.dtype not in (torch.float64, torch.float32):
        raise ValueError(f"the trace evaluator takes a float64 or float32 "
                         f"grid, got {grid.dtype}")
    grid = grid.contiguous()
    m = MODES[mode]
    out = torch.empty((tape.n_channels, grid.shape[0]),
                      dtype=_complex_of(grid.dtype) if m == 2
                      else grid.dtype, device=grid.device)
    if out.numel() == 0:
        return out
    prog, pool = tape.tensors(grid.device)
    re, im = ext_planes(tape, grid)
    return kernels.trace_eval(prog, pool, grid, re, im, out, m, tape.real)
