"""`Waveform` and `WaveVStack`: the user-facing piecewise-waveform objects.

A :class:`Waveform` is an immutable-ish container of the piecewise IR
(``bounds``/``seq``; see :mod:`waveforms_tpu.ir`) plus optional sampling
metadata (``start``/``stop``/``sample_rate``), clip limits, and an SOS filter
chain.  All arithmetic stays symbolic; nothing touches a sample grid until
``sample()``/``__call__``.

A :class:`WaveVStack` is a lazy vertical stack of N component waveforms --
the channel-batching primitive: ``+`` and ``>>`` are O(1) (stored offsets),
and sampling accumulates all components into one buffer.  On TPU a stack maps
to a ``(channels, samples)`` batched kernel launch (see
``waveforms_tpu.ops.pallas_synth``).

API and wire formats match the reference implementation
(``feihoo87/waveforms/waveforms/waveform.py:125-895``); the flat-list and tree
serializations round-trip bit-for-bit.
"""

from __future__ import annotations

import contextlib
from typing import Generator, Iterable, cast

import numpy as np
from numpy import inf
from numpy.typing import NDArray

from .ir.algebra import NDIGITS, ZERO, add, const as _const, mul, \
    pow as _pow, shift as _shift
from .ir.canonical import filter as _filter_expr, simplify as _simplify_expr
from .ir.piecewise import calc_parts, merge_piecewise, wave_sum
from .ir.registry import baseFunc
from .utils.latexfmt import expr_latex, num_latex

_ONE = _const(1.0)


def _sos_about(filters, sig, zi=None):
    """Run an SOS chain around a DC operating point.

    ``filters`` is ``(sos, initial)``: the filter acts on the deviation from
    ``initial`` (a flux-bias line sits at a setpoint; only the excursion is
    distorted).  Returns ``(filtered, new_state)``; pass ``zi`` to stream.
    """
    from scipy.signal import sosfilt

    sos, level = filters
    sos = np.array(sos, dtype=float, copy=True)
    x = sig - level if level else sig
    if zi is None:
        y = sosfilt(sos, x)
        state = None
    else:
        y, state = sosfilt(sos, x, zi=zi)
    if level:
        y = y + level
    return cast(np.ndarray, y), state


class Waveform:
    __slots__ = ('bounds', 'seq', 'max', 'min', 'start', 'stop',
                 'sample_rate', 'filters', 'label')

    def __init__(self, bounds=(+inf,), seq=(ZERO,), min=-inf, max=inf):
        self.bounds = bounds
        self.seq = seq
        self.max = max
        self.min = min
        self.start = self.stop = self.sample_rate = None
        self.filters: tuple[np.ndarray, float] | None = None
        self.label = None

    # -- extent ------------------------------------------------------------

    @staticmethod
    def _begin(bounds, seq):
        """Lower edge of the first non-zero segment (-inf if unbounded)."""
        for i, expr in enumerate(seq):
            if expr != ZERO:
                return bounds[i - 1] if i else -inf
        return inf

    @staticmethod
    def _end(bounds, seq):
        """Upper edge of the last non-zero segment (+inf if unbounded)."""
        last = len(seq) - 1
        for i in range(last, -1, -1):
            if seq[i] != ZERO:
                return bounds[i] if i < last else inf
        return -inf

    @property
    def begin(self):
        edge = self._begin(self.bounds, self.seq)
        return edge if self.start is None else max(self.start, edge)

    @property
    def end(self):
        edge = self._end(self.bounds, self.seq)
        return edge if self.stop is None else min(self.stop, edge)

    # -- sampling (host oracle path) ----------------------------------------

    def sample(
        self,
        sample_rate=None,
        out: np.ndarray | None = None,
        chunk_size=None,
        function_lib=None,
        filters: tuple[np.ndarray, float] | None = None,
    ) -> np.ndarray | Iterable[np.ndarray]:
        """Sample on ``arange(start, stop, 1/sample_rate)``.

        With ``chunk_size`` set, returns a generator of chunks with IIR
        filter state carried across chunk boundaries (streaming AWG upload).
        """
        if sample_rate is None:
            sample_rate = self.sample_rate
        if self.start is None or self.stop is None or sample_rate is None:
            raise ValueError(
                f'Waveform is not initialized. {self.start=}, {self.stop=}, '
                f'{sample_rate=}')
        if filters is None:
            filters = self.filters
        if chunk_size is not None:
            return self._sample_iter(sample_rate, chunk_size, out,
                                     function_lib, filters)
        x = np.arange(self.start, self.stop, 1 / sample_rate)
        sig = cast(np.ndarray,
                   self.__call__(x, out=out, function_lib=function_lib))
        if filters is not None:
            sig, _ = _sos_about(filters, sig)
        return sig

    def _sample_iter(
        self, sample_rate, chunk_size, out: np.ndarray | None, function_lib,
        filters: tuple[np.ndarray, float] | None,
    ) -> Generator[np.ndarray, None, None]:
        # per-section biquad state, carried across chunk boundaries so the
        # streamed result equals one monolithic sosfilt pass
        zi = (np.zeros((np.atleast_2d(np.asarray(filters[0])).shape[0], 2))
              if filters is not None else None)
        t0 = cast(float, self.start)
        t_end = cast(float, self.stop)
        offset = 0
        while t0 < t_end:
            t1 = t0 + chunk_size / sample_rate
            if t1 > t_end:
                t1 = t_end
                n = round((t_end - t0) * sample_rate)
            else:
                n = chunk_size
            # linspace (not arange) so each chunk's grid is anchored at its
            # own start; float accumulation of t0 matches the unchunked grid
            # to ulp over millions of samples
            x = np.linspace(t0, t1, n, endpoint=False)

            if filters is None:
                target = None if out is None else out[offset:]
                yield cast(np.ndarray,
                           self.__call__(x, out=target,
                                         function_lib=function_lib))
            else:
                raw = cast(np.ndarray,
                           self.__call__(x, function_lib=function_lib))
                sig, zi = _sos_about(filters, raw, zi)
                if out is not None:
                    out[offset:offset + n] = sig
                yield sig

            t0 = t1
            offset += chunk_size

    # -- serialization -------------------------------------------------------
    # Flat-list wire format, recursive segment encoding
    # (cf. feihoo87/waveforms/waveforms/waveform.py:259-382): per waveform
    #   [nseg, (bound, nsum, (amp, nmul, (n, nfun, *fun))*)*]

    @staticmethod
    def _tolist(bounds, seq, ret=None):
        """Append the recursive segment encoding of (bounds, seq):
        ``nseg, (bound, nterm, (amp, nfac, (power, nfun, *factor))..)..``"""
        out = [] if ret is None else ret
        out.append(len(bounds))
        for b, (terms, amps) in zip(bounds, seq):
            out += [b, len(amps)]
            for (factors, powers), amp in zip(terms, amps):
                out += [amp, len(powers)]
                for fun, n in zip(factors, powers):
                    out += [n, len(fun), *fun]
        return out

    @staticmethod
    def _fromlist(l, pos=0):
        """Decode one waveform's segment encoding starting at ``pos``;
        returns (bounds, seq, next_pos)."""
        cur = pos

        def grab(k):
            nonlocal cur
            piece = tuple(l[cur:cur + k])
            if len(piece) != k:
                raise ValueError('Invalid waveform format')
            cur += k
            return piece

        (nseg,) = grab(1)
        bounds, seq = [], []
        for _ in range(int(nseg)):
            b, nterm = grab(2)
            terms, amps = [], []
            for _ in range(int(nterm)):
                amp, nfac = grab(2)
                factors, powers = [], []
                for _ in range(int(nfac)):
                    n, nfun = grab(2)
                    powers.append(n)
                    factors.append(grab(int(nfun)))
                amps.append(amp)
                terms.append((tuple(factors), tuple(powers)))
            bounds.append(b)
            seq.append((tuple(terms), tuple(amps)))
        return tuple(bounds), tuple(seq), cur

    def tolist(self):
        header = [self.max, self.min, self.start, self.stop,
                  self.sample_rate]
        if self.filters is None:
            header.append(None)
        else:
            sos, level = self.filters
            coeffs = list(np.asarray(sos).reshape(-1))
            header += [len(coeffs), *coeffs, level]
        return self._tolist(self.bounds, self.seq, header)

    @classmethod
    def fromlist(cls, l):
        w = cls()
        w.max, w.min, w.start, w.stop, w.sample_rate, n_sos = l[:6]
        pos = 6
        if n_sos is not None:
            w.filters = (np.array(l[pos:pos + n_sos]).reshape(-1, 6),
                         l[pos + n_sos])
            pos += n_sos + 1
        w.bounds, w.seq, pos = cls._fromlist(l, pos)
        return w

    def totree(self):
        header = (self.max, self.min, self.start, self.stop,
                  self.sample_rate, self.filters)
        body = tuple(
            (b, tuple((amp, tuple(zip(powers, factors)))
                      for (factors, powers), amp in zip(*expr)))
            for b, expr in zip(self.bounds, self.seq))
        return header, body

    @staticmethod
    def fromtree(tree):
        header, body = tree
        w = Waveform()
        (w.max, w.min, w.start, w.stop, w.sample_rate, w.filters) = header
        w.bounds = tuple(b for b, _ in body)
        w.seq = tuple(
            (tuple((tuple(f for _, f in packed), tuple(n for n, _ in packed))
                   for _, packed in seg),
             tuple(amp for amp, _ in seg))
            for _, seg in body)
        return w

    # -- canonicalization ----------------------------------------------------

    def simplify(self, eps=1e-15):
        """Canonicalize every segment; coalesce equal adjacent segments
        (keeping the later bound)."""
        bounds: list = []
        seq: list = []
        for b, expr in zip(self.bounds, self.seq):
            expr = _simplify_expr(expr, eps)
            if seq and expr == seq[-1]:
                bounds[-1] = b
            else:
                bounds.append(b)
                seq.append(expr)
        return Waveform(tuple(bounds), tuple(seq))

    def filter(self, low=0, high=inf, eps=1e-15):
        """Band-pass by carrier frequency, per segment."""
        return Waveform(self.bounds,
                        tuple(_filter_expr(expr, low, high, eps)
                              for expr in self.seq))

    # -- algebra -------------------------------------------------------------

    def _comb(self, other: 'Waveform', oper) -> 'Waveform':
        return Waveform(*merge_piecewise(self.bounds, self.seq, other.bounds,
                                         other.seq, oper))

    def __pow__(self, n) -> 'Waveform':
        return Waveform(self.bounds, tuple(_pow(w, n) for w in self.seq))

    def __add__(self, other) -> 'Waveform':
        if isinstance(other, Waveform):
            return self._comb(other, add)
        return self + const(other)

    def __radd__(self, v) -> 'Waveform':
        return const(v) + self

    def __mul__(self, other) -> 'Waveform':
        if isinstance(other, Waveform):
            return self._comb(other, mul)
        return self * const(other)

    def __rmul__(self, v) -> 'Waveform':
        return const(v) * self

    def __truediv__(self, other) -> 'Waveform':
        if isinstance(other, Waveform):
            raise TypeError('division by waveform')
        return self * const(1 / other)

    def __neg__(self) -> 'Waveform':
        return -1 * self

    def __sub__(self, other) -> 'Waveform':
        return self + (-other)

    def __rsub__(self, v) -> 'Waveform':
        return v + (-self)

    def __rshift__(self, time) -> 'Waveform':
        return Waveform(
            tuple(round(b + time, NDIGITS) for b in self.bounds),
            tuple(_shift(expr, time) for expr in self.seq))

    def __lshift__(self, time) -> 'Waveform':
        return self >> (-time)

    # -- boolean/marker helpers ----------------------------------------------

    def __ior__(self, other) -> 'Waveform':
        return self | other

    def __or__(self, other) -> 'Waveform':
        if isinstance(other, (int, float, complex)):
            other = const(other)

        def _or(a, b):
            return _ONE if (a != ZERO or b != ZERO) else ZERO

        return self._comb(other, _or)

    def __iand__(self, other) -> 'Waveform':
        return self & other

    def __and__(self, other) -> 'Waveform':
        if isinstance(other, (int, float, complex)):
            other = const(other)

        def _and(a, b):
            return _ONE if (a != ZERO and b != ZERO) else ZERO

        return self._comb(other, _and)

    @property
    def marker(self) -> 'Waveform':
        """0/1 indicator of where the (simplified) waveform is non-zero."""
        w = self.simplify()
        return Waveform(w.bounds,
                        tuple(ZERO if s == ZERO else _ONE for s in w.seq))

    def _active_intervals(self):
        """Maximal ``(lo, hi)`` runs where the simplified waveform != 0."""
        w = self.simplify()
        runs = []
        lo = -inf
        for i, s in enumerate(w.seq):
            hi = w.bounds[i]
            if s != ZERO:
                if runs and runs[-1][1] == lo:
                    runs[-1] = (runs[-1][0], hi)   # extend adjacent run
                else:
                    runs.append((lo, hi))
            lo = hi
        return runs

    def mask(self, edge: float = 0) -> 'Waveform':
        """0/1 gate: every active region dilated by *edge* on both sides.

        Regions whose dilations touch are merged.  The reference
        (``feihoo87/waveforms/waveforms/waveform.py:456-482``) walks segment
        transitions and closes each gate at the *first* segment of a
        multi-segment region plus ``edge``, so e.g. a ``square`` with
        smoothed edges gets its plateau masked out; here the gate spans the
        whole region, which is the evident intent.
        """
        grown = []
        for lo, hi in self._active_intervals():
            lo, hi = lo - edge, hi + edge
            if hi <= lo:
                continue    # negative edge collapsed the region: no gate
                            # (the reference's pop-guard equivalent --
                            # inverted bounds would be silently invalid)
            if grown and lo <= grown[-1][1]:
                grown[-1] = (grown[-1][0], max(hi, grown[-1][1]))
            else:
                grown.append((lo, hi))
        bounds: list = []
        seq: list = []
        for lo, hi in grown:
            if lo > -inf:
                bounds.append(lo)
                seq.append(ZERO)
            bounds.append(hi)
            seq.append(_ONE)
        if not bounds or bounds[-1] < inf:
            bounds.append(inf)
            seq.append(ZERO)
        return Waveform(tuple(bounds), tuple(seq))

    # -- evaluation ------------------------------------------------------------

    def __call__(
        self,
        x,
        frag=False,
        out: np.ndarray | list | None = None,
        accumulate=False,
        function_lib=None,
    ):
        """Evaluate on sample grid *x* (numpy oracle path).

        ``frag=True`` returns the raw non-zero parts list instead of a dense
        array.  ``out=``/``accumulate=`` allow writing into a caller buffer.
        """
        lib = baseFunc if function_lib is None else function_lib
        if np.isscalar(x) and not isinstance(x, np.ndarray):
            return cast(NDArray[np.float64],
                        self(np.array([x]), function_lib=lib))[0]
        parts, dtype = calc_parts(self.bounds, self.seq, x, lib,
                                  self.min, self.max)
        if frag:
            if out is None:
                return cast(list, parts)
            if accumulate:
                raise NotImplementedError('merging fragment lists')
            target = cast(list, out)
            target[:] = parts
            return target
        if out is None:
            out = np.zeros_like(x, dtype=dtype)
        elif not accumulate:
            out[:] = 0      # NOT out *= 0: NaN/Inf in a reused buffer
                            # would survive the multiply and poison +=
        for lo, hi, part in parts:
            out[lo:hi] += part
        return out

    # -- identity ---------------------------------------------------------------

    def __hash__(self):
        return hash((self.max, self.min, self.start, self.stop,
                     self.sample_rate, self.bounds, self.seq))

    def __eq__(self, o: object) -> bool:
        """Equality up to simplification (plus clip/window metadata)."""
        if isinstance(o, (int, float, complex)):
            o = const(o)
        if not isinstance(o, Waveform):
            return False
        a, b = self.simplify(), o.simplify()
        meta = ('max', 'min', 'start', 'stop')
        return (a.seq == b.seq and a.bounds == b.bounds
                and all(getattr(a, f) == getattr(b, f) for f in meta))

    def _repr_latex_(self):
        parts = []
        start = -np.inf
        for end, expr in zip(self.bounds, self.seq):
            parts.append(expr_latex(expr) + r",~~&t\in" +
                         f"({num_latex(start)},{num_latex(end)}" +
                         (']' if end < np.inf else ')'))
            start = end
        if len(parts) == 1:
            body = ''.join(['f(t)=', *parts[0].split('&')])
        else:
            body = '\n'.join([
                r"f(t)=\begin{cases}", (r"\\" + '\n').join(parts),
                r"\end{cases}"
            ])
        return "$$\n{}\n$$".format(body)

    # -- audio ---------------------------------------------------------------

    def _play(self, time_unit, volume=1.0):
        """Stream chunks to the sound card, auto-attenuating on clipping.

        A running peak tracker scales int16 conversion down whenever a chunk
        exceeds full scale, so later chunks never wrap (the gain only ever
        decreases -- no pumping).
        """
        CHUNK = 1024
        RATE = 48000
        peak = 1.0
        chunks = self.sample(sample_rate=RATE / time_unit, chunk_size=CHUNK)
        with _pyaudio_stream(RATE) as stream:
            for data in chunks:
                peak = max(peak, float(np.abs(data).max()))
                codes = (2**15 * 0.99 * volume / peak) * data
                stream.write(codes.astype(np.int16).tobytes())

    def play(self, time_unit=1, volume=1.0):
        import multiprocessing as mp
        mp.Process(target=self._play, args=(time_unit, volume),
                   daemon=True).start()


class WaveVStack(Waveform):
    """Lazy vertical stack of component waveforms (the batching primitive).

    Components are held un-merged; ``+`` extends the list and ``>>`` stores a
    scalar shift, both O(1).  Sampling accumulates every component into a
    single complex buffer and returns its real part
    (cf. feihoo87/waveforms/waveforms/waveform.py:638-844).
    """

    def __init__(self, wlist: Iterable[Waveform] = ()):
        self.wlist = [(w.bounds, w.seq) for w in wlist]
        self.start = self.stop = self.sample_rate = None
        self.offset = 0
        self.shift = 0
        self.filters = self.label = self.function_lib = None

    # inherited operators that need the merged IR (| & ** filter, or
    # nesting a stack as a component) would otherwise die with a bare
    # AttributeError from the un-set Waveform slot; say what to do
    @property
    def bounds(self):
        raise AttributeError(
            "WaveVStack keeps its components un-merged and has no "
            "bounds/seq -- call simplify() to collapse it into a "
            "Waveform first (also required to nest a stack inside "
            "another WaveVStack)")

    seq = bounds

    def _stack_begin(self):
        if self.wlist:
            return min(self._begin(b, s) for b, s in self.wlist)
        return -inf

    def _stack_end(self):
        if self.wlist:
            return max(self._end(b, s) for b, s in self.wlist)
        return inf

    @property
    def begin(self):
        b = self._stack_begin()
        return b if self.start is None else max(self.start, b)

    @property
    def end(self):
        e = self._stack_end()
        return e if self.stop is None else min(self.stop, e)

    def __call__(self, x, frag=False, out=None, function_lib=None):
        assert frag is False, 'WaveVStack does not support frag mode'
        if function_lib is None:
            function_lib = self.function_lib
        if function_lib is None:
            function_lib = baseFunc
        # the stored global shift moves the grid, not the components
        grid = x - self.shift if self.shift != 0 else x
        # accumulate in complex (mid-sum amplitudes may be complex); the
        # stacked result is defined as the real part
        acc = np.full_like(x, self.offset, dtype=np.complex128)
        for bounds, seq in self.wlist:
            parts, _ = calc_parts(bounds, seq, grid, function_lib)
            for lo, hi, part in parts:
                acc[lo:hi] += part
        return acc.real

    def tolist(self):
        header = [self.start, self.stop, self.offset, self.shift,
                  self.sample_rate]
        if self.filters is None:
            header.append(None)
        else:
            sos, level = self.filters
            coeffs = list(np.asarray(sos).reshape(-1))
            header += [len(coeffs), *coeffs, level]
        header.append(len(self.wlist))
        for component in self.wlist:
            self._tolist(*component, header)
        return header

    @classmethod
    def fromlist(cls, l):
        w = cls()
        w.start, w.stop, w.offset, w.shift, w.sample_rate, n_sos = l[:6]
        pos = 6
        if n_sos is not None:
            w.filters = (np.array(l[pos:pos + n_sos]).reshape(-1, 6),
                         l[pos + n_sos])
            pos += n_sos + 1
        n_components, pos = l[pos], pos + 1
        for _ in range(n_components):
            bounds, seq, pos = cls._fromlist(l, pos)
            w.wlist.append((bounds, seq))
        return w

    def simplify(self, eps=1e-15):
        """Collapse the stack into one canonical :class:`Waveform`."""
        if not self.wlist:
            # keep the DC offset and sampling metadata: the reference's
            # bare zero() changed the waveform's VALUE for offset stacks
            # (documented divergence, docs/PARITY.md)
            merged = (zero() if self.offset == 0
                      else const(self.offset).simplify(eps))
            for name in ('start', 'stop', 'sample_rate', 'filters',
                         'label'):
                setattr(merged, name, getattr(self, name))
            return merged
        merged = Waveform(*wave_sum(self.wlist))
        if self.offset != 0:
            merged += self.offset
        if self.shift != 0:
            merged >>= self.shift
        merged = merged.simplify(eps)
        for name in ('start', 'stop', 'sample_rate', 'filters', 'label'):
            setattr(merged, name, getattr(self, name))
        return merged

    @staticmethod
    def _baked(wlist, dt):
        """Component list with a global time shift folded into each IR."""
        if dt == 0:
            return list(wlist)
        return [(tuple(round(b + dt, NDIGITS) for b in bounds),
                 tuple(_shift(expr, dt) for expr in seq))
                for bounds, seq in wlist]

    def _spawn(self, wlist, **meta) -> 'WaveVStack':
        """New stack sharing this one's filters/label; other metadata
        (offset/shift/start/stop/sample_rate) only as passed explicitly --
        arithmetic results deliberately drop the sampling window, matching
        the reference operators."""
        ret = WaveVStack()
        ret.wlist = wlist
        ret.filters = self.filters
        ret.label = self.label
        for name, value in meta.items():
            setattr(ret, name, value)
        return ret

    def __rshift__(self, time):
        return self._spawn(self.wlist, start=self.start, stop=self.stop,
                           sample_rate=self.sample_rate, offset=self.offset,
                           shift=self.shift + time)

    def __add__(self, other) -> 'WaveVStack':
        # Unlike the reference (waveform.py:776-795), every branch carries
        # the surviving global shift into the result; the reference zeroes
        # it, silently un-shifting a stack built with a nonzero `>>`.
        if isinstance(other, WaveVStack):
            if other.shift == self.shift:
                # shared frame: concatenate unbaked
                return self._spawn(self.wlist + other.wlist,
                                   offset=self.offset + other.offset,
                                   shift=self.shift)
            # different frames: fold both shifts into the components
            return self._spawn(
                self._baked(self.wlist, self.shift)
                + self._baked(other.wlist, other.shift),
                offset=self.offset + other.offset)
        if isinstance(other, Waveform):
            comp = other << self.shift  # store in this stack's frame
            return self._spawn(self.wlist + [(comp.bounds, comp.seq)],
                               offset=self.offset, shift=self.shift)
        return self._spawn(list(self.wlist), offset=self.offset + other,
                           shift=self.shift)

    def __radd__(self, v) -> 'WaveVStack':
        return self + v

    def __mul__(self, other) -> 'WaveVStack':
        if isinstance(other, Waveform):
            gain = other.simplify() << self.shift
            products = [Waveform(*w) * gain for w in self.wlist]
            if self.offset != 0:
                products.append(gain * self.offset)  # offset becomes a term
            return self._spawn([(p.bounds, p.seq) for p in products],
                               shift=self.shift)
        products = [Waveform(*w) * other for w in self.wlist]
        return self._spawn([(p.bounds, p.seq) for p in products],
                           offset=self.offset * other, shift=self.shift)

    def __rmul__(self, v) -> 'WaveVStack':
        return self * v

    def __eq__(self, other) -> bool:
        if self.wlist:
            return False
        return zero() == other

    __hash__ = None  # type: ignore[assignment]

    def _repr_latex_(self):
        return r"\sum_{i=1}^{" + f"{len(self.wlist)}" + r"}" + r"f_i(t)"

    # pickle protocol: the state tuple layout is part of the wire format;
    # the user function registry travels as a dill blob (or None when it
    # cannot serialize)
    _STATE_FIELDS = ('wlist', 'start', 'stop', 'sample_rate', 'offset',
                     'shift', 'filters', 'label')

    @staticmethod
    def _dill(operation, payload):
        if not payload:
            return payload
        try:
            import dill
            return getattr(dill, operation)(payload)
        except Exception:
            return None

    def __getstate__(self) -> tuple:
        return (*[getattr(self, f) for f in self._STATE_FIELDS],
                self._dill('dumps', self.function_lib))

    def __setstate__(self, state: tuple) -> None:
        for name, value in zip(self._STATE_FIELDS, state):
            setattr(self, name, value)
        self.function_lib = self._dill('loads', state[-1])


_zero_waveform = Waveform()
_one_waveform = Waveform(seq=(_ONE,))


def zero() -> Waveform:
    return _zero_waveform


def one() -> Waveform:
    return _one_waveform


def const(c) -> Waveform:
    return Waveform(seq=(_const(1.0 * c),))


@contextlib.contextmanager
def _pyaudio_stream(rate):
    """Open a mono int16 output stream; tear down player + stream on exit."""
    import pyaudio

    player = pyaudio.PyAudio()
    try:
        stream = player.open(format=pyaudio.paInt16, channels=1, rate=rate,
                             output=True)
        try:
            yield stream
        finally:
            stream.stop_stream()
            stream.close()
    finally:
        player.terminate()


def play(data, rate=48000):
    """Blocking playback of a pre-sampled buffer through pyaudio."""
    peak = max(float(np.max(np.abs(data))), 1.0)
    codes = np.asarray(2**15 * 0.999 * (data / peak), dtype=np.int16)
    with _pyaudio_stream(rate) as stream:
        step = 1024
        for k in range(0, len(codes), step):
            stream.write(codes[k:k + step].tobytes())
