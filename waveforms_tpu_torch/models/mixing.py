"""IQ mixing with DRAG derivative correction, and the symbolic d/dt.

Matches ``feihoo87/waveforms/waveforms/waveform.py:1055-1071,1487-1527``.
Everything stays symbolic: ``D`` maps the exact IR derivative over segments,
and ``mixing`` is plain waveform algebra, so the whole I/Q pair lowers to a
single fused device kernel at sampling time.
"""

from __future__ import annotations

import numpy as np
from numpy import pi

from ..core import Waveform, zero
from ..ir.calculus import D as _D_expr
from .shapes import cos, sin

__all__ = ['D', 'mixing']


def D(wav: Waveform, d: int = 1) -> Waveform:
    """Exact d-th time derivative of a waveform.

    Parameters
    ----------
    wav : Waveform
        The waveform to differentiate.
    d : int, optional
        Order of the derivative (non-negative), by default 1.
    """
    assert d >= 0 and isinstance(d, int), "d must be a non-negative integer"
    if d == 0:
        return wav
    if d == 1:
        return Waveform(bounds=wav.bounds,
                        seq=tuple(_D_expr(x) for x in wav.seq))
    return D(D(wav, d - 1), 1)


def mixing(I: Waveform,
           Q: Waveform | None = None,
           *,
           phase: float = 0.0,
           freq: float = 0.0,
           ratioIQ: float = 1.0,
           phaseDiff: float = 0.0,
           block_freq: float | None = None,
           DRAGScaling: float | None = None) -> tuple[Waveform, Waveform]:
    """SSB (freq != 0) or envelope (freq == 0) mixing of an I/Q pair.

    DRAG correction is applied either via a blocking frequency
    (``block_freq``: I' = a*I + b/2pi * D(Q), a = bf/(bf-f), b = 1/(bf-f))
    or via a plain scaling (``DRAGScaling``: I' = (1-w*s)*I - s*D(Q)).
    """
    if Q is None:
        Q = zero()

    w = 2 * pi * freq
    if freq != 0.0:
        # single-sideband mixing
        Iout = I * cos(w, -phase) + Q * sin(w, -phase)
        Qout = -I * sin(w, -phase + phaseDiff) + Q * cos(w, -phase + phaseDiff)
    else:
        # envelope mixing: scalar rotation
        Iout = I * np.cos(-phase) + Q * np.sin(-phase)
        Qout = -I * np.sin(-phase) + Q * np.cos(-phase)

    if block_freq is not None and block_freq != freq:
        a = block_freq / (block_freq - freq)
        b = 1 / (block_freq - freq)
        Inew = a * Iout + b / (2 * pi) * D(Qout)
        Qnew = a * Qout - b / (2 * pi) * D(Iout)
        Iout, Qout = Inew, Qnew
    elif DRAGScaling is not None and DRAGScaling != 0:
        # 2*pi*scaling*(freq - block_freq) = 1
        Inew = (1 - w * DRAGScaling) * Iout - DRAGScaling * D(Qout)
        Qnew = (1 - w * DRAGScaling) * Qout + DRAGScaling * D(Iout)
        Iout, Qout = Inew, Qnew

    Qout = ratioIQ * Qout
    return Iout, Qout
