"""Carry objects across from ``waveforms_tpu`` without importing it.

Both packages share the wire format (``tolist``/``fromlist``) and the
``LoweredSchedule`` field layout, so a waveform or a lowered schedule built
by the JAX package becomes the port's own object by value.  Nothing here
imports ``jax`` or ``waveforms_tpu``: the argument is read by duck typing.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .core import Waveform, WaveVStack
from .ops.lowering import LoweredSchedule

__all__ = ['waveform_from_jax', 'lowered_from_jax']


def waveform_from_jax(w):
    """The port's Waveform (or WaveVStack) equal to ``w``, via the wire
    format.  Basis IDs agree because both registries register the same
    built-ins in the same order."""
    cls = WaveVStack if hasattr(w, 'wlist') else Waveform
    return cls.fromlist(w.tolist())


def lowered_from_jax(low) -> LoweredSchedule:
    """Copy a JAX-side ``LoweredSchedule``'s arrays into the port's."""
    kw = {}
    for f in dataclasses.fields(LoweredSchedule):
        v = getattr(low, f.name)
        kw[f.name] = np.array(v) if isinstance(v, np.ndarray) else v
    return LoweredSchedule(**kw)
