"""Small host-side signal helpers (sub-sample delay, demodulation matrix).

Same surface as the reference's ``waveforms/utils.py:35-114``; the device
analog of :func:`getFTMatrix` (matmul demodulation) lives in
:mod:`waveforms_tpu_torch.ops.demod`.  Carried over from the JAX
package's ``utils/signal.py`` unchanged (numpy only).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


def shift(signal: np.ndarray, delay: float, dt: float) -> np.ndarray:
    """Delay a sampled signal by an arbitrary (sub-sample) time.

    The delay splits into ``whole`` samples plus a fraction ``frac`` of one
    sample.  The fractional part linearly interpolates each sample with its
    predecessor (a first-order all-pass approximation, fine for delays
    refined below one sample); the whole part shifts with zero fill.
    Negative delays advance the signal.
    """
    whole = int(delay // dt)
    frac = delay / dt - whole

    if frac > 0:
        mixed = (1.0 - frac) * signal
        mixed[1:] += frac * signal[:-1]
        signal = mixed
    if whole == 0:
        return signal

    out = np.roll(signal, whole)
    if whole > 0:
        out[:min(whole, len(out))] = 0
    else:
        out[max(len(out) + whole, 0):] = 0
    return out


def getFTMatrix(fList: Sequence[float],
                numOfPoints: int,
                phaseList: Optional[Sequence[float]] = None,
                weight: Optional[np.ndarray] = None,
                sampleRate: float = 1e9) -> np.ndarray:
    """Demodulation matrix projecting a signal frame onto a set of tones.

    Column ``j`` is ``weight * exp(-1j*(2*pi*f_j*t + phase_j))``, so
    ``(shots, numOfPoints) @ matrix`` yields per-tone IQ values.  ``weight``
    may be one window shared by all tones or a ``(tones, numOfPoints)``
    stack; the default window ``2/numOfPoints`` makes a unit-amplitude
    cosine demodulate to magnitude 1.

    >>> t = np.arange(500) / 1e9
    >>> sig = np.cos(2 * np.pi * 20e6 * t - 0.3)
    >>> iq = sig @ getFTMatrix([20e6], 500, sampleRate=1e9)
    >>> round(float(abs(iq[0])), 6), round(float(np.angle(iq[0])), 6)
    (1.0, -0.3)
    """
    freqs = np.asarray(fList, dtype=float).reshape(-1)
    if phaseList is None or len(phaseList) == 0:
        phases = np.zeros_like(freqs)
    else:
        phases = np.asarray(phaseList, dtype=float).reshape(-1)
    if weight is None or len(weight) == 0:
        weight = np.full(numOfPoints, 2 / numOfPoints)
    weight = np.asarray(weight)

    # per-tone inputs zip together: excess entries are ignored
    n_tones = min(len(freqs), len(phases))
    if weight.ndim > 1:
        n_tones = min(n_tones, weight.shape[0])
    freqs, phases = freqs[:n_tones], phases[:n_tones]

    t = np.linspace(0, numOfPoints / sampleRate, numOfPoints,
                    endpoint=False)
    mat = np.exp(-1j * (2 * np.pi * np.outer(t, freqs) + phases))
    if weight.ndim == 1:
        return mat * weight[:, None]
    return mat * weight[:n_tones].T
