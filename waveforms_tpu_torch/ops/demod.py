"""Readout demodulation on the card: project signal frames onto tone
combs.

The port of the JAX package's ``waveforms_tpu/ops/demod.py``, the device
analog of :func:`waveforms_tpu_torch.utils.signal.getFTMatrix`: building
the ``exp(-1j(2 pi f t + phi)) * weight`` matrix and contracting the
sample axis is a matrix product, two real ones in the matrix's real dtype
(``torch.matmul``, as the JAX module leaves it to XLA outside any Pallas
kernel).
"""

from __future__ import annotations

import numpy as np
import torch

from .synth import resolve_device

__all__ = ['demod_matrix', 'demodulate']


def demod_matrix(freqs, n_samples: int, sample_rate: float, phases=None,
                 weight=None, dtype=torch.complex64,
                 device='cuda') -> torch.Tensor:
    """(n_samples, n_tones) demodulation matrix, getFTMatrix-compatible,
    on ``device``; ``dtype`` a complex torch or numpy dtype."""
    freqs = np.atleast_1d(np.asarray(freqs, dtype=float))
    t = np.linspace(0, n_samples / sample_rate, n_samples, endpoint=False)
    if phases is None:
        phases = np.zeros_like(freqs)
    if weight is None:
        weight = np.full(n_samples, 2.0 / n_samples)
    weight = np.asarray(weight, dtype=float)
    # getFTMatrix accepts per-tone integration weights too: a 2-D weight
    # is (n_tones, n_samples), one row per tone
    w = weight.T if weight.ndim == 2 else weight[:, None]
    e = w * np.exp(
        -1j * (2 * np.pi * freqs[None, :] * t[:, None]
               + np.asarray(phases)[None, :]))
    if not isinstance(dtype, torch.dtype):
        dtype = torch.from_numpy(np.zeros(0, dtype)).dtype
    return torch.from_numpy(e).to(dtype).to(resolve_device(device))


def demodulate(signals: torch.Tensor, matrix: torch.Tensor) -> torch.Tensor:
    """IQ values per (channel/shot, tone): two real matrix products.

    ``signals``: (batch, n_samples) real; ``matrix``: (n_samples, n_tones)
    complex.  Returns (batch, n_tones) complex.  The signal is cast to the
    matrix's real dtype, and the real and imaginary parts contract
    separately.  An f32 product runs at full f32 whatever the caller set:
    TF32 (``torch.backends.cuda.matmul.allow_tf32``) keeps ~3 digits, so
    the call sets the float32 matmul precision to 'highest' and restores
    the caller's setting after it.  That setting is process-wide, so the
    call is not thread-safe: a matmul on another thread during it runs at
    full f32 too, and two calls that overlap on two threads may restore
    each other's setting in the wrong order.
    """
    re_m, im_m = matrix.real, matrix.imag
    sig = signals.to(re_m.dtype)
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision('highest')
    try:
        re = sig @ re_m
        im = sig @ im_m
    finally:
        torch.set_float32_matmul_precision(prev)
    return torch.complex(re, im)
