"""FFT pipelines on the card: deconvolution kernels and reflection
correction.

The port of the JAX package's ``waveforms_tpu/ops/fft.py``, whose
transforms are ``jnp.fft``; here they are ``torch.fft`` (cuFFT on the
card).  The names map one to one, ``*_jax`` -> ``*_device``:
``reflection_jax`` -> :func:`reflection_device`,
``correct_reflection_jax`` -> :func:`correct_reflection_device`,
``extract_kernel_jax`` -> :func:`extract_kernel_device`.  Every transform
runs along the last axis, so a batch of channels goes in one call.  A
signal given as a host array goes to ``device`` (default ``'cuda'``).
"""

from __future__ import annotations

import math

import torch

from .iir import _as_signal, _like

__all__ = ['fft_convolve_centered', 'reflection_device',
           'correct_reflection_device', 'extract_kernel_device']


def fft_convolve_centered(sig, ker, device='cuda') -> torch.Tensor:
    """Zero-padded FFT convolution returning the center-aligned same-size
    cut.

    Matches the reference ``predistort`` kernel path (pad, full
    convolution, crop at the kernel center).  Every sample of the crop
    depends only on signal samples within ``len(ker) - 1`` taps, so the
    signal is padded by that much on each side, as the JAX module pads it.
    """
    sig = _as_signal(sig, device)
    ker = _like(ker, sig)
    size = sig.shape[-1]
    K = ker.shape[-1]
    pad = sig.new_zeros(sig.shape[:-1] + (K - 1,))
    padded = torch.cat([pad, sig, pad], -1)
    n = padded.shape[-1] + K - 1
    full = torch.fft.irfft(
        torch.fft.rfft(padded, n=n) * torch.fft.rfft(ker, n=n), n=n)
    start = (K - 1) + K // 2
    return full[..., start:start + size]


def _reflection_tf(freq, A, tau):
    return (1 - A) / (1 - A * torch.exp(-2j * math.pi * freq * tau))


def _freq(sig, sample_rate):
    return torch.fft.fftfreq(sig.shape[-1], 1 / sample_rate,
                             dtype=torch.float64, device=sig.device)


def reflection_device(sig, A, tau, sample_rate, device='cuda'):
    """Apply an impedance reflection in the FFT domain."""
    sig = _as_signal(sig, device)
    tf = _reflection_tf(_freq(sig, sample_rate), A, tau)
    return torch.fft.ifft(torch.fft.fft(sig) * tf).real


def correct_reflection_device(sig, A, tau, sample_rate, device='cuda'):
    """Undo an impedance reflection in the FFT domain."""
    sig = _as_signal(sig, device)
    tf = _reflection_tf(_freq(sig, sample_rate), A, tau)
    return torch.fft.ifft(torch.fft.fft(sig) / tf).real


def extract_kernel_device(sig_in, sig_out, sample_rate, bw=None, skip=0,
                          device='cuda'):
    """FFT deconvolution of a measured in/out pair (smoothing optional).

    ``skip`` trims that many samples off BOTH kernel ends, matching the
    reference ``extractKernel`` signature.
    """
    sig_in = _as_signal(sig_in, device)
    sig_out = _as_signal(sig_out, device)
    corr = torch.fft.fft(sig_in) / torch.fft.fft(sig_out)
    ker = torch.fft.ifftshift(torch.fft.ifft(corr)).real
    if bw is not None and bw < 0.5 * sample_rate:
        m = int(2 * sample_rate / bw)
        k = torch.exp(-0.5 * torch.linspace(-3.0, 3.0, m, dtype=torch.float64,
                                            device=ker.device) ** 2)
        k = (k / k.sum()).to(ker.dtype)
        n = ker.shape[-1] + m - 1
        sm = torch.fft.irfft(torch.fft.rfft(ker, n=n)
                             * torch.fft.rfft(k, n=n), n=n)
        start = (m - 1) // 2
        ker = sm[..., start:start + ker.shape[-1]]
    if skip:
        ker = ker[..., int(skip):ker.shape[-1] - int(skip)]
    return ker
