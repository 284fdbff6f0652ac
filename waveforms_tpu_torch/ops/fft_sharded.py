"""Distributed FFT over the sample axis: the long-axis deconvolution path.

The port of the JAX package's ``waveforms_tpu/ops/fft_sharded.py``: the
four-step decomposition over the P shards of one mesh axis.  View x (length
N = P * L, shard r holding the contiguous block r) as the row-major matrix
A[r, c] (r in [0, P), c in [0, L)).  With w = exp(-2i pi / N):

    B[p, c] = DFT_P over r of A[r, c]      (short column DFTs)
    C[p, c] = B[p, c] * w^(c p)            (twiddle, elementwise)
    X[p + P q] = DFT_L over c of C[p, c]   (long row DFTs)

Step 1 becomes local after a transpose of blocks between the shards (each
then holds all P rows of an L/P column block), and is a (P, P) matrix
product (``torch.matmul``); a second transpose restores the rows for step
3's ``torch.fft.fft``.  The spectrum lands strided (shard p holds
``X[p::P]``), which is what convolution wants: multiply by an identically
distributed kernel spectrum and run the inverse, which retraces the steps
and returns the contiguous blocks.  JAX's ``all_to_all`` is the explicit
exchange :func:`_all_to_all`, block copies between the shards' devices; one
shard never holds more than N/P samples of one row.  Neither the short DFT
nor the long one is a Pallas kernel in the JAX package, so the port calls
the library for both.  Every function takes a batch of rows: blocks of shape
(..., L).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ['fft_sharded', 'ifft_sharded', 'fft_convolve_sharded']


def _all_to_all(blocks):
    """JAX's ``all_to_all(split_axis=0, concat_axis=0, tiled=False)`` over
    the shards' (..., P, L/P) blocks: shard p receives row p of every shard
    r, as its row r, on its own device."""
    return [torch.stack([b[..., p, :].to(dst.device) for b in blocks], -2)
            for p, dst in enumerate(blocks)]


def _dft_matrix(P, inverse, dtype, device):
    k = np.arange(P)
    W = np.exp((2j if inverse else -2j) * np.pi * np.outer(k, k) / P)
    return torch.from_numpy(W).to(dtype=dtype, device=device)


def _twiddle(me, P, L, sign, dtype, device):
    """The (P, L/P) twiddle block w^(sign * c p) that shard ``me`` owns --
    shared by the forward and inverse transforms."""
    c = me * (L // P) + np.arange(L // P)[None, :]
    p = np.arange(P)[:, None]
    tw = np.exp((sign * 2j * np.pi / (P * L)) * (c * p))
    return torch.from_numpy(tw).to(dtype=dtype, device=device)


def _check(blocks):
    P, L = len(blocks), blocks[0].shape[-1]
    if L % P or any(b.shape != blocks[0].shape for b in blocks):
        raise ValueError(f"the {P} shards' blocks must share one shape whose "
                         f"last axis is a multiple of {P}")
    return P, L


def fft_sharded(blocks):
    """The P shards' contiguous blocks of x, each (..., L) complex on its
    device -> the P strided blocks of DFT(x): shard p's ``X[p + P * q]``
    for all q, on shard p's device.  L must be a multiple of P."""
    P, L = _check(blocks)
    cdt = blocks[0].dtype
    at = _all_to_all([b.reshape(b.shape[:-1] + (P, L // P)) for b in blocks])
    C = [_dft_matrix(P, False, cdt, a.device) @ a
         * _twiddle(p, P, L, -1.0, cdt, a.device) for p, a in enumerate(at)]
    back = _all_to_all(C)
    return [torch.fft.fft(r.reshape(r.shape[:-2] + (L,))) for r in back]


def ifft_sharded(blocks):
    """Inverse of :func:`fft_sharded`: the P strided spectrum blocks back to
    the shards' contiguous sample blocks (the steps retraced in reverse)."""
    P, L = _check(blocks)
    cdt = blocks[0].dtype
    rows = [torch.fft.ifft(x) for x in blocks]
    C = _all_to_all([r.reshape(r.shape[:-1] + (P, L // P)) for r in rows])
    at = [(_dft_matrix(P, True, cdt, c.device) / P)
          @ (c * _twiddle(p, P, L, 1.0, cdt, c.device))
          for p, c in enumerate(C)]
    out = _all_to_all(at)
    return [b.reshape(b.shape[:-2] + (L,)) for b in out]


def fft_convolve_sharded(sig, ker, mesh, axis: str = 'time',
                         centered: bool = False):
    """Circular FFT convolution of a signal split over one mesh axis ->
    a :class:`..parallel.mesh.ShardedPlane` of the (..., N) result, one
    contiguous block per shard of ``axis`` (``gather()`` for the tensor).

    ``sig``: (..., N) real or complex tensor, split into the axis's P
    shards (on the devices of the mesh's first row or column along
    ``axis``); ``ker``: host kernel (at most N taps), zero-padded to N.
    The kernel spectrum is computed once on the host in f64 and laid out
    in the strided order the sharded FFT emits, so the pointwise product
    never crosses shards.  N must be a multiple of P^2.  A float64 or
    complex128 signal runs in complex128, anything else in complex64.

    ``centered=True`` treats the kernel's zero-lag as its CENTER tap
    (``len(ker) // 2``) -- the convention of
    :func:`.fft.extract_kernel_device` -- by rolling it before the
    transform.  This is CIRCULAR convolution either way (the first and last
    ~len(ker)/2 samples wrap); :func:`.fft.fft_convolve_centered`
    zero-pads instead."""
    from ..parallel.mesh import ShardedPlane
    devices = list(mesh.devices[0, :] if axis == 'time'
                   else mesh.devices[:, 0])
    P = len(devices)
    N = sig.shape[-1]
    if N % (P * P):
        raise ValueError(f"N ({N}) must be a multiple of P^2 ({P * P})")
    ker = np.asarray(ker, np.complex128)
    if ker.shape[-1] > N:
        raise ValueError(
            f"kernel ({ker.shape[-1]} taps) longer than the signal ({N}) "
            "-- np.fft.fft would silently truncate it")
    if centered:
        rolled = np.zeros(N, np.complex128)
        K = ker.shape[-1]
        rolled[:K] = ker
        ker = np.roll(rolled, -(K // 2))
    Kf = np.fft.fft(ker, n=N)
    wide = sig.dtype in (torch.float64, torch.complex128)
    cdt = torch.complex128 if wide else torch.complex64
    L = N // P
    xs = [sig[..., r * L:(r + 1) * L].to(device=d, dtype=cdt)
          for r, d in enumerate(devices)]
    X = fft_sharded(xs)
    # shard p multiplies its strided spectrum X[p::P] by Kf[p::P]
    Y = [x * torch.from_numpy(Kf[p::P]).to(dtype=cdt, device=x.device)
         for p, x in enumerate(X)]
    out = ifft_sharded(Y)
    if not sig.is_complex():
        out = [o.real for o in out]
    return ShardedPlane([out], tuple(sig.shape), out[0].dtype)
