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
exchange :func:`_all_to_all`: block copies between the shards' devices in
one process, and where the shards span processes (``owners``, the rank of
each shard) one :func:`..parallel.distributed.all_to_all` of the rows that
cross, each process holding and transforming only its own shards' blocks
(another's are None); one shard never holds more than N/P samples of one
row.  Neither the short DFT
nor the long one is a Pallas kernel in the JAX package, so the port calls
the library for both.  Every function takes a batch of rows: blocks of shape
(..., L).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ['fft_sharded', 'ifft_sharded', 'fft_convolve_sharded']


def _all_to_all(blocks, owners=None):
    """JAX's ``all_to_all(split_axis=0, concat_axis=0, tiled=False)`` over
    the shards' (..., P, L/P) blocks: shard p receives row p of every shard
    r, as its row r, on its own device.  With ``owners`` (each shard's
    rank), this process's shards hold blocks and the others None: the rows
    from another process's shards come in one all-to-all, in (source shard,
    destination shard) order."""
    if owners is None:
        return [torch.stack([b[..., p, :].to(dst.device) for b in blocks],
                            -2) for p, dst in enumerate(blocks)]
    from ..parallel import distributed
    me, world = distributed.rank(), distributed.world_size()
    mine = [r for r, o in enumerate(owners) if o == me]
    like = blocks[mine[0]]
    row = like[..., 0, :]
    pieces = [torch.cat([blocks[r][..., p, :].reshape(-1) for r in mine
                         for p, o in enumerate(owners) if o == q]
                        or [like.new_empty(0)]) for q in range(world)]
    numels = [row.numel() * sum(1 for o in owners if o == q) * len(mine)
              for q in range(world)]
    got = distributed.all_to_all(pieces, numels, like)
    # from rank q: for each of q's shards r, the rows of my shards p
    rows, taken = {}, [0] * world
    for r, q in enumerate(owners):
        for p in mine:
            k = taken[q]
            rows[r, p] = got[q][k:k + row.numel()].reshape(row.shape)
            taken[q] += row.numel()
    return [None if o != me else torch.stack(
        [rows[r, p].to(blocks[p].device) for r in range(len(owners))], -2)
        for p, o in enumerate(owners)]


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
    held = [b for b in blocks if b is not None]
    P, L = len(blocks), held[0].shape[-1]
    if L % P or any(b.shape != held[0].shape for b in held):
        raise ValueError(f"the {P} shards' blocks must share one shape whose "
                         f"last axis is a multiple of {P}")
    return P, L, held[0].dtype


def _each(fn, blocks):
    """``fn(p, block)`` over the blocks held here; None stays None."""
    return [None if b is None else fn(p, b) for p, b in enumerate(blocks)]


def fft_sharded(blocks, owners=None):
    """The P shards' contiguous blocks of x, each (..., L) complex on its
    device -> the P strided blocks of DFT(x): shard p's ``X[p + P * q]``
    for all q, on shard p's device.  L must be a multiple of P.  With
    ``owners`` (each shard's rank, on a mesh that spans processes) this
    process passes and gets its own shards' blocks, None for the rest."""
    P, L, cdt = _check(blocks)
    at = _all_to_all(_each(lambda p, b: b.reshape(b.shape[:-1]
                                                  + (P, L // P)), blocks),
                     owners)
    C = _each(lambda p, a: _dft_matrix(P, False, cdt, a.device) @ a
              * _twiddle(p, P, L, -1.0, cdt, a.device), at)
    back = _all_to_all(C, owners)
    return _each(lambda p, r: torch.fft.fft(r.reshape(r.shape[:-2] + (L,))),
                 back)


def ifft_sharded(blocks, owners=None):
    """Inverse of :func:`fft_sharded`: the P strided spectrum blocks back to
    the shards' contiguous sample blocks (the steps retraced in reverse)."""
    P, L, cdt = _check(blocks)
    rows = _each(lambda p, x: torch.fft.ifft(x), blocks)
    C = _all_to_all(_each(lambda p, r: r.reshape(r.shape[:-1]
                                                 + (P, L // P)), rows),
                    owners)
    at = _each(lambda p, c: (_dft_matrix(P, True, cdt, c.device) / P)
               @ (c * _twiddle(p, P, L, 1.0, cdt, c.device)), C)
    out = _all_to_all(at, owners)
    return _each(lambda p, b: b.reshape(b.shape[:-2] + (L,)), out)


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
    zero-pads instead.

    On a mesh that spans processes, every process passes the whole
    ``sig`` (as each JAX process holds the host array it shards), takes
    its own shards' blocks of it and returns a plane of those; the
    transposes cross processes as all-to-alls."""
    from ..parallel.mesh import Mesh, ShardedPlane
    line = (lambda g: g[0, :]) if axis == 'time' else (lambda g: g[:, 0])
    devices = list(line(mesh.devices))
    ranks = [int(o) for o in line(mesh.owners)]
    mine = [o == mesh.rank for o in ranks]
    if not any(mine):
        raise ValueError(f"this process owns no shard of the {axis!r} axis")
    owners = None if Mesh.spanning(ranks) is None else ranks
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
    xs = [sig[..., r * L:(r + 1) * L].to(device=d, dtype=cdt) if m else None
          for r, (d, m) in enumerate(zip(devices, mine))]
    X = fft_sharded(xs, owners)
    # shard p multiplies its strided spectrum X[p::P] by Kf[p::P]
    Y = _each(lambda p, x: x * torch.from_numpy(Kf[p::P]).to(
        dtype=cdt, device=x.device), X)
    out = ifft_sharded(Y, owners)
    if not sig.is_complex():
        out = _each(lambda p, o: o.real, out)
    lead = tuple(sig.shape[:-1])
    return ShardedPlane(
        [out], tuple(sig.shape), cdt if sig.is_complex() else
        torch.float64 if wide else torch.float32,
        None if owners is None else np.array([owners]),
        [[lead + (L,)] * P])
