"""Chunked streaming synthesis with carried IIR filter state.

The port of the JAX package's ``waveforms_tpu/ops/streaming.py``, the
device analog of the reference's chunked ``Waveform.sample(chunk_size=...)``:
the dense kernel K1 takes a window (a global sample offset ``row0`` and a
width), so streaming is repeated K1 launches over successive windows of
the same descriptors, with SOS filter state ``zi`` carried across chunk
boundaries by :func:`.iir.sosfilt` (on the card each section one call of
the recurrence kernel S1 a chunk).  A bucketed schedule needs no slicing
of its descriptors: each tile of a window reads the bucket of its own
global samples.

Use cases: AWG-style upload of waveforms larger than device memory, or
latency-bounded pipelines where downstream consumes chunks as they finish.
"""

from __future__ import annotations

from typing import Generator

import numpy as np
import torch

from .iir import sosfilt
from .synth import (DeviceSchedule, default_rows_per_tile,
                    normalize_out_dtype, validate_out_mode)

__all__ = ['synthesize_stream']


def synthesize_stream(dev: DeviceSchedule, chunk_rows: int = 512,
                      rows_per_tile: int | None = None, filters=None,
                      out_dtype=None, dac_scale=32767.0
                      ) -> Generator[torch.Tensor, None, None]:
    """Yield (C, chunk_rows*128) chunks of the schedule, in time order, on
    ``dev.device``.

    ``filters = (sos, initial)`` applies per-channel SOS filtering in
    float64 with state carried across chunks (matching the host streaming
    semantics).  The final chunk is trimmed to the schedule's sample count.
    Complex (pair-mode) schedules stream complex64 chunks (complex128 when
    filtered); SOS filtering applies to the real and imaginary planes
    independently, as one batched call, and the DC ``initial`` shifts the
    real plane only.

    ``out_dtype=torch.int16`` streams exact in-kernel DAC codes scaled by
    the scalar/per-channel ``dac_scale``, bf16/f16 the f32 sum rounded
    once -- the AWG-upload use case this generator exists for.  A narrowed
    stream excludes ``filters`` (filter f32, then quantize).
    ``rows_per_tile`` is the JAX grid's tile height, checked as JAX checks
    it; K1 picks its own tiles.
    """
    from .. import kernels
    C, NB, S, T, F = dev.shape
    pair = dev.amp_im is not None
    if out_dtype is not None and normalize_out_dtype(out_dtype) != (
            torch.float32):
        if filters is not None:
            raise ValueError(
                "quantized streaming excludes filters -- stream f32, "
                "filter, then quantize host-side (codes must round once)")
        dt, scale = validate_out_mode(out_dtype, C, dac_scale, dev.device,
                                      pair=pair)
    else:
        dt, scale = (torch.complex64 if pair else torch.float32), None
    if rows_per_tile is None:
        rows_per_tile = default_rows_per_tile(
            min(dev.n_samples, chunk_rows * 128), dev.bucket_samples, NB,
            divides=chunk_rows)
    R = rows_per_tile
    if chunk_rows % R:
        raise ValueError(f"chunk_rows must be a multiple of {R}")
    tile = R * 128
    if NB > 1 and dev.bucket_samples % tile != 0:
        raise ValueError("bucket_samples must be a multiple of the tile")
    if NB > 1 and (chunk_rows * 128) % dev.bucket_samples != 0:
        raise ValueError("chunk must cover whole buckets")

    chunk = chunk_rows * 128
    n_chunks = -(-dev.n_samples // chunk)

    zi = sos = initial = None
    if filters is not None:
        sos, initial = filters
        sos = np.asarray(sos, dtype=float)
        # pair mode filters the two planes as 2C rows: one state per row
        zi = torch.zeros(((2 if pair else 1) * C, sos.shape[0], 2),
                         dtype=torch.float64, device=dev.device)

    for k in range(n_chunks):
        row0 = k * chunk
        n_out = min(chunk, dev.n_samples - row0)
        sig = torch.empty((C, n_out), dtype=dt, device=dev.device)
        kernels.synth_dense(dev, sig, scale, row0, n_out)
        if filters is not None:
            if pair:
                planes = torch.cat([sig.real.double(), sig.imag.double()])
                if initial:
                    planes[:C] -= initial
                planes, zi = sosfilt(sos, planes, zi=zi)
                if initial:
                    planes[:C] += initial
                sig = torch.complex(planes[:C], planes[C:])
            else:
                sig = sig.double()
                if initial:
                    sig = sig - initial
                sig, zi = sosfilt(sos, sig, zi=zi)
                if initial:
                    sig = sig + initial
        yield sig
