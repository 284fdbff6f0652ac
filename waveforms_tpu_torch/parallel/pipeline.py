"""The production shot flow: synthesize -> predistort -> demodulate.

The port of the JAX package's ``waveforms_tpu/parallel/pipeline.py``.
:func:`make_step` builds the sharded production step over a device mesh
(:mod:`.mesh`): the dense kernel K1 on every shard, the per-channel (b, a)
pre-compensation IIR (:func:`..ops.iir.lfilter`, the doubling scan or the
recurrence kernel S1) on every shard, its state carried from each time
shard to the next, and readout demodulation against a tone comb
(:func:`..ops.demod.demodulate`) with the time shards' partial sums added
on one device, JAX's psum.  :func:`run_step` lowers and runs one such step.
:func:`run_sequence` plays a shot table through a
:class:`~waveforms_tpu_torch.ops.Sequencer` (K1 for each shot) on one
device through the same filter and demodulation.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ['make_step', 'run_step', 'run_sequence']


def _postfilter_coeffs(ba_filters):
    """The combined (b, a) cascade and its lfiltic zero-history initial
    state (numpy), or None."""
    if not ba_filters:
        return None
    from scipy.signal import lfiltic

    from ..distortion import combine_filters
    b, a = combine_filters(ba_filters)
    return b, a, lfiltic(b, a, np.zeros(len(a) - 1), np.zeros(len(b) - 1))


def _make_postfilter(ba_filters, device):
    """Shared (b, a)-cascade pre-compensation closure (or None): the
    lfiltic zero-history initial state and the device lfilter over every
    row, in float64.

    The JAX package runs this filter in the synthesized signal's f32, with
    a float64 result.  For a combined cascade with near-unit poles that is
    not accurate: with the station's Z-settle pair (poles 1 - 2.5e-5 and
    1 - 1.7e-4, d = 2) its shots of 4096 samples are 0.11 of the peak off
    scipy (``tests/test_torch_streaming.py``).  The port filters in f64,
    as the streaming path does."""
    coeffs = _postfilter_coeffs(ba_filters)
    if coeffs is None:
        return None
    from ..ops.iir import lfilter
    b, a, zi = coeffs
    zi = torch.as_tensor(zi, device=device)

    def apply(sig):
        return lfilter(b, a, sig.double(), zi=zi)[0]

    return apply


def make_step(low, mesh, ba_filters=None, demod_freqs=None,
              rows_per_tile: int | None = None):
    """Build the sharded production step for a lowered schedule.

    ``ba_filters``: list of (b, a) pre-compensation filters (combined and
    applied per channel).  ``demod_freqs``: tone frequencies for readout
    demodulation (None skips it).  Returns ``step() -> (signals, iq)``:
    ``signals`` a :class:`.mesh.ShardedPlane` (f32 from
    :func:`.mesh.synthesize_sharded`, float64 when filtered) and ``iq`` the
    (C, n_tones) complex64 IQ points on the mesh's first device, or None.

    The filter runs on each shard's block in float64 (as
    :func:`run_sequence`'s; the JAX package filters in f32), shard (i, j)
    starting from the final state of shard (i, j - 1), so the result is
    scipy's recurrence over the whole row.  That carry is sequential over
    the time shards, where XLA carries the associative scan's state across
    them in parallel.  Each time shard demodulates its block against its
    rows of the ``demod_matrix`` (JAX shards the matrix ``P('time',
    None)``), and the partial sums are added on the first device."""
    from ..ops.demod import demod_matrix, demodulate
    from ..ops.iir import lfilter
    from .mesh import ShardedPlane, synthesize_sharded
    first = mesh.device(0, 0)
    coeffs = _postfilter_coeffs(ba_filters)
    demod = None
    if demod_freqs is not None:
        demod = demod_matrix(demod_freqs, low.n_samples, low.sample_rate,
                             device='cpu')
    rows_on = {}                 # (first sample, device) -> demod rows

    def demod_rows(a, b, device):
        key = (a, str(device))
        if key not in rows_on:
            rows_on[key] = demod[a:b].to(device)
        return rows_on[key]

    def step():
        plane = synthesize_sharded(low, mesh, rows_per_tile=rows_per_tile)
        if coeffs is not None:
            b, a, zi0 = coeffs
            rows = []
            for row in plane.blocks:
                zi = torch.as_tensor(zi0).expand(
                    row[0].shape[0], -1).contiguous()
                out = []
                for block in row:
                    zi = zi.to(block.device)
                    if block.shape[1]:
                        block, zi = lfilter(b, a, block.double(), zi=zi)
                    else:
                        block = block.double()
                    out.append(block)
                rows.append(out)
            plane = ShardedPlane(rows, plane.shape, torch.float64)
        iq = None
        if demod is not None:
            parts = []
            for row in plane.blocks:
                acc, s0 = None, 0
                for block in row:
                    n = block.shape[1]
                    if n:
                        p = demodulate(block, demod_rows(
                            s0, s0 + n, block.device)).to(first)
                        acc = p if acc is None else acc + p
                    s0 += n
                parts.append(acc)
            iq = torch.cat(parts, 0)
        return plane, iq

    return step


def run_step(channels, start, stop, sample_rate, mesh, ba_filters=None,
             demod_freqs=None, **kw):
    """Lower, build and run one sharded production step (:func:`make_step`)
    -> (signals, iq)."""
    from ..ops.lowering import lower_schedule
    low = lower_schedule(channels, start, stop, sample_rate)
    return make_step(low, mesh, ba_filters=ba_filters,
                     demod_freqs=demod_freqs, **kw)()


def run_sequence(seq, indices, ba_filters=None, demod_freqs=None,
                 rows_per_tile: int | None = None) -> torch.Tensor:
    """Run a shot table through a
    :class:`~waveforms_tpu_torch.ops.Sequencer`, on its device.

    ``indices`` is the per-shot schedule-index array (length = number of
    shots; e.g. a randomized-benchmarking order, clamped to the table as
    ``Sequencer.play`` clamps it).  Each shot synthesizes via ``seq.play``
    (K1), applies the optional pre-compensation IIR in float64 and
    demodulates against the tone comb; the loop over shots keeps only
    each shot's IQ points, so memory stays bounded at one shot's signal
    regardless of shot count.

    Returns ``iq`` of shape (n_shots, C, n_tones) complex64 when
    ``demod_freqs`` is given, otherwise the stacked signals
    (n_shots, C, N): f32, or float64 when filtered.
    """
    filt = _make_postfilter(ba_filters, seq.device)
    demod = None
    if demod_freqs is not None:
        from ..ops.demod import demod_matrix, demodulate
        demod = demod_matrix(demod_freqs, seq.n_samples, seq.sample_rate,
                             device=seq.device)
    ks = np.asarray(indices.cpu() if isinstance(indices, torch.Tensor)
                    else indices).reshape(-1)
    outs = None
    for i, k in enumerate(ks):
        sig = seq.play(int(k), rows_per_tile=rows_per_tile)
        if filt is not None:
            sig = filt(sig)
        out = demodulate(sig, demod) if demod is not None else sig
        if outs is None:
            outs = out.new_empty((len(ks),) + tuple(out.shape))
        outs[i] = out
    if outs is None:
        raise ValueError("run_sequence needs at least one shot")
    return outs
