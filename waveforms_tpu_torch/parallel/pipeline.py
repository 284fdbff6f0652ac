"""The production shot flow on one device: synthesize -> predistort ->
demodulate.

The one-device part of the JAX package's ``waveforms_tpu/parallel/
pipeline.py``: :func:`run_sequence` plays a shot table through a
:class:`~waveforms_tpu_torch.ops.Sequencer` (K1 for each shot), applies the
per-channel (b, a) pre-compensation IIR (:func:`..ops.iir.lfilter`, the
doubling scan or the recurrence kernel) and demodulates against a tone
comb (:func:`..ops.demod.demodulate`).  ``make_step`` and ``run_step``,
which synthesize over a device mesh, wait for the multi-device port.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ['run_sequence']


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
    if not ba_filters:
        return None
    from scipy.signal import lfiltic

    from ..distortion import combine_filters
    from ..ops.iir import lfilter
    b, a = combine_filters(ba_filters)
    zi = torch.as_tensor(lfiltic(b, a, np.zeros(len(a) - 1),
                                 np.zeros(len(b) - 1)), device=device)

    def apply(sig):
        return lfilter(b, a, sig.double(), zi=zi)[0]

    return apply


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
