"""``parallel.run_sequence``: each call runs the mix's ``shots`` table
indices, drawn on the card, through the shot loop -- synthesis (K1's shot
entry), the configuration's Z-settle pre-compensation in float64 and the
demodulation at its readout tones -> (shots, channels, tones) IQ points.

Compared: ``iq_gap``, over the channels of each kept call, the largest
``|iq - iq_ref|`` over the channel's largest ``|iq_ref|`` in the table.
The reference plane is rounded to float32 (the plane the configuration
states), pre-compensated in float64 and demodulated in float64 by
``reference/chain.py``.  The control is the program's own float32
pre-compensation in the same shot loop: its filter made for float32
signals (``ops.iir._lfilter_apply`` on a float32 tensor, S1's float32
build), one precision below the float64 that the configuration states.
"""

from __future__ import annotations

import contextlib

from harness import MISMATCH
from reference import chain as ref_chain
from table import TableCall


@contextlib.contextmanager
def float32_precompensation():
    """The program's shot loop with its pre-compensation made for float32
    signals: the same coefficients, S1 in float32."""
    import torch

    from waveforms_tpu_torch.ops.iir import _lfilter_apply
    from waveforms_tpu_torch.parallel import pipeline

    def make(ba_filters, device, n):
        coeffs = pipeline._postfilter_coeffs(ba_filters)
        filt = _lfilter_apply(*coeffs, n, torch.empty(
            (), dtype=torch.float32, device=device))
        return lambda sig: filt(sig.float())[0]

    made = pipeline._make_postfilter
    pipeline._make_postfilter = make
    try:
        yield
    finally:
        pipeline._make_postfilter = made


class Call(TableCall):

    control = False

    def __init__(self, cfg, mix, seed, device):
        import build
        super().__init__(cfg, mix, seed, device)
        self.filters = build.z_settle_filters(cfg)
        self.tones = cfg[mix['tones']]

    def issue(self, i, span):
        from waveforms_tpu_torch.parallel import run_sequence
        with (float32_precompensation() if self.control
              else contextlib.nullcontext()):
            return run_sequence(self.seq, self.indices(i),
                                ba_filters=self.filters,
                                demod_freqs=self.tones)

    def reference_iq(self):
        """IQ points of every table point, (points, channels, tones), the
        chain in float64."""
        import torch
        zs, fs = self.cfg['z_settle'], self.cfg['sample_rate_hz']
        secs = ref_chain.sections(zs['amps'], zs['taus_s'], fs)
        out = []
        for k in range(self.cfg['points']):
            y = ref_chain.precompensate(self.plane(k).float().double(), secs)
            out.append(ref_chain.demod(y, self.tones, fs))
        return torch.stack(out)

    def check(self, kept):
        import torch
        ref = self.reference_iq()
        scale = ref.abs().amax(dim=(0, 2))                   # per channel
        want = (self.shots, self.cfg['n_channels'], len(self.tones))
        gaps = []
        for _, ks, iq in kept:
            if tuple(iq.shape) != want:
                gaps.append({'iq_gap': MISMATCH})
                continue
            d = (iq.to(torch.complex128) - ref[ks.long()]).abs()
            gaps.append({'iq_gap': float((d.amax(dim=(0, 2)) / scale).max())})
        return gaps
