"""``Sequencer.play`` of one drawn point (f32), ``.double()``, then
``predistort_device`` with the configuration's Z-settle pre-compensation
and the mix's centred Hann FIR.

Compared: ``plane_gap``, over the channels of each kept call, the largest
``|y - y_ref|`` over the peak of the channel's input plane: the chain is a
low-pass filter, which leaves the XY lines' carriers little of their peak,
while the f32 plane's own rounding, which the configuration allows, passes
it; so the gap is held to the plane the chain was given.  The reference
plane is rounded to float32 (the plane the configuration states) and
pre-compensated and filtered in float64 by ``reference/chain.py``.  The control is the
program's own float32 chain (``predistort_device`` on the f32 plane)."""

from __future__ import annotations

from harness import MISMATCH
import draws
from reference import chain as ref_chain
from table import TableCall


class Call(TableCall):

    control = False

    def __init__(self, cfg, mix, seed, device):
        import torch

        import build
        super().__init__(cfg, mix, seed, device)
        self.filters = build.z_settle_filters(cfg)
        self.ker = draws.hann(mix['fir_taps'])
        self.ker_t = torch.as_tensor(self.ker, dtype=torch.float64,
                                     device=self.device)

    def issue(self, i, span):
        from waveforms_tpu_torch.ops import predistort_device
        with span('pb.play'):
            x = self.seq.play(self.indices(i)[0])
        with span('pb.chain'):
            x = x.float() if self.control else x.double()
            return predistort_device(x, filters=self.filters,
                                     ker=self.ker_t.to(x.dtype),
                                     device=self.device)

    def check(self, kept):
        zs, fs = self.cfg['z_settle'], self.cfg['sample_rate_hz']
        secs = ref_chain.sections(zs['amps'], zs['taus_s'], fs)
        want = (self.cfg['n_channels'], self.n_samples)
        gaps = []
        for _, ks, y in kept:
            if tuple(y.shape) != want:
                gaps.append({'plane_gap': MISMATCH})
                continue
            x = self.plane(int(ks[0])).float().double()
            peak = x.abs().amax(1)
            ref = ref_chain.fir_centred(ref_chain.precompensate(x, secs),
                                        self.ker)
            del x
            gap = ((y.double() - ref).abs().amax(1) / peak).max()
            gaps.append({'plane_gap': float(gap)})
            del ref
        return gaps
