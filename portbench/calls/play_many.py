"""``Sequencer.play_many``: each call plays the mix's ``shots`` table
indices, drawn on the card, in one launch, as ``out_dtype`` (int16 DAC
codes at the configuration's ``dac_scale``).

Compared: ``code_gap``, the largest distance in codes between a kept
call's output and the reference plane's codes (``round(x * dac_scale)``,
half to even, held to int16) over every sample of every shot.  The control
is the program's own bfloat16 store (the f32 sum rounded once), coded the
same way."""

from __future__ import annotations

from harness import MISMATCH
from table import TableCall
from reference import plane as ref_plane


class Call(TableCall):

    control = False

    def issue(self, i, span):
        import torch
        ks = self.indices(i)
        if self.control:
            return self.seq.play_many(ks, out_dtype=torch.bfloat16)
        return self.seq.play_many(ks, out_dtype=getattr(
            torch, self.mix['out_dtype']), dac_scale=self.cfg['dac_scale'])

    def output_bytes(self) -> int:
        return (self.shots * self.cfg['n_channels'] * self.n_samples
                * (2 if self.mix['out_dtype'] == 'int16' else 4))

    def _codes(self, out):
        import torch
        if out.dtype == torch.int16:
            return out.to(torch.int32)
        return ref_plane.codes(out.double(), self.cfg['dac_scale'])

    def check(self, kept):
        import torch
        scale = self.cfg['dac_scale']
        want = (self.shots, self.cfg['n_channels'], self.n_samples)
        refs, gaps = {}, []
        for _, ks, out in kept:
            if tuple(out.shape) != want:
                gaps.append({'code_gap': MISMATCH})
                continue
            gap = 0
            for s, k in enumerate(ks.tolist()):
                if k not in refs:
                    refs[k] = ref_plane.codes(self.plane(k), scale).to(
                        torch.int16)
                d = (self._codes(out[s]) - refs[k]).abs().max()
                gap = max(gap, int(d))
            gaps.append({'code_gap': gap})
        return gaps
