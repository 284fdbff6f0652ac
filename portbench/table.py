"""What every call driver over a sequence table shares: the table built
from the seed, the card's pool of drawn indices, the warm-up, and the
reference plane of a table point."""

from __future__ import annotations

import draws
from harness import Spans
from reference import plane as ref_plane


class TableCall:
    """Set-up of a call over the configuration's table.

    ``issue(i, span)`` launches call ``i`` and returns its output without
    waiting; ``keep(i, out)`` is what the comparison needs of it (its
    indices and its output); ``check(kept)`` gives each kept call's
    compared numbers; ``free()`` drops the program's state before the
    reference runs."""

    def __init__(self, cfg: dict, mix: dict, seed: int, device):
        import torch

        import build
        self.cfg, self.mix, self.device = cfg, mix, torch.device(device)
        self.seq, self.lines = build.sequencer(cfg, seed, self.device)
        self.shots = int(mix.get('shots', 1))
        self.n_samples = draws.n_samples(cfg)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(draws.torch_seed(seed, 'indices'))
        self.pool = torch.randint(0, cfg['points'],
                                  (draws.index_pool_size(mix),),
                                  generator=gen, device=self.device,
                                  dtype=torch.int32)
        self.samples_per_call = (self.shots * cfg['n_channels']
                                 * self.n_samples)
        self.table_bytes_per_shot = self.table_bytes() / cfg['points']

    def indices(self, i: int):
        """Call ``i``'s drawn indices: a view of the pool on the card."""
        n = self.pool.shape[0] // self.shots
        j = (i % n) * self.shots
        return self.pool[j:j + self.shots]

    def keep(self, i, out):
        return (i, self.indices(i), out)

    def warmup(self, alive: int):
        """Run ``alive`` calls with their outputs alive together, twice:
        every shape the window uses, and the memory the window holds."""
        import torch
        for _ in range(2):
            outs = [self.issue(i, Spans(False)) for i in range(alive)]
            if self.device.type == 'cuda':
                torch.cuda.synchronize()
            del outs

    def free(self):
        """Drop the program's table; the kept outputs stay."""
        del self.seq

    def table_bytes(self) -> int:
        """Bytes of the table's descriptor tensors on the card."""
        import torch
        return sum(t.numel() * t.element_size()
                   for t in vars(self.seq).values()
                   if isinstance(t, torch.Tensor))

    def plane(self, k: int):
        """The reference plane of point ``k`` on the device, float64."""
        return ref_plane.plane(self.lines, k, self.cfg['n_channels'],
                               self.n_samples, self.cfg['sample_rate_hz'],
                               self.device)

