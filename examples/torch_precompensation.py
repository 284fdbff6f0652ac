"""Transmission-line pre-compensation, end to end on the device, with the
PyTorch/CUDA port.

A flux line's step response droops as 1 - sum_i A_i exp(-t/tau_i); the
inverse (pre-compensation) filter restores a square step at the qubit.
The whole pipeline -- synthesis, the pre-compensation filter, the line
model as a check -- runs on the device:

* synthesis: ``waveforms_tpu_torch.synthesize`` (a CUDA kernel on the
  card);
* pre-compensation: ``ops.filter_zpk``, the FACTORED (zpk) form as a
  cascade of first-order sections (each real section on the card's IIR
  kernel S1).  Keep zpk end to end: clustered near-unit poles make the
  expanded (b, a) polynomial an ill-conditioned encoding.

Slow poles (tau up to 30 us at 2 GS/s) carry internal gains of ~1/(1-p)
~ 6e4, so the filtering runs in float64.

    python examples/torch_precompensation.py [--device cpu]
"""

import argparse
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from waveforms_tpu_torch import square, synthesize  # noqa: E402
from waveforms_tpu_torch.distortion import exp_decay_filter  # noqa: E402
from waveforms_tpu_torch.ops import filter_zpk  # noqa: E402


def main(device: str = 'cuda') -> None:
    fs = 2e9
    amps, taus = [0.02, 0.008, 0.004], [2e-6, 9e-6, 30e-6]

    # the line model (forward) and its inverse (pre-compensation), both
    # kept in factored zpk form
    fwd = exp_decay_filter(amps, taus, fs, output='zpk')
    inv = exp_decay_filter(amps, taus, fs, inv=True, output='zpk')

    # a 100 us flux pulse, synthesized on the device (f32), then float64
    sig = synthesize([0.5 * (square(60e-6, edge=50e-9) >> 50e-6)], 0, 100e-6,
                     fs, device=device)[0].double()

    pre = filter_zpk(*inv, sig, device=device)        # what the AWG plays
    at_qubit = filter_zpk(*fwd, pre, device=device)   # what the line delivers

    err = np.abs((at_qubit - sig).cpu().numpy())
    mid = slice(10_000, 190_000)
    print(f"samples: {sig.shape[0]} on {sig.device}")
    print(f"max |precompensated - ideal| mid-pulse: {err[mid].max():.2e}")
    print(f"uncompensated droop would be ~{sum(amps):.3f}")
    if not err[mid].max() < 1e-4:
        raise RuntimeError("the pre-compensation does not restore the step")


if __name__ == '__main__':
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--device', default='cuda',
                    help="'cuda' (default) or 'cpu'")
    main(ap.parse_args().device)
