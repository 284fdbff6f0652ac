"""Pick a precision tier per use case, with the PyTorch/CUDA port.

Four tiers over the same schedule, each held against the float64 numpy
oracle (``engine='numpy'``):

  f32 kernels        <=1e-6 of the peak      -- DAC output, shaping
  double tier (K3)   <=1e-9 of the peak      -- simulation cross-checks
                     (float64 kernels: erf edges, gaussian derivatives,
                     cosh, mollifier bumps, every chirp)
  'torch' engine     float64 trace evaluator -- complex amplitudes, audits
  int16 DAC codes    round(f32 * full scale) within one code

Their times on the card are in PERF.md (``chip_smoke.py``'s strata); this
script measures none.

    python examples/torch_precision_tiers.py [--device cpu]
"""

import argparse
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from waveforms_tpu_torch import cos, gaussian, mixing, synthesize  # noqa: E402

FS = 2e9
SPAN = 8.192e-6


def main(device: str = 'cuda') -> None:
    I, _ = mixing(0.5 * gaussian(200e-9) >> 2e-6, freq=-150e6,
                  DRAGScaling=1e-10)
    chans = [I + (0.3 * gaussian(4e-7) * cos(2 * np.pi * 3e7) >> 5e-6)]

    oracle = synthesize(chans, 0.0, SPAN, FS, engine='numpy')
    scale = np.abs(oracle).max()

    def err(out: torch.Tensor) -> float:
        return float(np.abs(out.cpu().numpy() - oracle).max() / scale)

    f32 = synthesize(chans, 0.0, SPAN, FS, device=device)
    print(f"f32 kernel tier:    {err(f32):.2e} (dtype {f32.dtype})")

    hi = synthesize(chans, 0.0, SPAN, FS, precision='double', device=device)
    print(f"double tier:        {err(hi):.2e} (dtype {hi.dtype})")

    ev = synthesize(chans, 0.0, SPAN, FS, engine='torch', device=device)
    print(f"'torch' evaluator:  {err(ev):.2e} (dtype {ev.dtype})")

    codes = synthesize(chans, 0.0, SPAN, FS, out_dtype=torch.int16,
                       device=device)
    expect = np.clip(np.round(f32.cpu().numpy().astype(np.float64)
                              * 32767.0), -32768, 32767)
    off = int(np.abs(codes.cpu().numpy().astype(np.int64) - expect).max())
    print(f"int16 DAC codes:    max off-by {off} code(s) vs round(f32*fs)")


if __name__ == '__main__':
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--device', default='cuda',
                    help="'cuda' (default) or 'cpu'")
    main(ap.parse_args().device)
