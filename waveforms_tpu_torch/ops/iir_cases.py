"""The filters and the signal on which the IIR recurrence kernel S1
(``csrc/iir_df2t.cu``) and the plain model of its blocked arithmetic
(:func:`.reference_iir.df2t_blocked`) are checked: by the tests,
``chip_smoke.py`` and the tools.  Nothing on the main path uses them.

- butter(5, 0.15);
- the near-unit double pole r = 1 - 1e-8 (tests/test_ops_iir_fft.py);
- the clustered three-pole exp-settling filter, poles 1 - 1.7e-5,
  1 - 5.5e-5 and 1 - 2.5e-4 at 2 GS/s: the flagship's S1 stage, whose
  direct form amplifies rounding by ~1e10;
- a pulse-train row: 40 Gaussian pulses and a 0.5 flux step.
"""

from __future__ import annotations

import numpy as np
import torch

#: the clustered filter's ``exp_decay_filter`` amplitudes and time
#: constants (s), at the schedules' sample rate
CLUSTERED = ([0.02, 0.008, 0.004], [2e-6, 9e-6, 30e-6])


def filters() -> dict:
    """{name: (b, a)} of the three filters S1 is checked on."""
    from scipy.signal import butter

    from ..distortion import exp_decay_filter
    from ..schedules import FS
    r = 1 - 1e-8
    return {'butter5': butter(5, 0.15),
            'near_unit_double_pole': ([1.0, 0.0, 0.0], [1.0, -2 * r, r * r]),
            'clustered': exp_decay_filter(*CLUSTERED, FS, output='ba')}


def coefficients(b, a, dtype=torch.float64, device='cpu'):
    """(b, a) normalised by a[0] as S1 takes them: b then a, d + 1 each."""
    b, a = (np.asarray(v, float) for v in (b, a))
    return torch.tensor(np.concatenate([b / a[0], a / a[0]]), dtype=dtype,
                        device=device)


def pulse_train(n: int, seed: int) -> np.ndarray:
    """A float64 row of ``n`` samples: 40 Gaussian pulses (sigma 40
    samples, amplitudes 0.2-1, drawn from ``seed``) and a 0.5 flux step
    over a sixth of the row."""
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    x = np.zeros(n)
    for c in rng.uniform(0, n, 40):
        x += rng.uniform(0.2, 1.0) * np.exp(-0.5 * ((t - c) / 40.0) ** 2)
    x[n // 3:n // 3 + n // 6] += 0.5
    return x
