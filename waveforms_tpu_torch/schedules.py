"""The bench schedules of the repository, built with the port.

The same constructions, seeds and widths as ``bench.py``'s
``build_schedule``, ``build_mid_schedule`` and ``build_dense_schedule``
(128 channels at 2 GS/s), and as the occupancy ladder of
``tools/tpu_capture.py`` (``_ladder_chans``), so the port runs what the
JAX package's benches run without importing it.  :data:`STRATA` names each
with its span.  :func:`station_channels` is the gate-train sequence table
of ``tools/tpu_capture.py``'s ``task_seq_packed_station``.
"""

from __future__ import annotations

from functools import partial

import numpy as np

from .core import zero
from .models import chirp, cosPulse, gaussian, mixing, square

__all__ = ['FS', 'build_schedule', 'build_mid_schedule',
           'build_dense_schedule', 'build_ladder_schedule',
           'station_channels', 'STRATA']

FS = 2e9


def build_schedule(n_channels=128, seed=0):
    """Flagship: 64 XY channels of 4 DRAG-mixed 20 ns cosPulses and 64 Z
    channels of 3 edge-smoothed 80 ns squares, over 1 ms."""
    rng = np.random.default_rng(seed)
    chans = []
    for c in range(n_channels):
        if c % 2 == 0:
            x = zero()
            for _ in range(4):
                I, _ = mixing(0.5 * cosPulse(20e-9) >> rng.uniform(0, 0.9e-3),
                              freq=-150e6 - 2e6 * c,
                              phase=rng.uniform(0, 2 * np.pi),
                              DRAGScaling=1e-10)
                x += I
            chans.append(x)
        else:
            z = zero()
            for _ in range(3):
                z += 0.3 * (square(80e-9, edge=10e-9)
                            >> rng.uniform(0, 0.9e-3))
            chans.append(z)
    return chans


def build_dense_schedule(n_channels=128, duration=1e-3):
    """Occupancy 1: every sample inside a chirp x gaussian."""
    chans = []
    for c in range(n_channels):
        f1 = 300e6 + 1e6 * c
        env = gaussian(3 * duration) >> (duration / 2)
        chans.append(env * chirp(1e6, f1, duration, 0.0, 'linear'))
    return chans


def build_mid_schedule(n_channels=128, duration=524.288e-6, seed=2):
    """~1% occupancy: 25 x 200 ns mixed pulses per channel."""
    rng = np.random.default_rng(seed)
    chans = []
    for c in range(n_channels):
        x = zero()
        for _ in range(25):
            I, _ = mixing(
                0.5 * cosPulse(200e-9) >> rng.uniform(0, duration * 0.9),
                freq=-150e6 - 2e6 * c, DRAGScaling=1e-10)
            x += I
        chans.append(x)
    return chans


def build_ladder_schedule(n_pulses, n_channels=128, duration=524.288e-6,
                          seed=5):
    """Occupancy ladder: ``n_pulses`` 200 ns mixed pulses per channel over
    a 524 us window (25 pulses ~ 10% subtile occupancy, 120 ~ 39%)."""
    rng = np.random.default_rng(seed)
    chans = []
    for c in range(n_channels):
        x = zero()
        for _ in range(n_pulses):
            I, _ = mixing(
                0.5 * cosPulse(200e-9) >> rng.uniform(0, duration * 0.9),
                freq=-150e6 - 2e6 * c, DRAGScaling=1e-10)
            x += I
        chans.append(x)
    return chans


def station_channels(rng=None):
    """A lab's RB-like table: 16 schedules of 2 channels
    over 100 us, an XY channel of 12 DRAG-mixed 30 ns cosPulses at random
    phases and a Z channel of one 80 ns square at a random time.  ``rng``
    (default ``default_rng(11)``) is consumed in that order."""
    rng = np.random.default_rng(11) if rng is None else rng
    chans = []
    for _ in range(16):
        xy = zero()
        for g in range(12):
            I, _ = mixing(0.5 * cosPulse(30e-9) >> (2e-6 + g * 7.5e-6),
                          freq=-150e6, phase=float(rng.uniform(0, 6.28)),
                          DRAGScaling=1e-10)
            xy += I
        z = 0.3 * (square(80e-9, edge=10e-9)
                   >> float(rng.uniform(1e-6, 9e-5)))
        chans.append([xy, z])
    return chans


#: stratum -> (builder, stop in seconds); every stratum starts at 0
STRATA = {
    'flagship': (build_schedule, 1e-3),
    'mid': (build_mid_schedule, 524.288e-6),
    'dense': (build_dense_schedule, 1e-3),
    'ladder120': (partial(build_ladder_schedule, 120), 524.288e-6),
}
