"""The bench schedules of the repository, built with the port.

The same constructions, seeds and widths as ``bench.py``'s
``build_schedule``, ``build_mid_schedule`` and ``build_dense_schedule``
(128 channels at 2 GS/s), and as the occupancy ladder of
``tools/tpu_capture.py`` (``_ladder_chans``), so the port runs what the
JAX package's benches run without importing it.  :data:`STRATA` names each
with its span.  :func:`station_channels` is the gate-train sequence table
of ``tools/tpu_capture.py``'s ``task_seq_packed_station``.

The JAX suite's cross-engine schedules, built with the port from the same
seeds: :func:`build_station_schedule` (``tests/test_station_e2e.py``'s
two-qubit station), :func:`fuzz_schedule` (``tests/test_fuzz_engines.py``'s
random schedules from the whole pulse palette, :func:`fuzz_channel`) and
:data:`CONSTRUCTORS` (``tests/test_engine_matrix.py``'s public
constructors, one schedule each).
"""

from __future__ import annotations

from functools import partial

import numpy as np

from . import models as m
from .core import WaveVStack, zero
from .models import chirp, cosPulse, gaussian, mixing, square

__all__ = ['FS', 'build_schedule', 'build_mid_schedule',
           'build_dense_schedule', 'build_ladder_schedule',
           'station_channels', 'STRATA', 'STATION_SPAN', 'Z_SETTLE',
           'READOUT_TONES', 'build_station_schedule', 'FUZZ_SPAN',
           'FUZZ_SEEDS', 'fuzz_pulse', 'fuzz_channel', 'fuzz_schedule',
           'MATRIX_FS', 'MATRIX_SPAN', 'CONSTRUCTORS']

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


# -- tests/test_station_e2e.py: a two-qubit control station --------------

STATION_SPAN = 4.096e-6        # one shot window (8192 samples at FS)
STATION_LO = {'Q1': 4.70e9, 'Q2': 4.35e9}
STATION_F01 = {'Q1': 4.675808085e9, 'Q2': 4.354224549e9}
STATION_READ_LO = 6.99e9
STATION_FR = {'Q1': 6.87836e9, 'Q2': 6.92248e9}
#: the Z lines' exponential settling: amplitudes, time constants
Z_SETTLE = ([0.02, 0.005], [3e-6, 20e-6])
#: the readout line's two tones, at their IF
READOUT_TONES = [STATION_FR[q] - STATION_READ_LO for q in ('Q1', 'Q2')]


def _x_half(q, t0, phase=0.0):
    env = 0.45 * m.cosPulse(24e-9) >> t0
    return mixing(env, freq=STATION_F01[q] - STATION_LO[q], phase=phase,
                  DRAGScaling=0.3e-9)


def build_station_schedule():
    """A 2-qubit sequence on 8 AWG channels -> {channel name: waveform}:
    X/2 on both XY lines (DRAG-mixed cosPulses), a CZ-like erf-edged flux
    square on both Z lines, a second X/2 layer at phase pi/3, and both
    qubits' readout tones on the shared line (``RI1``, ``RQ1``)."""
    chans = {k: [] for k in ('X1.I', 'X1.Q', 'X2.I', 'X2.Q', 'Z1', 'Z2',
                             'RI1', 'RQ1')}
    lines = (('Q1', ('X1.I', 'X1.Q')), ('Q2', ('X2.I', 'X2.Q')))
    for q, (ci, cq) in lines:
        I, Q = _x_half(q, 0.1e-6)
        chans[ci].append(I)
        chans[cq].append(Q)
    chans['Z1'].append(0.31 * (m.square(60e-9, edge=4e-9) >> 0.2e-6))
    chans['Z2'].append(-0.18 * (m.square(60e-9, edge=4e-9) >> 0.2e-6))
    for q, (ci, cq) in lines:
        I, Q = _x_half(q, 0.35e-6, phase=np.pi / 3)
        chans[ci].append(I)
        chans[cq].append(Q)
    for q in ('Q1', 'Q2'):
        env = 0.3 * (m.square(1e-6, edge=20e-9) >> 2.2e-6)
        I, Q = mixing(env, freq=STATION_FR[q] - STATION_READ_LO)
        chans['RI1'].append(I)
        chans['RQ1'].append(Q)
    return {k: WaveVStack(v) if v else zero() for k, v in chans.items()}


# -- tests/test_fuzz_engines.py: random schedules -------------------------

FUZZ_SPAN = 8e-6               # 16,000 samples at FS
#: each of the JAX file's tests -> (its first seed, its number of seeds)
FUZZ_SEEDS = {'native': (1000, 8), 'kernel': (2000, 2), 'complex': (3000, 2),
              'sparse': (4000, 3), 'stack': (5000, 4)}


def fuzz_pulse(rng):
    """One random pulse: an envelope, a DRAG variant, a chirp, a mixed
    cosPulse or a windowed sinc + poly, at a random shift and amplitude."""
    kind = rng.integers(0, 8)
    shift = rng.uniform(0.1e-6, FUZZ_SPAN - 0.1e-6)
    amp = rng.uniform(0.2, 1.5) * rng.choice([-1, 1])
    if kind == 0:
        return amp * (m.gaussian(rng.uniform(20e-9, 200e-9)) >> shift)
    if kind == 1:
        return amp * (m.cosPulse(rng.uniform(20e-9, 200e-9)) >> shift)
    if kind == 2:
        return amp * (m.square(rng.uniform(50e-9, 300e-9),
                               edge=rng.uniform(5e-9, 20e-9),
                               type=rng.choice(['erf', 'cos', 'linear']))
                      >> shift)
    if kind == 3:
        w = m.drag(rng.uniform(50e6, 300e6), 20e-9,
                   plateau=rng.uniform(0, 1e-8),
                   delta=rng.uniform(-5e6, 5e6), block_freq=None,
                   phase=rng.uniform(0, 2 * np.pi), t0=0.0)
        return amp * (w >> shift)
    if kind == 4:
        w = m.drag_sin(rng.uniform(50e6, 300e6), 21.7e-9,
                       plateau=rng.uniform(0, 8e-9) + 0.3e-9,
                       delta=rng.uniform(-5e6, 5e6),
                       block_freq=(211e6, -97e6),
                       phase=rng.uniform(0, 2 * np.pi))
        return amp * (w >> shift)
    if kind == 5:
        return amp * (m.chirp(rng.uniform(1e6, 20e6),
                              rng.uniform(30e6, 80e6),
                              rng.uniform(0.2e-6, 1e-6), rng.uniform(0, 6),
                              'linear') >> shift)
    if kind == 6:
        I, _ = mixing(0.5 * m.cosPulse(rng.uniform(20e-9, 80e-9)) >> shift,
                      freq=rng.uniform(-300e6, 300e6),
                      phase=rng.uniform(0, 2 * np.pi), DRAGScaling=1e-10)
        return amp * I
    return amp * ((m.sinc(rng.uniform(20e6, 80e6))
                   + m.poly([0.1, rng.uniform(-1e5, 1e5)]))
                  * m.square(rng.uniform(0.1e-6, 0.4e-6)) >> shift)


def fuzz_channel(rng):
    """A random channel: 1-5 pulses summed or stacked, sometimes under a
    carrier, sometimes clipped."""
    n = int(rng.integers(1, 6))
    if rng.random() < 0.3:
        ch = WaveVStack([fuzz_pulse(rng) for _ in range(n)])
    else:
        ch = zero()
        for _ in range(n):
            ch = ch + fuzz_pulse(rng)
    if rng.random() < 0.25:
        ch = ch * m.cos(2 * np.pi * rng.uniform(50e6, 500e6),
                        rng.uniform(0, 2 * np.pi))
    if rng.random() < 0.2:
        ch.max = float(rng.uniform(0.4, 1.0))
        ch.min = -float(rng.uniform(0.4, 1.0))
    return ch


def fuzz_schedule(kind, seed):
    """The schedule of the JAX fuzz test ``kind`` (:data:`FUZZ_SEEDS`) for
    its ``seed``-th seed -> (channels, bucket_samples), drawn as that test
    draws it: 1-4 channels in one of three bucketings ('native'), 2
    channels in 4096-sample buckets ('kernel', 'sparse'), 2 channels of a
    random complex amplitude, unclipped ('complex', one bucket), or 2
    channels in the default buckets ('stack')."""
    base, n_seeds = FUZZ_SEEDS[kind]
    if not 0 <= seed < n_seeds:
        raise ValueError(f"{kind!r} has seeds 0..{n_seeds - 1}")
    rng = np.random.default_rng(base + seed)
    if kind == 'native':
        chans = [fuzz_channel(rng) for _ in range(int(rng.integers(1, 5)))]
        bucket = int(rng.choice([0, 2048, 4096]))
        return chans, (bucket or None)
    if kind == 'complex':
        chans = [(rng.uniform(0.3, 1.0) + 1j * rng.uniform(0.3, 1.0))
                 * fuzz_channel(rng) for _ in range(2)]
        for ch in chans:        # a complex clip is a documented divergence
            ch.max, ch.min = np.inf, -np.inf
        return chans, 'auto'
    chans = [fuzz_channel(rng) for _ in range(2)]
    return chans, ('auto' if kind == 'stack' else 4096)


# -- tests/test_engine_matrix.py: every public constructor ----------------

MATRIX_FS = 1e9
MATRIX_SPAN = 4.096e-6

#: (name, builder) of every public constructor with analytic support inside
#: [0, MATRIX_SPAN), multi-tone DRAG included
CONSTRUCTORS = [
    ('gaussian', lambda: m.gaussian(300e-9) >> 1e-6),
    ('gaussian_plateau', lambda: m.gaussian(200e-9, plateau=150e-9)
     >> 1e-6),
    ('cosPulse', lambda: m.cosPulse(200e-9) >> 1e-6),
    ('hanning', lambda: m.hanning(200e-9, plateau=100e-9) >> 1e-6),
    ('coshPulse', lambda: m.coshPulse(200e-9, eps=3.0) >> 1e-6),
    ('square_erf', lambda: m.square(300e-9, edge=40e-9) >> 1e-6),
    ('square_cos', lambda: m.square(300e-9, edge=40e-9, type='cos')
     >> 1e-6),
    ('square_linear', lambda: m.square(300e-9, edge=40e-9, type='linear')
     >> 1e-6),
    ('step', lambda: (m.step(50e-9) >> 1e-6) * m.square(2e-6) >> 1e-6),
    ('sign_windowed', lambda: m.sign() * (m.square(400e-9) >> 1e-6)),
    ('cos', lambda: m.cos(2 * np.pi * 97.3e6, 0.4)),
    ('sin', lambda: m.sin(2 * np.pi * 53.1e6)),
    ('exp_windowed', lambda: m.exp(-4e6) * (m.square(1e-6) >> 1e-6)),
    ('sinc', lambda: m.sinc(40e6) >> 2e-6),
    ('cosh_windowed', lambda: m.cosh(2e6) * (m.square(1e-6) >> 1e-6)),
    ('sinh_windowed', lambda: m.sinh(2e6) * (m.square(1e-6) >> 1e-6)),
    ('mollifier', lambda: m.mollifier(300e-9, d=2) >> 1e-6),
    ('poly_windowed', lambda: (m.poly([0.2, 1e6, -3e11])
                               * m.square(1e-6)) >> 1e-6),
    ('drag', lambda: m.drag(80e6, 150e-9, plateau=100e-9, delta=3e6,
                            block_freq=210e6, phase=0.7, t0=10e-9)
     >> 1e-6),
    ('drag_sin', lambda: m.drag_sin(90e6, 60e-9, plateau=30e-9,
                                    delta=2e6, block_freq=(260e6,),
                                    phase=0.3) >> 1e-6),
    ('drag_sinx', lambda: m.drag_sinx(90e6, 60e-9, plateau=30e-9,
                                      delta=2e6, block_freq=(260e6,),
                                      phase=0.3) >> 1e-6),
    ('chirp_linear', lambda: m.chirp(5e6, 60e6, 1.5e-6, 0.2, 'linear')
     >> 0.5e-6),
    ('chirp_exp', lambda: m.chirp(5e6, 60e6, 1.5e-6, 0.2, 'exponential')
     >> 0.5e-6),
    ('chirp_hyp', lambda: m.chirp(5e6, 60e6, 1.5e-6, 0.2, 'hyperbolic')
     >> 0.5e-6),
    ('interp', lambda: m.interp(np.linspace(1e-6, 2e-6, 9),
                                [0, .5, 1, .3, -.4, .8, .2, -.1, 0])),
    ('samplingPoints', lambda: m.samplingPoints(
        1e-6, 2e-6, np.sin(np.linspace(0, 9, 64)))),
    ('cut', lambda: m.cut(2.0 * (m.gaussian(400e-9) >> 1e-6), max=1.2,
                          min=-0.5)),
    ('t_windowed', lambda: (m.t() * 1e6) * (m.square(1e-6) >> 1e-6)),
    ('general_cosine', lambda: m.general_cosine(
        400e-9, 0.35875, 0.48829, 0.14128, 0.01168) >> 1e-6),
    ('slepian', lambda: m.slepian(400e-9, 0.5, 0.3, 0.15) >> 1e-6),
    ('mixing_I', lambda: mixing(0.5 * m.cosPulse(200e-9) >> 1e-6,
                                freq=-70e6, DRAGScaling=1e-9)[0]),
    ('D_gaussian', lambda: m.D(m.gaussian(300e-9) >> 1e-6) * 1e-7),
]
