"""Every number a cell's schedules are made of, drawn from the seed.

One general generator for every configuration file: a configuration names
its lines (``lines``: channel ``c`` is ``lines[c % len(lines)]``), and each
line kind its pulses -- ``xy`` DRAG-mixed cosPulses, ``z`` erf-edged
squares -- with their widths and carrier, and the laws of their times,
phases and amplitudes: a number, ``{"uniform": [lo, hi]}``, ``{"grid":
[t0, step]}`` or ``{"choice": [v, ...]}`` (each value equally likely).
:func:`draw_table` turns a configuration and a seed into plain arrays.  The
program gets them as waveforms built through its public constructors
(``build.py``); the reference (``reference/plane.py``) gets the same
arrays as numbers.  Nothing here imports the program.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

SEED_MOD = 2 ** 63


def seed_sequence(seed: int, stream: str) -> np.random.SeedSequence:
    """An independent seed sequence for one purpose of one run: the same
    ``(seed, stream)`` always gives the same draws."""
    tag = [ord(ch) for ch in stream]
    return np.random.SeedSequence([int(seed) % SEED_MOD, *tag])


def rng(seed: int, stream: str) -> np.random.Generator:
    return np.random.default_rng(seed_sequence(seed, stream))


def torch_seed(seed: int, stream: str) -> int:
    """A 63-bit seed for a ``torch.Generator``, from the run's seed."""
    state = seed_sequence(seed, stream).generate_state(1, np.uint64)
    return int(state[0]) % SEED_MOD


@dataclass
class Line:
    """The pulses of one kind of line over every point of the table:
    ``channels`` (n_lines,) plane rows; ``times`` (P, n_lines, pulses)
    pulse centres in seconds; ``amps`` the same shape; ``phases`` the same
    shape (XY only); ``freqs`` (n_lines,) carrier in Hz (XY only);
    ``stacked``: each channel a ``WaveVStack`` of gates, each gate made
    once at its centre (an XY gate's carrier phase counted from its centre)
    and shifted into place, not a sum of pulses shifted before mixing."""
    kind: str
    channels: np.ndarray
    times: np.ndarray
    amps: np.ndarray
    phases: np.ndarray | None
    freqs: np.ndarray | None
    spec: dict
    stacked: bool = False


def n_samples(cfg: dict) -> int:
    return int(round(cfg['duration_s'] * cfg['sample_rate_hz']))


def _law(law, shape, gen: np.random.Generator) -> np.ndarray:
    if isinstance(law, (int, float)):
        return np.full(shape, float(law))
    (kind, args), = law.items()
    if kind == 'uniform':
        return gen.uniform(*args, size=shape)
    if kind == 'grid':
        a, b = args
        return np.broadcast_to(a + b * np.arange(shape[-1]), shape).copy()
    if kind == 'choice':
        return np.asarray(args, dtype=float)[gen.integers(0, len(args),
                                                          size=shape)]
    raise ValueError(f"unknown law {kind!r}")


def draw_table(cfg: dict, seed: int) -> dict[str, Line]:
    """Every point's pulse times and phases, per kind of line, from
    ``seed``."""
    gen = rng(seed, 'table:' + cfg['name'])
    P, C, kinds = cfg['points'], cfg['n_channels'], cfg['lines']
    lines = {}
    for kind in dict.fromkeys(kinds):
        spec = cfg[kind]
        chans = np.array([c for c in range(C) if kinds[c % len(kinds)]
                          == kind])
        shape = (P, len(chans), spec['pulses'])
        times = _law(spec['times_s'], shape, gen)
        amps = _law(spec['amp'], shape, gen)
        phases = freqs = None
        if kind == 'xy':
            phases = _law(spec['phases'], shape, gen)
            freqs = spec['freq_hz'] + spec['freq_step_hz'] * chans
        elif kind != 'z':
            raise ValueError(f"unknown line kind {kind!r}")
        lines[kind] = Line(kind, chans, times, amps, phases, freqs, spec,
                           bool(cfg.get('stacked', False)))
    return lines


def index_pool_size(mix: dict) -> int:
    """Length of the card's pool of drawn table indices: whole calls, about
    2**20 indices; calls past its end take it again from the start."""
    shots = int(mix.get('shots', 1))
    return shots * max(1, (1 << 20) // shots)


def hann(taps: int) -> np.ndarray:
    """The symmetric Hann window of ``taps`` taps, normalised to unit sum:
    an input that both sides get as it is."""
    n = np.arange(taps)
    w = 0.5 - 0.5 * np.cos(2 * np.pi * n / (taps - 1))
    return w / w.sum()
