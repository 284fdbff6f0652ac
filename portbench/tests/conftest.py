"""Shared set-up of the benchmark's own tests: the benchmark's folder and
the checkout on the path, small copies of the configurations, and the
card's fixture for the tests marked ``cuda``."""

import os
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
sys.path[:0] = [BENCH, os.path.dirname(BENCH)]

import spec  # noqa: E402


def small(cfg: dict) -> dict:
    """A configuration cut to a size the CPU's plain versions run in a
    second: chip64 to 4 channels x 16,384 samples, station_rb to 200 gates
    a channel (13,200 samples), every table to 4 points."""
    cfg = dict(cfg, points=4)
    if cfg['name'] == 'chip64':
        cfg.update(n_channels=4, duration_s=8.192e-6)
        for kind in ('xy', 'z'):
            cfg[kind] = dict(cfg[kind], times_s={'uniform': [0.0, 7.5e-6]})
    if cfg['name'] == 'station_rb':
        cfg.update(duration_s=6.6e-6)
        for kind in ('xy', 'z'):
            cfg[kind] = dict(cfg[kind], pulses=200)
    return cfg


def small_cell(name: str, shots: int = 2):
    """(cfg, mix, driver, limits) of cell ``name`` at a small size."""
    bench = spec.benchmark()
    wl = spec.workload(bench, name)
    mix = dict(spec.traffic(wl['traffic']))
    if 'shots' in mix:
        mix['shots'] = min(mix['shots'], shots)
    return (small(spec.config(bench, wl['config'])), mix,
            spec.call_driver(mix), spec.limits(name))


@pytest.fixture
def card():
    """The CUDA device, or a skip where torch sees none."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU')
    return torch.device('cuda')
