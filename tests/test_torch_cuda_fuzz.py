"""The JAX suite's cross-engine nets on the card: the fuzz seeds of
``tests/test_fuzz_engines.py`` and the station of
``tests/test_station_e2e.py`` through every card route
(:mod:`waveforms_tpu_torch.cross_engine`), and the profiler's device times.

These tests need an NVIDIA GPU and skip without one.  The file imports
neither ``jax`` nor ``waveforms_tpu``; the schedules are drawn with the
port's own constructors from the JAX files' seeds (the CPU suite's
``test_torch_fuzz_engines.py`` and ``test_torch_station_e2e.py`` hold them
equal to the JAX package's):

    python -m pytest tests/test_torch_cuda_fuzz.py -m cuda -q --noconftest

Every (case, mode, engine) of ``cross_engine.checks()`` -- ``engine='auto'``
on the card's router and each forced kernel K1, K2, K7, K5 in f32 and
int16, pair mode on the complex seeds, the double tier (K3) -- runs on the
card and is held to the plain version of its route on the CPU (f32 1e-6 of
each channel's peak, int16 one code, float64 1e-12) and the float64 oracle
(2e-6, one code, 1e-9), the route's kernel launched; a refusal is the plain
version's too.
"""

import numpy as np
import pytest
import torch

import waveforms_tpu_torch as wt
from waveforms_tpu_torch import cross_engine, kernels, probes
from waveforms_tpu_torch.ops.lowering import lower_schedule
from waveforms_tpu_torch.ops.synth import DeviceSchedule
from waveforms_tpu_torch.utils import profiling

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device('cuda')


@pytest.mark.parametrize('case, mode, engine', cross_engine.checks())
def test_cross_engine_on_the_card(card, case, mode, engine):
    rec = cross_engine.check(case, mode, engine, device='cuda')
    assert rec['ok'], rec


def test_every_card_kernel_is_reached(card):
    """The checks launch K1, K2, K7, K5 and K3 between them."""
    kernels.reset_launch_counts()
    for case, mode, engine in cross_engine.checks(('kernel0', 'station')):
        cross_engine.check(case, mode, engine, device='cuda')
    counts = kernels.launch_counts()
    for name in ('synth_dense', 'synth_panel', 'synth_sparse', 'synth_stack',
                 'synth_dense_hi'):
        assert counts[name] > 0, name


def test_measure_device_times_k1(card, tmp_path):
    """``measure_device`` finds K1 by its name in a trace of calls that
    also launch K3, one event a launch (``synth_dense_kernel`` does not
    match ``synth_dense_hi_kernel``), and times it on the card's clock:
    within 10% of ``probes.cuda_ms`` where K1 runs long enough for either
    clock (a 128 x 524,288 dense schedule, about 0.35 ms)."""
    chans = [wt.gaussian(1e-6) >> 2e-6, wt.cosPulse(1e-6) >> 5e-6]
    low = lower_schedule(chans, 0.0, 8.192e-6, 2e9)
    dev = DeviceSchedule(low, 'cuda')
    out = torch.empty(low.shape[0], low.n_samples, device='cuda')

    def both():
        kernels.synth_dense(dev, out)
        wt.synthesize(chans, 0.0, 8.192e-6, 2e9, precision='double')
    both()
    with profiling.trace(str(tmp_path)):
        for _ in range(4):
            both()
    k1 = profiling.device_event_times(str(tmp_path), 'synth_dense_kernel')
    k3 = profiling.device_event_times(str(tmp_path), 'synth_dense_hi')
    assert 3 <= len(k1) <= 4 and 3 <= len(k3) <= 4
    assert all(0 < s < 1e-2 for s in k1 + k3)

    from waveforms_tpu_torch.schedules import build_dense_schedule
    low = lower_schedule(build_dense_schedule(128, 262.144e-6), 0.0,
                         262.144e-6, 2e9)
    dev = DeviceSchedule(low, 'cuda')
    out = torch.empty(low.shape[0], low.n_samples, device='cuda')
    run = lambda: kernels.synth_dense(dev, out)           # noqa: E731
    events_ms = probes.cuda_ms(run)
    traced_ms = profiling.measure_device(run, 'synth_dense_kernel',
                                         reps=5) * 1e3
    assert abs(traced_ms / events_ms - 1) <= 0.1, (traced_ms, events_ms)
    with pytest.raises(RuntimeError, match='no device events'):
        profiling.measure_device(run, 'no_such_kernel')
    assert np.isfinite(out.cpu().numpy()).all()
