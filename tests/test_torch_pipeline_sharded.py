"""The port's sharded production step (``waveforms_tpu_torch.parallel.
make_step`` / ``run_step``) against scipy, the port's own single-device
chain and the JAX package's ``run_step`` on its 8-device CPU mesh.

The step synthesizes over a (4, 2) mesh that names the CPU eight times,
filters each shard in float64 with its state carried from the time shard
before it, and demodulates each time shard against its rows of the tone
matrix with the partial sums added on one device.  The filtered signals lie
within 1e-9 of each channel's peak of scipy's ``lfilter`` over the whole
row (float64), and, for a filter whose poles f32 holds, within 5e-5 of
JAX's (JAX filters the f32 plane in f32); the IQ points within 1e-6 of
their peak of the port's unsharded demodulation of the same filtered
plane.  The clustered three-pole filter routes each shard to the
recurrence kernel S1 (its plain version here), whose carry across the time
shards is exact.
"""

import numpy as np
import pytest
import torch
from scipy.signal import lfilter as sp_lfilter

import waveforms_tpu.parallel.pipeline as pj
from waveforms_tpu_torch import parallel
from waveforms_tpu_torch.convert import waveform_from_jax
from waveforms_tpu_torch.distortion import combine_filters, exp_decay_filter
from waveforms_tpu_torch.ops import iir, iir_cases
from waveforms_tpu_torch.ops.demod import demod_matrix, demodulate
from waveforms_tpu_torch.ops.lowering import lower_schedule
from waveforms_tpu_torch.ops.synth import DeviceSchedule, synthesize_device
from test_torch_mesh import FS, mesh_j, mesh_t, sparse_schedule

STOP = 8.192e-6
TONES = [50e6, -120e6]
Z_SETTLE = ([0.02, 0.005], [3e-6, 20e-6])


def _filters(name):
    if name == 'z_settle':
        return [exp_decay_filter(*Z_SETTLE, FS, output='ba')]
    if name == 'exp_decay':
        return [exp_decay_filter(0.05, 100e-9, FS, inv=True)]
    return [exp_decay_filter(*iir_cases.CLUSTERED, FS, output='ba')]


def _schedule():
    chans_j = sparse_schedule(8, seed=4)
    chans = [waveform_from_jax(c) for c in chans_j]
    return chans_j, chans, lower_schedule(chans, 0, STOP, FS)


def _scipy(low, filters):
    raw = synthesize_device(DeviceSchedule(low, 'cpu')).double().numpy()
    b, a = combine_filters(filters)
    return sp_lfilter(b, a, raw)


@pytest.mark.parametrize('name', ['z_settle', 'exp_decay', 'clustered'])
def test_make_step_matches_scipy_and_unsharded_demod(name, monkeypatch):
    chans_j, chans, low = _schedule()
    filters = _filters(name)
    routes = []
    orig = iir._sequential_filter

    def spy(*a, **kw):
        routes.append(a[2].shape)
        return orig(*a, **kw)

    monkeypatch.setattr(iir, '_sequential_filter', spy)
    # tiles of 8 rows: each time shard holds 8,192 samples
    step = parallel.make_step(low, mesh_t(), ba_filters=filters,
                              demod_freqs=TONES, rows_per_tile=8)
    plane, iq = step()
    assert [b.shape[1] for b in plane.blocks[0]] == [8192, 8192]
    sig = plane.gather()
    assert sig.dtype == torch.float64 and sig.shape == (8, low.n_samples)
    want = _scipy(low, filters)
    peak = np.abs(want).max(axis=-1)
    assert (np.abs(sig.numpy() - want).max(axis=-1) <= 1e-9 * peak).all()
    # the clustered filter runs each of the 8 shards on S1
    assert len(routes) == (8 if name == 'clustered' else 0)
    m = demod_matrix(TONES, low.n_samples, low.sample_rate, device='cpu')
    whole = demodulate(sig, m)
    assert iq.shape == (8, 2) and iq.dtype == torch.complex64
    assert (iq - whole).abs().max() <= 1e-6 * whole.abs().max()
    if name != 'exp_decay':
        # JAX filters the f32 plane in f32: with near-unit poles that is
        # 0.1 of the peak off scipy (Z-settle) or diverges (clustered)
        return
    sig_j, iq_j = pj.run_step(chans_j, 0, STOP, FS, mesh_j(),
                              ba_filters=filters, demod_freqs=TONES,
                              rows_per_tile=8, interpret=True)
    sig_j = np.asarray(sig_j)
    assert np.abs(sig.numpy() - sig_j).max() <= 5e-5 * np.abs(sig_j).max()


def test_run_step_equals_make_step():
    chans_j, chans, low = _schedule()
    filters = _filters('exp_decay')
    a, iq_a = parallel.run_step(chans, 0, STOP, FS, mesh_t(),
                                ba_filters=filters, demod_freqs=TONES)
    b, iq_b = parallel.make_step(low, mesh_t(), ba_filters=filters,
                                 demod_freqs=TONES)()
    assert torch.equal(a.gather(), b.gather()) and torch.equal(iq_a, iq_b)


def test_step_without_filter_or_tones():
    """No filter: the f32 plane of synthesize_sharded, bit for bit; no
    tones: no IQ; a time-only mesh with shards past the end carries the
    state over their empty blocks."""
    _, _, low = _schedule()
    plane, iq = parallel.make_step(low, mesh_t())()
    assert iq is None
    assert torch.equal(plane.gather(),
                       synthesize_device(DeviceSchedule(low, 'cpu')))
    short = lower_schedule([waveform_from_jax(c)
                            for c in sparse_schedule(2, seed=1)],
                           0, 0.8e-6, FS)
    filters = _filters('exp_decay')
    plane, iq = parallel.make_step(short, mesh_t(1, 8), ba_filters=filters,
                                   demod_freqs=TONES, rows_per_tile=8)()
    assert sum(b.shape[1] == 0 for b in plane.blocks[0]) == 6
    want = _scipy(short, filters)
    assert np.abs(plane.gather().numpy() - want).max() <= (
        1e-9 * np.abs(want).max())
    m = demod_matrix(TONES, short.n_samples, FS, device='cpu')
    whole = demodulate(torch.from_numpy(want), m)
    assert (iq - whole).abs().max() <= 1e-6 * whole.abs().max()
