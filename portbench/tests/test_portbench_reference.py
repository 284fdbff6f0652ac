"""The plain reference agrees with the port's CPU path at a small size:
4 channels x 16,384 samples of chip64, and a 2-shot RB chain."""

import numpy as np
import pytest
import scipy.signal as sps
import torch

import draws
from conftest import small_cell
from reference import chain as ref_chain
from reference import plane as ref_plane


@pytest.fixture(scope='module')
def chip():
    cfg, mix, driver, _ = small_cell('chip64.predistort')
    return cfg, driver.Call(cfg, mix, 2 ** 31 + 5, 'cpu')


@pytest.mark.parametrize('k', [0, 3])
def test_plane_within_the_f32_contract(chip, k):
    cfg, call = chip
    got = call.seq.play(k).double()
    ref = call.plane(k)
    assert got.shape == ref.shape == (4, 16384)
    gap = ((got - ref).abs().amax(1) / ref.abs().amax(1)).max()
    assert gap <= 2e-6


def test_codes_within_one(chip):
    cfg, call = chip
    got = call.seq.play_many([1, 2], out_dtype=torch.int16)
    for s, k in enumerate([1, 2]):
        ref = ref_plane.codes(call.plane(k), cfg['dac_scale'])
        assert int((got[s].int() - ref).abs().max()) <= 1


def test_precompensation_matches_the_ports_filter_and_long_double(chip):
    cfg, call = chip
    from waveforms_tpu_torch.distortion import combine_filters
    b, a = combine_filters(call.filters)
    x = call.plane(0).float().double()
    secs = ref_chain.sections(cfg['z_settle']['amps'],
                              cfg['z_settle']['taus_s'],
                              cfg['sample_rate_hz'])
    y = ref_chain.precompensate(x, secs)
    row = x[0].numpy().astype(np.longdouble)
    for g, z, p in secs:
        g, z, p = (np.longdouble(v) for v in (g, z, p))
        out, prev, xp = np.empty_like(row), np.longdouble(0), \
            np.longdouble(0)
        for n, v in enumerate(row):
            prev = p * prev + g * (v - z * xp)
            xp, out[n] = v, prev
        row = out
    assert np.abs(y[0].numpy() - row.astype(float)).max() <= 1e-14
    assert np.abs(y.numpy() - sps.lfilter(b, a, x.numpy())).max() <= 1e-9


def test_predistort_matches_the_port(chip):
    cfg, call = chip
    from waveforms_tpu_torch.ops import predistort_device
    x = call.seq.play(2)
    got = predistort_device(x.double(), filters=call.filters,
                            ker=call.ker_t, device='cpu')
    secs = ref_chain.sections(cfg['z_settle']['amps'],
                              cfg['z_settle']['taus_s'],
                              cfg['sample_rate_hz'])
    ref = ref_chain.fir_centred(ref_chain.precompensate(
        call.plane(2).float().double(), secs), call.ker)
    assert ((got - ref).abs().amax(1) / ref.abs().amax(1)).max() <= 2e-6
    full = np.stack([np.convolve(r, call.ker)[15:15 + 16384]
                     for r in ref_chain.precompensate(
                         call.plane(2), secs).numpy()])
    assert np.abs(ref_chain.fir_centred(
        ref_chain.precompensate(call.plane(2), secs), call.ker).numpy()
        - full).max() <= 1e-15


def test_rb_chain_of_two_shots_matches_the_port():
    cfg, mix, driver, limits = small_cell('station_rb.chain', shots=2)
    call = driver.Call(cfg, mix, 99, 'cpu')
    from waveforms_tpu_torch.parallel import run_sequence
    ks = call.indices(0)
    iq = run_sequence(call.seq, ks, ba_filters=call.filters,
                      demod_freqs=call.tones)
    assert iq.shape == (2, 2, 2)
    (gap,) = call.check([(0, ks, iq)])
    assert gap['iq_gap'] <= limits['iq_gap']['limit']
    ref = call.reference_iq()
    n = draws.n_samples(cfg)
    t = np.arange(n) / cfg['sample_rate_hz']
    y = ref_chain.precompensate(call.plane(int(ks[0])).float().double(),
                                ref_chain.sections(
                                    cfg['z_settle']['amps'],
                                    cfg['z_settle']['taus_s'],
                                    cfg['sample_rate_hz'])).numpy()
    mat = np.exp(-2j * np.pi * np.outer(t, call.tones)) * (2 / n)
    assert np.abs(ref[int(ks[0])].numpy() - y @ mat).max() <= 1e-12
