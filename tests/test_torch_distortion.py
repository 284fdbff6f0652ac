"""The port's carried-over ``distortion.py`` and ``utils/signal.py`` against
the JAX package's, array-equal.

Both are host numpy/scipy code that the port copies unchanged, so every
function must return the same arrays bit for bit.  The inputs are those
of ``tests/test_distortion.py`` (and the reference API's other
arguments), one parametrised test per function.
"""

import numpy as np
import pytest
from scipy.signal import butter

import waveforms_tpu as wj
import waveforms_tpu.distortion as jd
import waveforms_tpu.utils.signal as js
import waveforms_tpu_torch as wt
import waveforms_tpu_torch.distortion as td
import waveforms_tpu_torch.utils.signal as ts


def assert_same(a, b):
    """Array-equal, through tuples, lists and poly1d."""
    if isinstance(a, (tuple, list)):
        assert isinstance(b, (tuple, list)) and len(a) == len(b)
        for x, y in zip(a, b):
            assert_same(x, y)
        return
    if isinstance(a, np.poly1d):
        a, b = a.coeffs, b.coeffs
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _step(n=5000, lo=1000, hi=3000):
    sig = np.zeros(n)
    sig[lo:hi] = 1.0
    return sig


_rng = np.random.default_rng(0)
_SIG_IN = _rng.standard_normal(1024)
_IMP = np.zeros(31)
_IMP[15], _IMP[16] = 1.0, 0.3
_SIG_OUT = np.convolve(_SIG_IN, _IMP, mode='same')
_INV = [(0.05, 100e-9), (-0.02, 30e-9)]
_FILTERS = [jd.exp_decay_filter(0.05, 100e-9, 2e9, inv=True)]
_KER = np.zeros(17)
_KER[8] = 1.0


def _phase_wav(mod):
    return 0.1 * (mod.square(2e-6) << 1e-6)


# (function name, case id, args, kwargs); the same call goes to both
CALLS = [
    ('extractKernel', 'plain', (_SIG_IN, _SIG_OUT, 2e9), {}),
    ('extractKernel', 'bw_skip', (_SIG_IN, _SIG_OUT, 2e9),
     {'bw': 1e8, 'skip': 5}),
    ('zDistortKernel', 'one_pole', (0.5e-9, [(50e-9, 0.05)]), {}),
    ('zDistortKernel', 'two_poles', (0.5e-9, [(50e-9, 0.05), (20e-9, -0.02)]),
     {}),
    ('high_pass_filter', 'us', (1e-6, 1e9), {}),
    ('exp_decay_filter', 'ba', (0.1, 50e-9, 1e9), {}),
    ('exp_decay_filter', 'sos', (0.1, 50e-9, 1e9), {'output': 'sos'}),
    ('exp_decay_filter', 'zpk', (0.1, 50e-9, 1e9), {'output': 'zpk'}),
    ('exp_decay_filter', 'inv', (-0.02, 30e-9, 2e9), {'inv': True}),
    ('exp_decay_filter', 'multi', ([0.05, -0.02, 0.01],
                                   [100e-9, 30e-9, 300e-9], 2e9), {}),
    ('exp_decay_filter', 'clustered_zpk', ([0.02, 0.008, 0.004],
                                           [2e-6, 9e-6, 30e-6], 2e9),
     {'output': 'zpk'}),
    ('exp_decay_filter_old', 'positive', (0.1, 50e-9, 1e9), {}),
    ('exp_decay_filter_old', 'negative', (-0.05, 20e-9, 1e9), {}),
    ('reflection_filter', 'grid', (np.fft.fftfreq(64, 0.5e-9), 0.2, 5e-9),
     {}),
    ('reflection', 'step', (_step(4096, 1000, 2000), 0.2, 5e-9, 2e9), {}),
    ('correct_reflection', 'samples',
     (jd.reflection(_step(4096, 1000, 2000), 0.2, 5e-9, 2e9), 0.2, 5e-9,
      2e9), {}),
    ('combine_filters', 'two', ([jd.exp_decay_filter(0.1, 50e-9, 1e9),
                                 jd.exp_decay_filter(-0.05, 20e-9, 1e9)],),
     {}),
    ('factor_filter', 'two', tuple(jd.combine_filters(
        [jd.exp_decay_filter(0.1, 50e-9, 1e9),
         jd.exp_decay_filter(-0.05, 20e-9, 1e9)])), {}),
    ('factor_filter', 'zero_at_origin', ([2.0, 0.0], [1.0, 0.5]), {}),
    ('stable_filter', 'pair', ([(0.1, 50e-9), (-0.05, 20e-9)], 1e9), {}),
    ('_steady_state_zi', 'dc', (*jd.combine_filters(_FILTERS), 0.3, None,
                                None), {}),
    ('_steady_state_zi', 'histories', (*butter(3, 0.1), 0.0, [0.1, 0.2],
                                       [0.3, 0.4, 0.5]), {}),
    ('predistort', 'inverse_pair', (_step(),
                                    [jd.exp_decay_filter(A, t, 2e9, inv=True)
                                     for A, t in _INV]), {}),
    ('predistort', 'kernel_zf', (_step(2048, 500, 1500), _FILTERS),
     {'ker': _KER, 'return_zf': True}),
    ('predistort', 'initial', (_step(2048, 500, 1500), _FILTERS),
     {'initial': 0.25}),
    ('predistort', 'zi', (_step(2048, 500, 1500)[1024:], _FILTERS),
     {'zi': jd.predistort(_step(2048, 500, 1500)[:1024], _FILTERS,
                          return_zf=True)[1]}),
    ('distort', 'one', (_step(1000, 200, 800), [0.05, 100e-9], 2e9), {}),
    ('shift', 'sub_sample', (_step(1000, 200, 800), 2.5e-9, 0.5e-9), {}),
    ('shift', 'advance', (_step(1000, 200, 800), -3.25e-9, 0.5e-9), {}),
    ('getFTMatrix', 'two_tones', ([20e6, -13e6], 500), {'sampleRate': 1e9}),
    ('getFTMatrix', 'phases_2d_weight',
     ([20e6, -13e6], 500, [0.3, -0.2],
      np.random.default_rng(1).uniform(0.5, 1.5, (2, 500))), {}),
]


def _module(fn, port):
    if fn in ('shift', 'getFTMatrix'):
        return ts if port else js
    return td if port else jd


@pytest.mark.parametrize('fn,args,kw', [c[0::2] + (c[3],) for c in CALLS],
                         ids=[f'{c[0]}-{c[1]}' for c in CALLS])
def test_function_array_equal(fn, args, kw):
    def copy(v):
        return v.copy() if isinstance(v, np.ndarray) else v

    got = getattr(_module(fn, True), fn)(*map(copy, args), **kw)
    want = getattr(_module(fn, False), fn)(*map(copy, args), **kw)
    assert_same(got, want)


@pytest.mark.parametrize('params', [[], [0.05, 100e-9], [-0.03, 0.5e-6]],
                         ids=['none', 'fast', 'slow'])
def test_phase_curve_array_equal(params):
    """phase_curve samples a Waveform: the port's own against JAX's."""
    t = np.array([50e-9, 200e-9, 1e-6, 5e-6])
    got = td.phase_curve(t, params, 4.3e9, 10e-9, 25e-9, _phase_wav(wt),
                         2e9)
    want = jd.phase_curve(t, params, 4.3e9, 10e-9, 25e-9, _phase_wav(wj),
                          2e9)
    np.testing.assert_array_equal(got, want)


def test_correct_reflection_symbolic_is_a_port_waveform():
    """On a Waveform the correction is symbolic and stays in the port's
    IR: the same samples as JAX's on the same grid."""
    got = td.correct_reflection(wt.square(2e-6), 0.1, 10e-9)
    want = jd.correct_reflection(wj.square(2e-6), 0.1, 10e-9)
    assert isinstance(got, wt.Waveform)
    t = np.linspace(-2e-6, 2e-6, 1001)
    np.testing.assert_array_equal(got(t), want(t))
