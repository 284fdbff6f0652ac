"""The port's signal chain (IIR filters, FFT pipelines, demodulation) on the
CPU against the JAX package and scipy.

The same inputs, made with numpy from fixed seeds, go through the JAX
functions (x64 on, as the JAX suite runs them) and the port's on
``device='cpu'``, where the recurrence kernel S1 runs its plain version
(``ops/reference_iir.py``).

Tolerances, of the output's peak, in f64:

- port vs JAX: 1e-10.  The doubling scans agree to ~1e-11 (their small
  matrix products round in another order); the direct-form recurrence of
  a well-conditioned filter to ~1e-15.  One exception: the clustered
  three-pole filter, whose direct form amplifies its state by ~1e10, is
  held to JAX at the JAX suite's own 1e-5 (``tests/test_ops_iir_fft.py``):
  JAX's ``lax.scan`` is itself ~5e-7 off scipy there (XLA contracts the
  step's multiply-adds), while the port's recurrence, with none, equals
  scipy's C loop bit for bit (checked below).
- port vs scipy: the JAX tests' own bounds, case by case; for the
  station's Z-settle pair (no JAX test holds it in f64) 1e-7, where JAX's
  doubling scan is itself 4.6e-8 off scipy.
- demodulate vs JAX: 1e-6 relative (f32 products); demod_matrix
  array-equal.
"""

import numpy as np
import pytest
import scipy.signal as sps
import torch

import jax.numpy as jnp
from waveforms_tpu.distortion import (combine_filters, exp_decay_filter,
                                      predistort)
from waveforms_tpu.ops import demod as jdemod
from waveforms_tpu.ops import fft as jfft
from waveforms_tpu.ops import iir as jiir
from waveforms_tpu_torch import kernels
from waveforms_tpu_torch.ops import demod as tdemod
from waveforms_tpu_torch.ops import fft as tfft
from waveforms_tpu_torch.ops import iir as tiir
from waveforms_tpu_torch.ops import reference_iir

TOL_JAX = 1e-10
TOL_JAX_CLUSTERED = 1e-5
FS = 2e9
CLUSTERED = ([0.02, 0.008, 0.004], [2e-6, 9e-6, 30e-6])


def rel(a, b):
    """max|a - b| over max|b|."""
    a = np.asarray(a)
    b = np.asarray(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def _signal(n, seed):
    t = np.arange(n)
    rng = np.random.default_rng(seed)
    return (np.sin(t * 0.37e-3) + 0.2 * (t % 5000 < 1200)
            + 0.01 * rng.standard_normal(n))


def _near_unit_double_pole():
    r = 1 - 1e-8
    return np.array([[1.0, 0.0, 0.0, 1.0, -2 * r, r * r]])


# name -> (port call, JAX call, scipy call, scipy bound, JAX bound) on one
# signal; each call takes (module or scipy, x) and returns y (or (y, zf))
def _cases():
    b5, a5 = sps.butter(5, 0.15)
    b2, a2 = sps.butter(2, 0.3)
    zi2 = sps.lfiltic(b2, a2, [0.7], [0.7])
    bc, ac = exp_decay_filter(*CLUSTERED, FS, output='ba')
    zc, pc, kc = exp_decay_filter(*CLUSTERED, FS, output='zpk')
    zb, pb, kb = sps.butter(4, 0.12, output='zpk')
    sos4 = sps.butter(4, 0.1, output='sos')
    sos3 = sps.butter(3, 0.2, output='sos')
    dp = _near_unit_double_pole()
    inv = [exp_decay_filter(0.05, 100e-9, FS, inv=True)]
    settle = [exp_decay_filter(a, t, FS, inv=True)
              for a, t in zip([0.02, 0.005], [3e-6, 20e-6])]
    hann = sps.windows.hann(31)
    hann /= hann.sum()

    def sos_split(m, x):
        """sosfilt over two halves with the state carried."""
        zi = np.zeros((sos3.shape[0], 2))
        if m is sps:
            a, zf = sps.sosfilt(sos3, x[:1000], zi=zi)
            return np.concatenate([a, sps.sosfilt(sos3, x[1000:], zi=zf)[0]])
        if m is jiir:
            a, zf = m.sosfilt(jnp.asarray(sos3), x[:1000], zi=jnp.asarray(zi))
            return np.concatenate([a, m.sosfilt(jnp.asarray(sos3), x[1000:],
                                                zi=zf)[0]])
        a, zf = m.sosfilt(sos3, x[:1000], zi=zi)
        return torch.cat([a, m.sosfilt(sos3, x[1000:], zi=zf)[0]])

    def predist(filters, ker=None, initial=0.0):
        def call(m, x):
            if m is sps:
                return predistort(x, filters, ker=ker, initial=initial)
            if m is jiir:
                return m.predistort_jax(x, filters, ker=ker, initial=initial)
            return m.predistort_device(x, filters, ker=ker, initial=initial)
        return call

    def sos_call(sos):
        def call(m, x):
            if m is jiir:
                return m.sosfilt(jnp.asarray(sos), x)
            return m.sosfilt(sos, x)
        return call

    def zpk_call(z, p, k):
        def call(m, x):
            if m is sps:
                return sps.sosfilt(sps.zpk2sos(z, p, k), x)
            return m.filter_zpk(z, p, k, x)
        return call

    def apply_call(sos, initial):
        def call(m, x):
            if m is sps:
                return sps.sosfilt(sos, x - initial) + initial
            if m is jiir:
                return m.iir_apply(jnp.asarray(sos), x, initial)
            return m.iir_apply(sos, x, initial)
        return call

    return {
        # (call, n, bound vs scipy, bound vs JAX)
        'sosfilt_butter4': (sos_call(sos4), 4096, 1e-9, TOL_JAX),
        'sosfilt_zi_streaming': (sos_split, 2048, 1e-9, TOL_JAX),
        'sosfilt_near_unit_double_pole': (sos_call(dp), 20_000, 1e-9,
                                          TOL_JAX),
        'lfilter_butter5': (lambda m, x: m.lfilter(b5, a5, x), 4096, 1e-8,
                            TOL_JAX),
        'lfilter_zi': (lambda m, x: m.lfilter(
            b2, a2, x, zi=zi2 if m is not jiir else jnp.asarray(zi2)),
            1024, 1e-8, TOL_JAX),
        'lfilter_clustered': (lambda m, x: m.lfilter(bc, ac, x), 20_000,
                              1e-5, TOL_JAX_CLUSTERED),
        # poles 1 - 2.5e-5 and 1 - 1.7e-4: JAX's doubling scan is itself
        # 4.6e-8 off scipy on this input, and the port equals JAX to 1e-10
        'lfilter_z_settle': (lambda m, x: m.lfilter(
            *combine_filters(settle), x), 20_000, 1e-7, TOL_JAX),
        'filter_zpk_clustered': (zpk_call(zc, pc, kc), 20_000, 2e-8,
                                 TOL_JAX),
        'filter_zpk_complex_poles': (zpk_call(zb, pb, kb), 20_000, 1e-9,
                                     TOL_JAX),
        'iir_apply_initial': (apply_call(sos4, 0.25), 4096, 1e-9, TOL_JAX),
        'predistort_filters_and_kernel': (predist(inv, hann), 2048, 1e-8,
                                          TOL_JAX),
        'predistort_initial': (predist(inv, None, 0.3), 2048, 1e-8, TOL_JAX),
    }


CASES = _cases()


def _zf_free(y):
    return y[0] if isinstance(y, tuple) else y


@pytest.mark.parametrize('name', list(CASES))
def test_filter_matches_jax_and_scipy(name):
    call, n, tol_sp, tol_jax = CASES[name]
    x = _signal(n, seed=len(name))
    got = _zf_free(call(tiir, torch.tensor(x))).numpy()
    want_jax = np.asarray(_zf_free(call(jiir, jnp.asarray(x))))
    want_sp = _zf_free(call(sps, x))
    assert got.dtype == np.float64 and got.shape == x.shape
    assert rel(got, want_jax) <= tol_jax
    assert rel(got, want_sp) <= tol_sp


@pytest.mark.parametrize('name', list(CASES))
def test_route_equals_jax(name, monkeypatch):
    """Every filter takes the route it takes in JAX: the sequential
    direct form (S1 / lax.scan) exactly where JAX takes it."""
    call, n, _, _ = CASES[name]
    x = _signal(n, seed=1)
    seen = {'port': 0, 'jax': 0}

    def spy(mod, key):
        real = mod._sequential_filter

        def wrapped(*a):
            seen[key] += 1
            return real(*a)
        monkeypatch.setattr(mod, '_sequential_filter', wrapped)

    spy(tiir, 'port')
    spy(jiir, 'jax')
    call(tiir, torch.tensor(x))
    call(jiir, jnp.asarray(x))
    assert seen['port'] == seen['jax']
    sequential = ('clustered' in name and 'zpk' not in name) or (
        'double_pole' in name)
    assert (seen['port'] > 0) == sequential


def test_clustered_direct_form_equals_scipy_bit_for_bit():
    """The recurrence adds no contraction: scipy's C loop and the port's
    direct form give the same bits, zf included."""
    bc, ac = exp_decay_filter(*CLUSTERED, FS, output='ba')
    x = _signal(20_000, seed=3)
    zi = sps.lfiltic(bc, ac, [0.1, 0.2, 0.3], [0.3, 0.2])
    y, zf = tiir.lfilter(bc, ac, torch.tensor(x), zi=zi)
    want, want_zf = sps.lfilter(bc, ac, x, zi=zi)
    np.testing.assert_array_equal(y.numpy(), want)
    np.testing.assert_array_equal(zf.numpy(), want_zf)


@pytest.mark.parametrize('kind', ['doubling', 'sequential'])
def test_rows_batch_with_per_row_state(kind):
    """(rows, n) filters each row as the 1-D call does, with one zi per
    row or one for all, and returns one zf per row."""
    b, a = (sps.butter(3, 0.1) if kind == 'doubling'
            else exp_decay_filter(*CLUSTERED, FS, output='ba'))
    d = max(len(a), len(b)) - 1
    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, 2000))
    zi = rng.standard_normal((3, d)) * 0.1
    y, zf = tiir.lfilter(b, a, torch.tensor(x), zi=zi)
    for r in range(3):
        yr, zfr = tiir.lfilter(b, a, torch.tensor(x[r]), zi=zi[r])
        np.testing.assert_array_equal(y[r].numpy(), yr.numpy())
        np.testing.assert_array_equal(zf[r].numpy(), zfr.numpy())
    y1, zf1 = tiir.lfilter(b, a, torch.tensor(x), zi=zi[0])
    np.testing.assert_array_equal(y1[0].numpy(), y[0].numpy())
    assert tuple(zf1.shape) == (3, d)


def _s1_cases():
    return {
        'butter5': sps.butter(5, 0.15),
        'near_unit_double_pole': (_near_unit_double_pole()[0, :3],
                                  _near_unit_double_pole()[0, 3:]),
        'clustered': exp_decay_filter(*CLUSTERED, FS, output='ba'),
    }


@pytest.mark.parametrize('name', list(_s1_cases()))
def test_s1_plain_matches_jax_scan_and_scipy(name):
    """S1's plain version (the kernel wrapper on CPU tensors) against JAX
    ``_sequential_filter`` and scipy's lfilter, y and zf, from a non-zero
    state."""
    b, a = _s1_cases()[name]
    b = np.asarray(b, float) / a[0]
    a = np.asarray(a, float) / a[0]
    d = len(a) - 1
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 5000))
    zi = rng.standard_normal((2, d)) * 0.01
    y = torch.empty(2, 5000, dtype=torch.float64)
    zf = torch.empty(2, d, dtype=torch.float64)
    coef = torch.tensor(np.concatenate([b, a]))
    kernels.iir_df2t(torch.tensor(x), coef, torch.tensor(zi), y, zf)
    tol = TOL_JAX_CLUSTERED if name == 'clustered' else TOL_JAX
    for r in range(2):
        yj, zfj = jiir._sequential_filter(b, a, jnp.asarray(x[r]),
                                          jnp.asarray(zi[r]))
        assert rel(y[r].numpy(), yj) <= tol
        assert rel(zf[r].numpy(), zfj) <= tol
        ys, zfs = sps.lfilter(b, a, x[r], zi=zi[r])
        np.testing.assert_array_equal(y[r].numpy(), ys)
        np.testing.assert_array_equal(zf[r].numpy(), zfs)


def test_s1_plain_in_f32_and_refusals():
    """An f32 signal filters in f32 (against scipy in f64 at the f32
    scale); a state of more than 16 entries and mixed dtypes raise."""
    b, a = sps.butter(4, 0.2)
    x = np.random.default_rng(2).standard_normal((1, 3000))
    coef = torch.tensor(np.concatenate([b, a]), dtype=torch.float32)
    y = torch.empty(1, 3000)
    zf = torch.empty(1, 4)
    kernels.iir_df2t(torch.tensor(x, dtype=torch.float32), coef,
                     torch.zeros(1, 4), y, zf)
    assert y.dtype == torch.float32
    assert rel(y[0].numpy(), sps.lfilter(b, a, x[0])) < 1e-5
    with pytest.raises(ValueError, match='1 to 16'):
        reference_iir.df2t(torch.zeros(1, 8, dtype=torch.float64),
                           torch.zeros(36, dtype=torch.float64),
                           torch.zeros(1, 17, dtype=torch.float64),
                           torch.empty(1, 8, dtype=torch.float64),
                           torch.empty(1, 17, dtype=torch.float64))


def test_fft_convolve_centered_matches_jax_and_scipy():
    rng = np.random.default_rng(4)
    sig = rng.standard_normal((2, 1000))
    ker = rng.standard_normal(33)
    got = tfft.fft_convolve_centered(torch.tensor(sig), torch.tensor(ker))
    for r in range(2):
        size = sig.shape[1]
        padded = np.hstack([np.zeros(size), sig[r], np.zeros(size)])
        start = size + len(ker) // 2
        ref = sps.fftconvolve(padded, ker, mode='full')[start:start + size]
        np.testing.assert_allclose(got[r].numpy(), ref, rtol=1e-9,
                                   atol=1e-10)
        want = np.asarray(jfft.fft_convolve_centered(jnp.asarray(sig[r]),
                                                     jnp.asarray(ker)))
        assert rel(got[r].numpy(), want) <= TOL_JAX


def test_reflection_round_trip_matches_jax():
    sig = np.zeros(4096)
    sig[1000:2000] = 1.0
    out = tfft.reflection_device(torch.tensor(sig), 0.2, 5e-9, FS)
    want = np.asarray(jfft.reflection_jax(jnp.asarray(sig), 0.2, 5e-9, FS))
    assert rel(out.numpy(), want) <= TOL_JAX
    back = tfft.correct_reflection_device(out, 0.2, 5e-9, FS)
    np.testing.assert_allclose(back.numpy(), sig, atol=1e-9)
    want_back = np.asarray(jfft.correct_reflection_jax(jnp.asarray(want),
                                                       0.2, 5e-9, FS))
    assert rel(back.numpy(), want_back) <= TOL_JAX


@pytest.mark.parametrize('kw', [{}, {'skip': 10}, {'bw': 1e8},
                                {'bw': 1e8, 'skip': 7}],
                         ids=['plain', 'skip', 'bw', 'bw_skip'])
def test_extract_kernel_matches_jax(kw):
    rng = np.random.default_rng(5)
    n = 256
    sig_out = rng.standard_normal(n)
    sig_in = np.convolve(sig_out, np.exp(-np.arange(8) / 3.0))[:n]
    got = tfft.extract_kernel_device(sig_in, sig_out, 1e9, device='cpu',
                                     **kw)
    want = np.asarray(jfft.extract_kernel_jax(sig_in, sig_out, 1e9, **kw))
    assert got.shape == want.shape
    assert rel(got.numpy(), want) <= TOL_JAX
    if kw == {'skip': 10}:
        full = tfft.extract_kernel_device(sig_in, sig_out, 1e9,
                                          device='cpu')
        np.testing.assert_array_equal(got.numpy(), full[10:-10].numpy())


@pytest.mark.parametrize('case', ['plain', 'phases', 'weight_1d',
                                  'weight_2d', 'complex128'])
def test_demod_matrix_array_equal(case):
    freqs, n, sr = [-12.7e6, 32.8e6], 500, 1e9
    rng = np.random.default_rng(1)
    kw = {'phases': {'phases': [0.3, -1.1]},
          'weight_1d': {'weight': rng.uniform(0.5, 1.5, n)},
          'weight_2d': {'weight': rng.uniform(0.5, 1.5, (2, n))},
          'complex128': {'dtype': np.complex128}}.get(case, {})
    jkw = dict(kw, dtype=jnp.complex128) if case == 'complex128' else kw
    got = tdemod.demod_matrix(freqs, n, sr, device='cpu', **kw)
    want = np.asarray(jdemod.demod_matrix(freqs, n, sr, **jkw))
    assert got.numpy().dtype == want.dtype
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize('dtype', [np.float32, np.float64])
def test_demodulate_matches_jax(dtype):
    rng = np.random.default_rng(6)
    sig = rng.standard_normal((3, 800)).astype(dtype)
    m = tdemod.demod_matrix([11e6, -40e6], 800, 2e9, device='cpu')
    mj = jdemod.demod_matrix([11e6, -40e6], 800, 2e9)
    got = tdemod.demodulate(torch.tensor(sig), m)
    want = np.asarray(jdemod.demodulate(jnp.asarray(sig), mj))
    assert got.dtype == torch.complex64 and got.shape == (3, 2)
    assert rel(got.numpy(), want) <= 1e-6


def test_demodulate_restores_the_callers_matmul_precision():
    """demodulate runs its f32 products at 'highest' and leaves the
    process's setting as the caller had it."""
    before = torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision('high')
        m = tdemod.demod_matrix([1e6], 64, 1e9, device='cpu')
        tdemod.demodulate(torch.ones(2, 64), m)
        assert torch.get_float32_matmul_precision() == 'high'
    finally:
        torch.set_float32_matmul_precision(before)


def test_host_arrays_default_to_the_card():
    """A host array with no device goes to 'cuda', which raises without a
    GPU; device='cpu' runs the plain versions."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: the default device works")
    b, a = sps.butter(2, 0.1)
    x = np.ones(64)
    with pytest.raises(RuntimeError, match='cuda'):
        tiir.lfilter(b, a, x)
    with pytest.raises(RuntimeError, match='cuda'):
        tdemod.demod_matrix([1e6], 64, 1e9)
    assert tiir.lfilter(b, a, x, device='cpu').device.type == 'cpu'


def test_doubling_accuracy_on_chip_smoke_rows():
    """chip_smoke.py's doubling-stage bound, on its own rows: the Z-settle
    pair over 4 seeded flagship channels (2,000,000 samples, f64).  The
    port's CPU path equals JAX's doubling scan there, and both stay within
    chip_smoke.TOL_DOUBLING of scipy -- a bound above 1e-9 because the
    reference itself is more than 1e-9 off on one of these rows."""
    import chip_smoke
    import waveforms_tpu_torch as wt
    from waveforms_tpu_torch.schedules import build_schedule
    chans = build_schedule()
    rows = chip_smoke.seeded_rows(128, 4, 9)
    x = wt.synthesize([chans[r] for r in rows], 0.0, 1e-3, FS,
                      device='cpu').double()
    b, a = combine_filters([exp_decay_filter(amp, tau, FS, inv=True)
                            for amp, tau in zip(*chip_smoke.Z_SETTLE)])
    got = tiir.lfilter(b, a, x).numpy()
    worst_jax = 0.0
    for r in range(len(rows)):
        want = sps.lfilter(b, a, x[r].numpy())
        ref = np.asarray(jiir.lfilter(b, a, jnp.asarray(x[r].numpy())))
        assert rel(got[r], ref) <= TOL_JAX
        assert rel(got[r], want) <= chip_smoke.TOL_DOUBLING
        worst_jax = max(worst_jax, rel(ref, want))
    assert worst_jax > 1e-9
