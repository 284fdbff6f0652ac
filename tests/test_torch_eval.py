"""The port's trace evaluator (``ops/torch_eval.py``, engine ``'torch'``)
against the JAX package's (``ops/jax_eval.py``, engine ``'xla'``) under x64
on the CPU, and against the numpy float64 oracle.

Each waveform is built in both packages from the same constructors; the
port evaluates it in torch float64 on the CPU, JAX in XLA float64.  Every
test of ``tests/test_jax_eval.py`` has its counterpart here: every basis,
multi-tone DRAG, mixing, clip, interp, filters with and without an initial
level, ``WaveVStack``, user callbacks, the cache and complex user bases.
Bounds: 1e-12 of each channel's peak against JAX, and the JAX suite's
rtol 1e-9 (atol 1e-12) against the oracle.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import waveforms_tpu as wj
import waveforms_tpu_torch as wt
from waveforms_tpu.ops import jax_eval
from waveforms_tpu.ops.jax_basis import get_traceable as jax_traceable
from waveforms_tpu_torch.ops import torch_eval
from waveforms_tpu_torch.ops.torch_basis import get_traceable
from waveforms_tpu_torch.engine import _quantize_host

TOL_JAX = 1e-12       # of each channel's peak
RTOL = 1e-9           # the JAX suite's bounds against the oracle
ATOL = 1e-12


def peak_err(got, want):
    """max over channels of max|got - want| / max|want|."""
    got = np.atleast_2d(np.asarray(got))
    want = np.atleast_2d(np.asarray(want))
    peak = np.maximum(np.abs(want).max(axis=-1), 1e-300)
    return float((np.abs(got - want).max(axis=-1) / peak).max())


def check(build, t, rtol=RTOL, atol=ATOL):
    """``build(package)`` evaluated by both evaluators on the grid t."""
    wav_t, wav_j = build(wt), build(wj)
    got = torch_eval.evaluate(wav_t, torch.from_numpy(t))
    assert isinstance(got, torch.Tensor)
    got = got.numpy()
    ref = np.asarray(jax_eval.evaluate(wav_j, jnp.asarray(t)))
    assert got.dtype == ref.dtype and got.shape == ref.shape
    assert peak_err(got, ref) <= TOL_JAX
    np.testing.assert_allclose(got, wav_t(t), rtol=rtol, atol=atol)
    return got


def test_x64_active():
    assert jax.config.jax_enable_x64


BASES = [
    ("gaussian", lambda w: w.gaussian(4)),
    ("gaussian-plateau", lambda w: w.gaussian(4, plateau=2)),
    ("gaussian-d2", lambda w: w.gaussian(4, d=2)),
    ("cos", lambda w: w.cos(3.0, 0.7)),
    ("square-erf", lambda w: w.square(2, edge=0.5)),
    ("square-cos", lambda w: w.square(2, edge=0.5, type='cos')),
    ("square-linear", lambda w: w.square(2, edge=0.5, type='linear')),
    ("cosPulse", lambda w: w.cosPulse(2.0)),
    ("coshPulse", lambda w: w.coshPulse(2.0, eps=3.0, plateau=1.0)),
    ("sinc", lambda w: w.sinc(1.5)),
    ("exp", lambda w: w.exp(-0.3)),
    ("exp-complex", lambda w: w.exp(-0.3 + 2j)),
    ("chirp-lin", lambda w: w.chirp(1, 2, 10, 0.3, 'linear')),
    ("chirp-exp", lambda w: w.chirp(1, 2, 10, 0.3, 'exponential')),
    ("chirp-hyp", lambda w: w.chirp(1, 2, 10, 0.3, 'hyperbolic')),
    ("mollifier", lambda w: w.mollifier(4.0, d=1)),
    ("poly", lambda w: w.poly([1.0, 0.5, -0.25])),
    ("drag", lambda w: w.drag(0.5, 2.0, plateau=1.0, delta=0.05,
                              block_freq=1.3, phase=0.2)),
    ("step", lambda w: w.step(1.0)),
    ("sum", lambda w: w.gaussian(4) + 0.5 * w.cos(7.0) * w.square(3)),
    ("derivative", lambda w: w.D(w.gaussian(4) * w.cos(5.0))),
]


@pytest.mark.parametrize("name,build", BASES, ids=[n for n, _ in BASES])
def test_parity_basis(name, build):
    check(build, np.linspace(-6, 12, 4001))


@pytest.mark.parametrize('kind', ['drag_sin', 'drag_sinx'])
def test_parity_multitone_drag(kind):
    t = np.linspace(-10e-9, 50e-9, 2001)
    kw = {} if kind == 'drag_sin' else {'tab': 0.5}
    check(lambda w: getattr(w, kind)(0.2e9, 22e-9, plateau=6e-9, delta=3e6,
                                     block_freq=(150e6, -80e6), phase=0.1,
                                     **kw), t, rtol=1e-9, atol=1e-9)


def mixing_demo(w):
    pulse = w.cosPulse(20e-9)
    x_wav = w.zero()
    for amp, dt, ph in [(0.5, 0, 0), (1.0, 1e-6, np.pi / 2),
                        (0.5, 2e-6, 0)]:
        I, _ = w.mixing((amp * pulse) >> dt, freq=-20e6, phase=ph,
                        DRAGScaling=0.2)
        x_wav += I
    return x_wav


def test_parity_mixing_demo():
    t = np.linspace(-1e-6, 9e-6, 10001)
    # amplitudes are huge (~2.6e7) so compare relative to scale
    oracle = mixing_demo(wt)(t)
    check(mixing_demo, t, rtol=1e-9, atol=1e-9 * np.abs(oracle).max())


def test_parity_clip():
    def build(w):
        wav = 2 * w.gaussian(4)
        wav.max = 1.0
        wav.min = 0.5
        return wav
    check(build, np.linspace(-4, 4, 1001))


def test_parity_interp_basis():
    check(lambda w: w.samplingPoints(0, 10, np.linspace(0, 10, 11) ** 2),
          np.linspace(-1, 11, 500))


@pytest.mark.parametrize('xp_range', [(0.0, 10.0), (2.0, 2.0 + 1e-300)],
                         ids=['plain', 'zero_width'])
def test_interp_edges_are_jnp_interp(xp_range):
    """The interp lowering's edges -- left of the table, right of it, on its
    knots, a zero-width table -- as jnp.interp takes them."""
    start, stop = xp_range
    pts = (1.0, -2.0, 0.5, 3.0, 3.0, -1.0)
    t = np.concatenate([np.linspace(-3, 13, 801),
                        np.linspace(start, stop, len(pts)), [start, stop]])
    from waveforms_tpu.ir import registry as rj
    from waveforms_tpu_torch.ir import registry as rt
    got = get_traceable(rt.INTERP)(torch.from_numpy(t), start, stop,
                                   pts).numpy()
    ref = np.asarray(jax_traceable(rj.INTERP)(jnp.asarray(t), start, stop,
                                              pts))
    assert peak_err(got, ref) <= TOL_JAX
    # the edges hold a table value exactly, as in jnp.interp
    outside = (t < start) | (t > stop)
    np.testing.assert_array_equal(got[outside], ref[outside])
    assert set(got[t < start]) <= {pts[0]} and set(got[t > stop]) <= {
        pts[-1]}


def filtered(w, kind):
    from scipy.signal import butter, tf2sos
    sample_rate = 1000
    if kind == 'lowpass':
        b, a = butter(3, 4.0, 'lowpass', fs=sample_rate)
        wav, initial = w.step(0) * w.cos(20), 0.0
    else:
        b, a = butter(2, 8.0, 'highpass', fs=sample_rate)
        wav, initial = w.step(0) + 1, 1.0
    wav.sample_rate = sample_rate
    wav.start = -1
    wav.stop = 1
    wav.filters = (tf2sos(b, a), initial)
    return wav


@pytest.mark.parametrize('kind', ['lowpass', 'highpass_initial'])
def test_sample_waveform_with_filters(kind):
    """SOS filters with and without an initial level: the port's
    sample_waveform on the CPU against JAX's and the oracle."""
    wav = filtered(wt, kind)
    got = torch_eval.sample_waveform(wav, device='cpu')
    assert got.dtype == torch.float64 and got.device.type == 'cpu'
    ref = np.asarray(jax_eval.sample_waveform(filtered(wj, kind)))
    assert peak_err(got.numpy(), ref) <= TOL_JAX
    np.testing.assert_allclose(got.numpy(), wav.sample(), rtol=1e-9,
                               atol=1e-12)


def test_vstack_parity():
    def build(w):
        wlist = [w.cos(1), w.sin(2), w.gaussian(3) >> 1,
                 w.poly([1, -0.5, 0.1])]
        return (w.WaveVStack(wlist) >> 0.25) + 0.5
    got = check(build, np.linspace(-10, 10, 2001))
    assert got.dtype == np.float64     # the real part, as in JAX


def test_vstack_with_unregistered_function_lib_raises():
    """A stack carrying user basis IDs this process never registered is
    refused before any evaluation, as the JAX evaluator refuses it."""
    stack = wt.WaveVStack([wt.gaussian(3), wt.cos(2)])
    stack.function_lib = {987654: lambda t: t}
    with pytest.raises(ValueError, match='not in this process'):
        torch_eval.evaluate(stack, torch.linspace(-1, 1, 11,
                                                  dtype=torch.float64))


def test_user_function_callback():
    """Unregistered user basis functions run on the host oracle."""
    check(lambda w: w.function(lambda t, a: np.tanh(a * t), 2.0, start=-1,
                               stop=1), np.linspace(-2, 2, 401))


def test_compile_cache_hits():
    w1 = wt.gaussian(4) * wt.cos(5.0)
    w2 = wt.gaussian(4) * wt.cos(5.0)
    f1 = torch_eval.compile_waveform(w1.bounds, w1.seq, w1.min, w1.max)
    f2 = torch_eval.compile_waveform(w2.bounds, w2.seq, w2.min, w2.max)
    assert f1 is f2  # structurally equal IR -> the same evaluator


def test_complex_user_basis_keeps_imaginary_part():
    """A complex-valued user basis keeps its imaginary part through the
    host fallback."""
    w = wt.function(lambda t: np.exp(1j * t))
    w.start, w.stop, w.sample_rate = 0.0, 1.0, 100.0
    t = np.linspace(0, 1, 50)
    host = np.asarray(w(t))
    dev = torch_eval.evaluate(w, torch.from_numpy(t))
    assert dev.is_complex()
    np.testing.assert_allclose(dev.numpy(), host.astype(np.complex128),
                               rtol=2e-6)
    wj_ = wj.function(lambda t: np.exp(1j * t))
    ref = np.asarray(jax_eval.evaluate(wj_, jnp.asarray(t)))
    assert peak_err(dev.numpy(), ref) <= TOL_JAX


# engine='torch' against engine='xla' ---------------------------------------

def engine_channels(w):
    I, Q = w.mixing(0.5 * w.cosPulse(20e-9) >> 5e-8, freq=-20e6,
                    DRAGScaling=1e-10)
    return [I, Q, (1 + 0.5j) * w.gaussian(3e-8) * w.cos(2 * np.pi * 250e6)
            >> 1e-7, w.square(4e-8, edge=1e-8) >> 1.2e-7,
            w.WaveVStack([w.cosPulse(2e-8) >> 3e-8,
                          0.3 * w.gaussian(2e-8) >> 9e-8])]


@pytest.mark.parametrize('part,od', [
    ('real', None), ('imag', None), ('complex', None),
    ('real', np.float32), ('complex', np.float32), ('real', torch.float32)],
    ids=['real', 'imag', 'complex', 'real-f32', 'complex-f32',
         'real-torch-f32'])
def test_engine_torch_matches_xla_and_oracle(part, od):
    """An explicit f32 ``out_dtype`` is the default, as JAX maps it to None
    ("f32 is every engine's default"): float64 (complex128) as from JAX's
    ``'xla'`` under x64."""
    got = wt.synthesize(engine_channels(wt), 0.0, 2.56e-7, 2e9,
                        engine='torch', part=part, device='cpu',
                        out_dtype=od)
    assert isinstance(got, torch.Tensor) and got.device.type == 'cpu'
    assert got.dtype == (torch.complex128 if part == 'complex'
                         else torch.float64)
    ref = np.asarray(wj.synthesize(
        engine_channels(wj), 0.0, 2.56e-7, 2e9, engine='xla', part=part,
        out_dtype=None if od is None else np.float32))
    assert got.shape == ref.shape and got.numpy().dtype == ref.dtype
    assert peak_err(got.numpy(), ref) <= TOL_JAX
    ora = wt.synthesize(engine_channels(wt), 0.0, 2.56e-7, 2e9,
                        engine='numpy', part=part)
    assert peak_err(got.numpy(), ora) <= RTOL


def test_engine_torch_quantizes_as_the_host_engines():
    """int16 codes from the float64 result by the host engines' rule; the
    double tier passes through (float64 already)."""
    chans = engine_channels(wt)[:4]
    f64 = wt.synthesize(chans, 0.0, 2.56e-7, 2e9, engine='torch',
                        device='cpu')
    codes = wt.synthesize(chans, 0.0, 2.56e-7, 2e9, engine='torch',
                          device='cpu', out_dtype=np.int16,
                          dac_scale=[1000.0, 2000.0, 3000.0, 32767.0])
    assert codes.dtype == torch.int16
    np.testing.assert_array_equal(
        codes.numpy(), _quantize_host(f64.numpy(), np.int16,
                                      [1000.0, 2000.0, 3000.0, 32767.0]))
    ref = np.asarray(wj.synthesize(engine_channels(wj)[:4], 0.0, 2.56e-7,
                                   2e9, engine='xla', out_dtype=np.int16,
                                   dac_scale=[1000.0, 2000.0, 3000.0,
                                              32767.0]))
    assert np.abs(codes.numpy().astype(int) - ref).max() <= 1
    double = wt.synthesize(chans, 0.0, 2.56e-7, 2e9, engine='torch',
                           device='cpu', precision='double')
    assert torch.equal(double, f64)


def test_engine_torch_sample_with_filters():
    """wt.sample(engine='torch') filters the float64 signal on the tensor's
    device, as JAX's sample(engine='xla') does."""
    wav = filtered(wt, 'lowpass')
    got = wt.sample(wav, engine='torch', device='cpu')
    ref = np.asarray(wj.sample(filtered(wj, 'lowpass'), engine='xla'))
    assert got.dtype == torch.float64
    assert peak_err(got.numpy(), ref) <= TOL_JAX
    np.testing.assert_allclose(got.numpy(), wav.sample(), rtol=1e-9,
                               atol=1e-12)
