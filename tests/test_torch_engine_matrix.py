"""The JAX suite's constructor-by-engine matrix
(``tests/test_engine_matrix.py``) held against the port.

Every public constructor of the JAX file, built with the JAX package's
constructors and with the port's (``schedules.CONSTRUCTORS``), equal in the
wire format, through every port engine on ``device='cpu'`` (the kernels'
plain versions): ``torch`` (JAX's ``'xla'``) within 1e-9 of the float64
oracle and 1e-12 of JAX's ``'xla'``, the host engine and the kernels within
the JAX file's 5e-6 of the oracle and of JAX's ``native``; a constructor
that a kernel cannot lower raises ``UnsupportedFactor`` on both sides.
Then ``out_dtype=int16`` on every engine, its validation and the
per-channel scale.  The routed calls run under both routing rules (the
``rule`` fixture): the JAX package's and the H100's.
"""

from functools import lru_cache

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import waveforms_tpu as wj
from waveforms_tpu.engine import synthesize as synthesize_j
import waveforms_tpu_torch as wt
from waveforms_tpu_torch import schedules
from waveforms_tpu_torch.convert import waveform_from_jax
from test_engine_matrix import CASES, FS, SPAN
from test_torch_fuzz_engines import rule  # noqa: F401  (the fixture)

TOL = 5e-6          # the JAX file's, of the peak
TOL_TORCH = 1e-9    # 'torch' (JAX's 'xla') against the oracle
TOL_TORCH_JAX = 1e-12   # 'torch' against JAX's 'xla' (test_torch_eval)

NAMES = [n for n, _ in CASES]
BUILD_J = dict(CASES)
BUILD_T = dict(schedules.CONSTRUCTORS)
# each port engine -> the JAX engine that must refuse what it refuses
JAX_ENGINE = {'torch': 'xla', 'native': 'native', 'auto': 'pallas',
              'cuda-dense': 'pallas-dense', 'cuda-panel': 'pallas-panel',
              'cuda-sparse': 'pallas-sparse', 'cuda-stack': 'pallas-stack'}


@lru_cache(maxsize=None)
def oracle(name):
    t = np.arange(0, SPAN, 1 / FS)
    return np.asarray(BUILD_J[name]()(t), float)


@lru_cache(maxsize=None)
def jax_out(name, eng):
    return np.asarray(synthesize_j([BUILD_J[name]()], 0, SPAN, FS,
                                   engine=eng))[0]


def rel(out, want):
    out = out.numpy() if isinstance(out, torch.Tensor) else np.asarray(out)
    return float(np.abs(out[:len(want)] - want).max()
                 / max(np.abs(want).max(), 1e-30))


def run(name, eng, **kw):
    """The port's output for one constructor on ``eng``, or None where the
    port refuses it -- after checking that the JAX package refuses it
    too."""
    try:
        return wt.synthesize([BUILD_T[name]()], 0, SPAN, FS, engine=eng,
                             device='cpu', **kw)[0]
    except wt.UnsupportedFactor:
        with pytest.raises(wj.UnsupportedFactor):
            synthesize_j([BUILD_J[name]()], 0, SPAN, FS,
                         engine=JAX_ENGINE[eng], **kw)
        return None


def test_constructor_inventory_is_the_jax_one():
    assert [n for n, _ in schedules.CONSTRUCTORS] == NAMES
    assert (schedules.MATRIX_FS, schedules.MATRIX_SPAN) == (FS, SPAN)


@pytest.mark.parametrize('name', NAMES)
def test_constructor_is_the_jax_one(name):
    w_t, w_j = BUILD_T[name](), BUILD_J[name]()
    assert type(w_t).__name__ == type(w_j).__name__
    assert w_t.tolist() == waveform_from_jax(w_j).tolist()


@pytest.mark.parametrize('engine', ['torch', 'native', 'cuda-dense',
                                    'cuda-panel', 'cuda-sparse'])
@pytest.mark.parametrize('name', NAMES)
def test_constructor_engine_matrix(name, engine):
    out = run(name, engine)
    if out is None:
        return
    if engine == 'torch':
        assert out.dtype == torch.float64
        assert rel(out, oracle(name)) < TOL_TORCH, name
        assert rel(out, jax_out(name, 'xla')) <= TOL_TORCH_JAX, name
    else:
        assert rel(out, oracle(name)) < TOL, f"{name} x {engine}"
        assert rel(out, jax_out(name, 'native')) < TOL, f"{name} x {engine}"


@pytest.mark.parametrize('name', NAMES)
def test_constructor_routed(name, rule):  # noqa: F811
    """``engine='auto'`` on every constructor, under each rule."""
    out = run(name, 'auto')
    assert out is not None
    assert rel(out, oracle(name)) < TOL, f"{name} ({rule})"
    assert rel(out, jax_out(name, 'native')) < TOL, f"{name} ({rule})"


@pytest.mark.parametrize('name', ['cosPulse', 'gaussian', 'drag', 'mixing_I',
                                  'chirp_linear'])
def test_constructor_stack_engine(name):
    """The stack kernel, forced, on the constructor classes it takes."""
    out = run(name, 'cuda-stack')
    if out is None:
        return
    assert rel(out, oracle(name)) < TOL, name
    assert rel(out, jax_out(name, 'native')) < TOL, name


def _int16_channel(lib):
    rng = np.random.default_rng(51)
    ch = lib.zero()
    for o in rng.uniform(0.2e-6, SPAN - 0.5e-6, 12):
        ch += 0.7 * lib.cosPulse(150e-9) >> float(o)
    return [ch]


def test_out_dtype_int16_across_engines(rule):  # noqa: F811
    """``out_dtype=int16`` gives the same DAC codes on every engine, to
    within one code of the numpy engine's (engines round apart where a
    value lands within float noise of .5); the numpy engine's codes are
    the JAX package's."""
    chans = _int16_channel(wt)
    assert chans[0].tolist() == waveform_from_jax(
        _int16_channel(wj)[0]).tolist()
    host = wt.synthesize(chans, 0, SPAN, FS, engine='numpy',
                         out_dtype=torch.int16)
    np.testing.assert_array_equal(host, synthesize_j(
        _int16_channel(wj), 0, SPAN, FS, engine='numpy',
        out_dtype=jnp.int16))
    for eng in ('torch', 'native', 'auto', 'cuda-dense', 'cuda-panel',
                'cuda-sparse', 'cuda-stack'):
        got = wt.synthesize(chans, 0, SPAN, FS, engine=eng,
                            out_dtype=torch.int16, device='cpu')
        got = got.numpy() if isinstance(got, torch.Tensor) else got
        assert got.dtype == np.int16, eng
        assert np.abs(got.astype(np.int32)
                      - host.astype(np.int32)).max() <= 1, eng


def test_out_dtype_validation():
    """The refusals of the JAX file, with its messages."""
    ch = [wt.cosPulse(200e-9) >> 1e-6]
    with pytest.raises(ValueError, match="double"):
        wt.synthesize(ch, 0, SPAN, FS, precision='double',
                      out_dtype=torch.int16, device='cpu')
    with pytest.raises(ValueError, match="complex"):
        wt.synthesize(ch, 0, SPAN, FS, part='complex',
                      out_dtype=torch.int16, device='cpu')


def test_out_dtype_per_channel_scale(rule):  # noqa: F811
    """A per-channel ``dac_scale``: the numpy engine's codes are the JAX
    package's and clip(round(f * scale)); the routed kernels' within one
    code of them."""
    def chans(lib):
        return [lib.cosPulse(200e-9) >> 1e-6,
                0.5 * lib.gaussian(300e-9) >> 2e-6]
    scale = np.array([1000.0, 20000.0])
    a = wt.synthesize(chans(wt), 0, SPAN, FS, engine='numpy',
                      out_dtype=torch.int16, dac_scale=scale)
    f = wt.synthesize(chans(wt), 0, SPAN, FS, engine='numpy')
    want = np.clip(np.round(f * scale[:, None]), -32768, 32767)
    assert np.array_equal(a, want.astype(np.int16))
    np.testing.assert_array_equal(a, synthesize_j(
        chans(wj), 0, SPAN, FS, engine='numpy', out_dtype=jnp.int16,
        dac_scale=scale))
    got = wt.synthesize(chans(wt), 0, SPAN, FS, out_dtype=torch.int16,
                        dac_scale=scale, device='cpu').numpy()
    assert np.abs(got.astype(np.int32) - a.astype(np.int32)).max() <= 1
