"""The port's expression DSL, command line and namespace against the JAX
package's.

``waveforms_tpu_torch.wave_eval`` parses every expression of the JAX
suite's DSL tests (``tests/test_dsl_conformance.py``, the ``wave_eval``
cases of ``tests/test_misc.py`` and ``tests/test_waveform.py``) to the IR
that JAX's ``wave_eval`` gives, carried over by ``convert.waveform_from_jax``;
the grammar errors and whitelist refusals are the same, message for message.
``python -m waveforms_tpu_torch sample`` writes the JAX CLI's ``.npy`` for
``--engine numpy``, and float32 and int16 within their contracts for
``native`` and ``torch`` (with ``--device cpu``); its default engine is
``torch`` on ``--device`` (default ``cuda``).  ``freeze``,
``__version__``, ``play`` and the ``utils`` exports match, and the port's
``__all__`` holds every name of JAX's.
"""

import os
import subprocess
import sys
import types

import numpy as np
import pytest
import scipy.sparse as sp
import torch
from click.testing import CliRunner

import waveforms_tpu as wj
import waveforms_tpu.__main__ as cli_j
import waveforms_tpu.utils as uj
import waveforms_tpu_torch as wt
import waveforms_tpu_torch.__main__ as cli_t
import waveforms_tpu_torch.utils as ut
from waveforms_tpu_torch.convert import waveform_from_jax
from test_dsl_conformance import CALL_FORMS, IR_PINS, PRECEDENCE_PAIRS

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the wave_eval expressions of tests/test_misc.py and tests/test_waveform.py
SUITE_EXPRESSIONS = [
    "const(-2 + 3)", "const(2 * -3)", "const(-2)", "const((-2) + 3)",
    "one()", "zero()", "pi", "e",
    "(gaussian(8) << 40) + square(12, edge=3, type='linear') * cos(2*pi*7.5)",
    "((gaussian(8) << 15) + ((square(12, 3, type='linear') * cos(2*pi*7.5))"
    " >> 25)) << 25",
    "(gaussian(8) << 40) + square(12, 3, 'linear') * cos(2*pi*7.5)",
    "poly([2, 0, -1/3])", "poly((2, 0, -1/3))",
    "const(1j)", "const(2.5e-3)", "2", "const(2**3**2)", "const(2^3)",
    "gaussian(10)", "D(gaussian(1e-07))", "drag_sin(100.0, 1e-2)",
    "cosPulse(0.5) + 0.2*gaussian(0.3)",
]
EXPRESSIONS = sorted(set(
    [e for pair in PRECEDENCE_PAIRS for e in pair]
    + [e for e, _ in CALL_FORMS] + [e for e, _, _ in IR_PINS]
    + SUITE_EXPRESSIONS))

# tests/test_dsl_conformance.py's and tests/test_waveform.py's refusals
REFUSED = ["x = gaussian(10)", "gaussian(10", "gaussian(10) $ 2",
           "nosuch(1)", "unknown_fn(1)", "import os", "()", "cast(1, 2)",
           "np([1])", "play(one())", "Waveform()", "lower_schedule()",
           "function(1)", "freeze([1])",
           "mixing(cosPulse(2e-08), freq=-2e8)"]


@pytest.mark.parametrize('expr', EXPRESSIONS)
def test_wave_eval_matches_jax(expr):
    got = wt.wave_eval(expr)
    ref = wj.wave_eval(expr)
    assert type(got).__module__.startswith('waveforms_tpu_torch')
    assert got == waveform_from_jax(ref)
    assert (got.bounds, got.seq, got.min, got.max) == (
        ref.bounds, ref.seq, ref.min, ref.max)
    t = np.linspace(-4, 4, 201)
    np.testing.assert_array_equal(np.asarray(got(t)), np.asarray(ref(t)))


@pytest.mark.parametrize('expr', REFUSED)
def test_refusals_match_jax(expr):
    with pytest.raises(SyntaxError) as got:
        wt.wave_eval(expr)
    with pytest.raises(SyntaxError) as ref:
        wj.wave_eval(expr)
    assert str(got.value) == str(ref.value)


def test_whitelist_is_jax_whitelist():
    from waveforms_tpu.dsl import parser as pj
    from waveforms_tpu_torch.dsl import parser as pt
    assert pt._FUNCTIONS == pj._FUNCTIONS
    for name in sorted(pt._FUNCTIONS):
        fn = pt._resolve_function(name)
        assert fn.__module__.startswith('waveforms_tpu_torch'), name
        assert fn.__name__ == pj._resolve_function(name).__name__
    from waveforms_tpu_torch.models.mixing import mixing as mixing_fn
    assert pt._resolve_function('mixing') is mixing_fn


def test_wave_eval_fresh_headers():
    """Each call returns a fresh header over the cached IR."""
    a = wt.wave_eval('gaussian(10)')
    b = wt.wave_eval('gaussian(10)')
    a.sample_rate = 123.0
    assert b.sample_rate is None and a == b and a.seq is b.seq


# the command line ------------------------------------------------------------

EXPR = "cosPulse(0.5) + 0.2*gaussian(0.3)"
WINDOW = ['-S', '1000', '-a', '-1', '-b', '1']
NUMPY = ['--engine', 'numpy', '--device', 'cpu']   # the JAX CLI's default


def run_cli(main, tmp_path, name, *args):
    out = tmp_path / name
    r = CliRunner().invoke(main, ['sample', *args, EXPR, str(out)])
    assert r.exit_code == 0, (r.output, r.exception)
    return np.load(out)


@pytest.mark.parametrize('args', [WINDOW, WINDOW + ['-A', '2'],
                                  ['-S', '500', '-l', '1'],
                                  WINDOW + ['--dtype', 'float32'],
                                  WINDOW + ['--dtype', 'int16',
                                            '--dac-scale', '1000']],
                         ids=['f64', 'amplitude', 'duration_quirk', 'f32',
                              'int16'])
def test_cli_numpy_writes_the_jax_cli_file(tmp_path, args):
    got = run_cli(cli_t.main, tmp_path, 'port.npy', *args, *NUMPY)
    ref = run_cli(cli_j.main, tmp_path, 'jax.npy', *args)
    assert got.dtype == ref.dtype and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize('engine', ['native', 'torch', None],
                         ids=['native', 'torch', 'default'])
@pytest.mark.parametrize('dtype', ['float64', 'float32', 'int16'])
def test_cli_engines_within_their_contracts(tmp_path, engine, dtype):
    """native (f32 descriptors: 2e-7 of the peak) and torch, the default
    engine (float64: 1e-12), against the numpy engine's file; float32
    rounds that once more and int16 codes within one."""
    args = WINDOW + ['--dtype', dtype]
    pick = [] if engine is None else ['--engine', engine]
    got = run_cli(cli_t.main, tmp_path, 'got.npy', *args, *pick, '--device',
                  'cpu')
    ref = run_cli(cli_t.main, tmp_path, 'ref.npy', *args, *NUMPY)
    assert got.dtype == ref.dtype and got.shape == ref.shape
    if dtype == 'int16':
        assert np.abs(got.astype(int) - ref).max() <= 1
        return
    tol = 2e-7 if engine == 'native' else 1e-12
    if dtype == 'float32':
        tol += 2.0 ** -24
    assert np.abs(got - ref).max() <= tol * np.abs(ref).max()


def test_cli_cuda_engine_on_the_cpu(tmp_path):
    """The kernel route on --device cpu (its plain versions) writes the f32
    plane within the f32 contract of the numpy engine's file."""
    got = run_cli(cli_t.main, tmp_path, 'got.npy', *WINDOW, '--engine',
                  'auto', '--device', 'cpu')
    ref = run_cli(cli_t.main, tmp_path, 'ref.npy', *WINDOW, *NUMPY)
    assert got.dtype == np.float64
    assert np.abs(got - ref).max() <= 2e-6 * np.abs(ref).max()


def test_cli_refuses_what_jax_refuses(tmp_path):
    for bad in ("gaussian(10", "nosuch(1)"):
        r = CliRunner().invoke(cli_t.main, ['sample', bad,
                                            str(tmp_path / 'x.npy')])
        assert r.exit_code != 0 and isinstance(r.exception, SyntaxError)
    r = CliRunner().invoke(cli_t.main, ['sample', '--engine', 'xla', EXPR,
                                        str(tmp_path / 'x.npy')])
    assert r.exit_code != 0 and not (tmp_path / 'x.npy').exists()
    if not torch.cuda.is_available():
        # with no --device the default engine asks for the card
        r = CliRunner().invoke(cli_t.main, ['sample', *WINDOW, EXPR,
                                            str(tmp_path / 'x.npy')])
        assert r.exit_code != 0 and not (tmp_path / 'x.npy').exists()


def test_python_dash_m_runs(tmp_path):
    """``python -m waveforms_tpu_torch sample`` as a user runs it."""
    out = tmp_path / 'out.npy'
    r = subprocess.run([sys.executable, '-m', 'waveforms_tpu_torch',
                        'sample', *WINDOW, *NUMPY, EXPR, str(out)],
                       cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    ref = run_cli(cli_j.main, tmp_path, 'jax.npy', *WINDOW)
    np.testing.assert_array_equal(np.load(out), ref)


# the namespace ---------------------------------------------------------------

def test_all_holds_every_jax_name():
    assert set(wj.__all__) <= set(wt.__all__)
    for name in wt.__all__:
        assert hasattr(wt, name), name


def test_version_play_and_wave_eval():
    assert wt.__version__ == wj.__version__
    assert wt.play is wt.core.play
    assert wt.wave_eval is wt.dsl.wave_eval


def test_utils_exports():
    assert ut.__all__ == uj.__all__ == ['freeze', 'getFTMatrix', 'shift']
    rng = np.random.default_rng(7)
    sig = rng.standard_normal(257)
    np.testing.assert_array_equal(ut.shift(sig, 3.3e-9, 1e-9),
                                  uj.shift(sig, 3.3e-9, 1e-9))
    np.testing.assert_array_equal(
        ut.getFTMatrix([10e6, 25e6], 256, sampleRate=1e9),
        uj.getFTMatrix([10e6, 25e6], 256, sampleRate=1e9))


def test_freeze_matches_jax():
    def payload():
        return {'a': [1, 2, {3, 4}], 'b': (np.arange(3), bytearray(b'xy')),
                'c': sp.csr_matrix(np.eye(3)), 'd': 'text'}
    got, ref = ut.freeze(payload()), uj.freeze(payload())
    assert isinstance(got, types.MappingProxyType)
    assert got['a'] == ref['a'] == (1, 2, frozenset({3, 4}))
    assert got['b'][1] == ref['b'][1] == b'xy'
    assert not got['b'][0].flags.writeable
    assert not got['c'].data.flags.writeable
    assert not got['c'].indices.flags.writeable
    assert got['d'] == 'text'
    with pytest.raises(TypeError):
        got['e'] = 1
