"""The port's C++ host layer (``waveforms_tpu_torch.native``) against the
JAX package's (``waveforms_tpu.native``) and the float64 oracle.

The port carries the JAX package's two C++ sources and builds them with the
same flags into ``build/waveforms_tpu_torch/``.  So on the same waveforms,
built in each package, the port's lowering walker gives descriptors equal
to JAX's walker's element for element, ``args`` and ``ext`` included, and
its host engine (``engine='native'``) is bit-equal to JAX's
``synthesize_native`` on the same ``LoweredSchedule``.  Against the port's
own Python lowering path the walker agrees as in the JAX suite
(``tests/test_native.py``); against the oracle the engine stays within that
suite's bounds (the descriptors' f32 arguments set them).  A build that
cannot run raises; there is no fallback.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import bench
import chip_smoke
import waveforms_tpu as wj
import waveforms_tpu.native as nj
import waveforms_tpu.ops.lowering as lj
import waveforms_tpu_torch as wt
import waveforms_tpu_torch.ops.lowering as lt
from waveforms_tpu_torch import native, schedules
from waveforms_tpu_torch.convert import lowered_from_jax
from waveforms_tpu_torch.engine import _quantize_host
from test_torch_lowering import assert_lowered_equal, opcode_cases

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STRUCTURE = ('seg_lo', 'seg_hi', 'nterm', 'amp', 'nfac', 'op', 'power',
             'shift_hi', 'q32')


def python_lowering(low_fn, *args, **kw):
    """The port's lowering on its Python path (the walker switched off)."""
    orig = lt._lower_schedule_native
    lt._lower_schedule_native = lambda *a, **k: None
    try:
        return low_fn(*args, **kw)
    finally:
        lt._lower_schedule_native = orig


def check(build, start, stop, fs, rtol=2e-7):
    """The port's walker and engine on ``build(package)``'s channels: the
    oracle within ``rtol`` of each channel's peak (the JAX suite's check),
    and JAX's walker and engine on the same waveforms, equal."""
    chans = build(wt)
    low = lt.lower_schedule(chans, start, stop, fs)
    out = native.synthesize_native(low)
    t = np.arange(start, stop, 1 / fs)
    for i, ch in enumerate(chans):
        oracle = ch(t)
        scale = max(np.abs(oracle).max(), 1e-30)
        err = np.abs(out[i] - oracle).max() / scale
        assert err < rtol, f"channel {i}: rel err {err}"
    low_j = lj.lower_schedule(build(wj), start, stop, fs)
    assert_lowered_equal(low, lowered_from_jax(low_j))
    np.testing.assert_array_equal(
        native.synthesize_native(lowered_from_jax(low_j)),
        nj.synthesize_native(low_j))
    np.testing.assert_array_equal(out, nj.synthesize_native(low_j))


def test_both_walkers_are_built():
    """The comparisons below are walker against walker."""
    assert native.lower_available() and native.available()
    assert nj.lower_available() and nj.available()


def test_native_basis_parity():
    check(lambda w: [w.gaussian(1e-6), w.cosPulse(1e-6),
                     w.square(1e-6, edge=0.2e-6), w.sinc(20e6),
                     w.cosh(1e6) * w.square(2e-6),
                     w.sinh(1e6) * w.square(2e-6), w.gaussian(1e-6, d=2),
                     w.poly([0.5, 1e5, -1e11]) * w.square(3e-6)],
          -2e-6, 2e-6, 1e9)
    # mollifier derivative coefficients quantize to f32 with partial
    # cancellation near the bump edge: ~1e-6 relative
    check(lambda w: [w.mollifier(1e-6, d=2)], -2e-6, 2e-6, 1e9, rtol=5e-6)


def test_native_carriers_and_drag():
    def build(w):
        I, Q = w.mixing(0.5 * w.cosPulse(20e-9), freq=-20e6,
                        DRAGScaling=1e-10)
        return [I, Q, w.gaussian(3e-3) * w.cos(2 * np.pi * 250e6, 0.3),
                w.drag(100e6, 20e-9, plateau=10e-9, delta=2e6,
                       block_freq=250e6, phase=0.4, t0=3e-9) >> 0.1e-6]
    check(build, -0.1e-6, 0.4e-6, 2e9)


def test_native_chirps():
    check(lambda w: [w.chirp(1e6, 50e6, 1e-5, 0.3, 'linear')], 0, 1e-5, 2e9,
          rtol=1e-6)
    # exotic chirps lower as adaptively-windowed exact quadratic phases
    check(lambda w: [w.chirp(1e6, 50e6, 1e-5, 0.3, 'exponential'),
                     w.chirp(1e6, 50e6, 1e-5, 0.3, 'hyperbolic')],
          0, 1e-5, 2e9, rtol=2e-6)


def test_native_clip_and_silence():
    w = 2 * wt.gaussian(1e-6)
    w.max = 1.0
    w.min = 0.2
    low = lt.lower_schedule([w], -4e-6, 4e-6, 1e9)
    out = native.synthesize_native(low)
    t = np.arange(-4e-6, 4e-6, 1e-9)
    np.testing.assert_allclose(out[0], w(t), atol=2e-7)
    # silence outside segments stays exactly zero despite min=0.2
    assert out[0, 0] == 0.0


def test_native_bucketed_vstack():
    def build(w):
        rng = np.random.default_rng(3)
        return [w.WaveVStack([(0.5 * w.cosPulse(50e-9) >> o)
                              for o in rng.uniform(0, 8e-6, 200)])]
    stack = build(wt)[0]
    low = lt.lower_schedule([stack], 0, 8.192e-6, 2e9, bucket_samples=2048)
    out = native.synthesize_native(low)
    t = np.arange(0, 8.192e-6, 0.5e-9)
    np.testing.assert_allclose(out[0], stack(t), atol=2e-7)
    low_j = lj.lower_schedule(build(wj), 0, 8.192e-6, 2e9,
                              bucket_samples=2048)
    assert_lowered_equal(low, lowered_from_jax(low_j))
    np.testing.assert_array_equal(out, nj.synthesize_native(low_j))


def test_native_interp_table():
    y = np.sin(np.linspace(0, 3, 33))
    w = wt.samplingPoints(0, 10e-6, y)
    low = lt.lower_schedule([w], -1e-6, 12e-6, 1e9)
    # linear interpolation expands to affine segments: every engine runs it
    assert low.pallas_ok
    out = native.synthesize_native(low)
    t = np.arange(-1e-6, 12e-6, 1e-9)
    np.testing.assert_allclose(out[0], w(t), atol=2e-7)
    check(lambda p: [p.samplingPoints(0, 10e-6, y)], -1e-6, 12e-6, 1e9)


def multitone(w, tab=0.5):
    bf = (151e6, -83e6, 217e6)
    # plateau edges off the sample grid (the reference's construction is
    # discontinuous at the plateau edge, so on-grid edges tie-break)
    return (w.drag_sin(0.2e9, 22.3e-9, plateau=6.1e-9, delta=3e6,
                       block_freq=bf, phase=0.1),
            w.drag_sinx(0.2e9, 22.3e-9, plateau=6.1e-9, delta=3e6,
                        block_freq=bf, phase=0.1, tab=tab))


def test_native_multitone_drag():
    w1, w2 = multitone(wt)
    low = lt.lower_schedule([w1, w2], -5e-9, 40e-9, 2e9)
    out = native.synthesize_native(low)
    t = np.arange(-5e-9, 40e-9, 0.5e-9)
    for i, w_ in enumerate([w1, w2]):
        scale = np.abs(w_(t)).max()
        assert np.abs(out[i] - w_(t)).max() / scale < 5e-7
    check(lambda p: list(multitone(p)), -5e-9, 40e-9, 2e9, rtol=5e-7)


def drag_sin_channels(w):
    w1, w2 = multitone(w)
    return [w1, w2, w.gaussian(20e-9) * w.cos(2 * np.pi * 250e6), w1 >> 5e-9]


def assert_matches_python_path(low, low_py):
    """The JAX suite's agreement of the walker with the Python path: the
    integer arrays and amplitudes equal, args within 1e-12, ext within rtol
    1e-10 (independent float64 reductions rounded to f32)."""
    for name in STRUCTURE:
        np.testing.assert_array_equal(getattr(low, name),
                                      getattr(low_py, name), err_msg=name)
    np.testing.assert_allclose(low.args, low_py.args, atol=1e-12)
    assert low.ext.size == low_py.ext.size
    np.testing.assert_allclose(low.ext, low_py.ext, rtol=1e-10, atol=1e-18)


def test_native_lowering_matches_python_for_drag_sin():
    """The C++ walker's drag_sin/sinx descriptors match the Python path.

    Covers the ext side-buffer ABI: channel-local offsets rebase into the
    shared buffer and identical static blocks dedup across channels.
    """
    chans = drag_sin_channels(wt)
    low = lt.lower_schedule(chans, -5e-9, 40e-9, 2e9)
    low_py = python_lowering(lt.lower_schedule, chans, -5e-9, 40e-9, 2e9)
    assert_matches_python_path(low, low_py)
    # the shifted copy of w1 shares its ext block (dedup)
    assert low.pallas_ok


def test_native_lowering_interleaved_ext_dedup():
    """Dedup HIT after another block was appended: the re-used factor's
    length slot is the original block's length, not the buffer tail."""
    bf = (151e6,)
    a = wt.drag_sin(0.2e9, 22.3e-9, plateau=6.1e-9, delta=3e6,
                    block_freq=bf, phase=0.1)
    b = wt.drag_sinx(0.2e9, 22.3e-9, plateau=6.1e-9, delta=3e6,
                     block_freq=bf, phase=0.1, tab=0.5)
    # one channel: A, then B (new key), then A again (dedup hit)
    ch = wt.WaveVStack([a, b >> 60e-9, a >> 120e-9])
    low = lt.lower_schedule([ch], -5e-9, 160e-9, 2e9)
    low_py = python_lowering(lt.lower_schedule, [ch], -5e-9, 160e-9, 2e9)
    np.testing.assert_allclose(low.args, low_py.args, atol=1e-12)
    assert low.ext.size == low_py.ext.size
    np.testing.assert_allclose(low.ext, low_py.ext, rtol=1e-10, atol=1e-18)


def test_native_complex_pair():
    """part='complex' runs the C++ engine in one pair-mode pass."""
    def build(w):
        I, Q = w.mixing(0.5 * w.cosPulse(50e-9), freq=-80e6,
                        DRAGScaling=1e-10)
        return [(1 + 0.5j) * w.gaussian(2e-7) * w.cos(2 * np.pi * 150e6),
                I + 1j * Q]
    chans = build(wt)
    low = lt.lower_schedule(chans, -1e-7, 1e-7, 2e9, part='complex')
    assert low.amp_im is not None
    out = native.synthesize_native(low)
    assert out.dtype == np.complex128
    ora = wt.synthesize(chans, -1e-7, 1e-7, 2e9, engine='numpy',
                        part='complex')
    err = np.abs(out - ora).max() / np.abs(ora).max()
    assert err < 2e-7, f"rel err {err}"
    got = wt.synthesize(chans, -1e-7, 1e-7, 2e9, engine='native',
                        part='complex')
    np.testing.assert_array_equal(got, out)
    np.testing.assert_array_equal(
        got, wj.synthesize(build(wj), -1e-7, 1e-7, 2e9, engine='native',
                           part='complex'))


def test_native_boundary_conditions():
    """Sub-sample pulses, high powers, near-Nyquist carriers."""
    def build(w):
        return [w.gaussian(0.4e-9) >> 3.7e-9,         # narrower than a sample
                (w.gaussian(50e-9) ** 6) >> 100e-9,   # integer power 6
                w.cosPulse(2e-9) * w.cos(2 * np.pi * 400e6) >> 200e-9]
    check(build, 0, 0.4e-6, 1e9, rtol=1e-6)


def test_lowered_schedule_save_load(tmp_path):
    chans = [wt.gaussian(2e-7) * wt.cos(2 * np.pi * 150e6)]
    low = lt.lower_schedule(chans, -5e-7, 5e-7, 2e9)
    path = tmp_path / "sched.npz"
    low.save(path)
    low2 = lt.LoweredSchedule.load(path)
    np.testing.assert_array_equal(native.synthesize_native(low),
                                  native.synthesize_native(low2))
    assert low2.pallas_ok == low.pallas_ok


def test_native_lowering_malformed_ir_falls_back():
    """Malformed user-built IR makes the walker decline the channel (None,
    counted as a Python-path channel), never crash the interpreter."""
    grid = np.arange(0.0, 1e-6, 5e-10)
    bad_pieces = [
        # bounds/seq length mismatch
        ((1e-7, np.inf), ((((4, 1e8, 0.0),), (1,)),)),
        # expr not a (terms, amps) pair
        ((np.inf,), ("nonsense",)),
        # factors/powers length mismatch
        ((np.inf,), (((((4, 1e8, 0.0), (2, 1.0, 0.0)), (1,)), (1.0,)),)),
        # factor too short for its opcode's argument count
        ((np.inf,), (((((13, 0.0),), (1,)),), (1.0,))),
        # factor not a tuple
        ((np.inf,), ((((42.0,), (1,)),), (1.0,))),
    ]
    native.reset_lower_counts()
    for pieces in bad_pieces:
        assert native.lower_channel_flat([pieces], grid, 0.0, 5e-10,
                                         0) is None, pieces
    assert native.lower_counts() == {'walker': 0, 'python': len(bad_pieces)}


def test_lower_counts_split_walker_and_python_channels():
    """A factor the walker does not take (here a Hermite order given as a
    float) makes it decline the channel: that channel lowers on the Python
    path into the same assembly, and the counts say so."""
    chans = [wt.gaussian(2e-8) >> 1e-7, wt.gaussian(2e-8, d=2.0),
             wt.cosPulse(4e-8)]
    native.reset_lower_counts()
    low = lt.lower_schedule(chans, -2e-7, 2e-7, 1e9)
    assert native.lower_counts() == {'walker': 2, 'python': 1}
    low_py = python_lowering(lt.lower_schedule, chans, -2e-7, 2e-7, 1e9)
    assert_matches_python_path(low, low_py)
    # part='complex' and keep_f64 bypass the walker in both packages
    native.reset_lower_counts()
    lt.lower_schedule(chans[:1], -2e-7, 2e-7, 1e9, part='complex')
    lt.lower_schedule(chans[:1], -2e-7, 2e-7, 1e9, keep_f64=True)
    assert native.lower_counts() == {'walker': 0, 'python': 0}


@pytest.mark.parametrize('case', list(opcode_cases(wt)))
def test_walker_matches_jax_walker_on_every_opcode(case):
    """Walker against walker: every descriptor array equal, args and ext
    included (one source, one set of flags)."""
    cj, start, stop, fs, bs = opcode_cases(wj)[case]
    ct = opcode_cases(wt)[case][0]
    low_j = lj.lower_schedule(cj, start, stop, fs, bucket_samples=bs)
    low_t = lt.lower_schedule(ct, start, stop, fs, bucket_samples=bs)
    assert_lowered_equal(low_t, lowered_from_jax(low_j))


@pytest.mark.parametrize('stratum', ['flagship', 'mid', 'dense'])
def test_walker_matches_jax_walker_on_bench_schedules(stratum):
    """bench.py's three schedules at 4 channels over their full spans."""
    build_j = {'flagship': bench.build_schedule,
               'mid': bench.build_mid_schedule,
               'dense': bench.build_dense_schedule}[stratum]
    build_t, stop = schedules.STRATA[stratum]
    native.reset_lower_counts()
    low_t = lt.lower_schedule(build_t(n_channels=4), 0.0, stop,
                              schedules.FS)
    assert native.lower_counts() == {'walker': 4, 'python': 0}
    low_j = lj.lower_schedule(build_j(n_channels=4), 0.0, stop, bench.FS)
    assert_lowered_equal(low_t, lowered_from_jax(low_j))


@pytest.mark.parametrize('case', ['drag_sin_dedup', 'interleaved_dedup',
                                  'interp', 'chirps'])
def test_walker_matches_jax_walker_on_ext_and_expansions(case):
    """The ext side buffer with its dedup, the interp table's affine
    expansion and the three chirps' windows: walker against walker."""
    def build(w):
        if case == 'drag_sin_dedup':
            return drag_sin_channels(w), -5e-9, 40e-9
        if case == 'interleaved_dedup':
            a, b = multitone(w)
            return ([w.WaveVStack([a, b >> 60e-9, a >> 120e-9]), b],
                    -5e-9, 160e-9)
        if case == 'interp':
            y = np.sin(np.linspace(0, 3, 33)) + 0.1
            return [w.samplingPoints(0, 10e-6, y),
                    w.samplingPoints(1e-6, 3e-6, y[:9]) >> 2e-6], -1e-6, 12e-6
        return ([w.chirp(1e6, 50e6, 1e-5, 0.3, kind)
                 for kind in ('linear', 'exponential', 'hyperbolic')],
                0.0, 1e-5)
    ct, start, stop = build(wt)
    cj = build(wj)[0]
    low_t = lt.lower_schedule(ct, start, stop, 2e9)
    low_j = lj.lower_schedule(cj, start, stop, 2e9)
    assert_lowered_equal(low_t, lowered_from_jax(low_j))
    assert low_t.ext.size == low_j.ext.size


@pytest.mark.parametrize('stratum', ['flagship', 'mid', 'dense'])
def test_walker_agrees_with_python_path_on_bench_schedules(stratum):
    """chip_smoke.py's agreement of the walker with the Python path, on the
    bench schedules at 8 channels: the structure arrays equal, q32 within
    one step, args within one f32 ulp plus one phase step 2*pi/2^32, ext
    within rtol 1e-10."""
    build, stop = schedules.STRATA[stratum]
    chans = build(n_channels=8)
    low = lt.lower_schedule(chans, 0.0, stop, schedules.FS)
    low_py = python_lowering(lt.lower_schedule, chans, 0.0, stop,
                             schedules.FS)
    rec = chip_smoke.descriptor_agreement(low, low_py)
    assert rec['ok'], rec


def test_descriptor_agreement_catches_a_changed_descriptor():
    chans = schedules.build_schedule(n_channels=2)
    low = lt.lower_schedule(chans, 0.0, 1e-3, schedules.FS)
    other = lt.lower_schedule(chans, 0.0, 1e-3, schedules.FS)
    assert chip_smoke.descriptor_agreement(low, other)['ok']
    other.args = other.args.copy()
    other.args[0, 0, 0, 0, 0, 1] += 1e-6
    assert not chip_smoke.descriptor_agreement(low, other)['ok']
    other = lt.lower_schedule(chans, 0.0, 1e-3, schedules.FS)
    other.q32 = other.q32.copy()
    other.q32[0, 0, 0, 0, 0, 0] += 2
    assert not chip_smoke.descriptor_agreement(low, other)['ok']


# engine='native' ------------------------------------------------------------

def engine_cases(w):
    I, Q = w.mixing(0.5 * w.cosPulse(20e-9) >> 5e-8, freq=-20e6,
                    DRAGScaling=1e-10)
    return [I, Q, w.gaussian(3e-8) * w.cos(2 * np.pi * 250e6, 0.3) >> 1e-7,
            w.square(4e-8, edge=1e-8) >> 1.2e-7]


@pytest.mark.parametrize('kw', [{}, {'out_dtype': np.float32},
                                {'out_dtype': np.int16},
                                {'out_dtype': np.float16},
                                {'part': 'imag'}, {'precision': 'double'},
                                {'bucket_samples': 256}],
                         ids=['f64', 'f32', 'int16', 'f16', 'imag', 'double',
                              'bucketed'])
def test_engine_native_matches_jax_engine(kw):
    """synthesize(..., engine='native') on the port's waveforms is JAX's
    engine='native' on the same waveforms, bit for bit and in its dtype (an
    explicit f32 is every engine's default in JAX, so the host engine keeps
    float64), and the oracle within the JAX suite's bound."""
    got = wt.synthesize(engine_cases(wt), 0.0, 2.56e-7, 2e9,
                        engine='native', **kw)
    ref = wj.synthesize(engine_cases(wj), 0.0, 2.56e-7, 2e9,
                        engine='native', **kw)
    assert isinstance(got, np.ndarray) and got.dtype == ref.dtype
    np.testing.assert_array_equal(got, ref)
    part = kw.get('part', 'real')
    ora = wt.synthesize(engine_cases(wt), 0.0, 2.56e-7, 2e9, engine='numpy',
                        part=part)
    if 'out_dtype' in kw:
        np.testing.assert_array_equal(
            got, _quantize_host(wt.synthesize(
                engine_cases(wt), 0.0, 2.56e-7, 2e9, engine='native'),
                kw['out_dtype'], 32767.0))
        return
    peak = np.maximum(np.abs(ora).max(axis=1), 1e-30)
    assert (np.abs(got - ora).max(axis=1) / peak).max() < 2e-7


def test_engine_native_lowers_once_through_the_walker():
    native.reset_lower_counts()
    wt.synthesize(engine_cases(wt), 0.0, 2.56e-7, 2e9, engine='native')
    assert native.lower_counts() == {'walker': 4, 'python': 0}


# the build -------------------------------------------------------------------

def test_builds_into_the_build_directory(tmp_path, monkeypatch):
    """Both libraries build with g++ into BUILD_DIR, named by a hash, and
    load from there: never from the JAX package's directory, and no
    temporary file is left behind."""
    for name in ('_lib', '_lib_error', '_lower_mod', '_lower_error'):
        monkeypatch.setattr(native, name, None)
    monkeypatch.setattr(native, 'BUILD_DIR', tmp_path / 'build')
    assert native.available() and native.lower_available()
    paths = native.library_paths()
    assert all(p.parent == tmp_path / 'build' and p.exists()
               for p in paths.values())
    assert sorted(p.name for p in (tmp_path / 'build').iterdir()) == sorted(
        p.name for p in paths.values())
    assert native._lower_mod.__file__ == str(paths['lowerext'])
    assert native._lower_mod.__name__ == 'waveforms_tpu_torch.native._lowerext'
    chans = engine_cases(wt)
    np.testing.assert_array_equal(
        wt.synthesize(chans, 0.0, 2.56e-7, 2e9, engine='native'),
        wj.synthesize(engine_cases(wj), 0.0, 2.56e-7, 2e9, engine='native'))


def test_failed_build_raises(tmp_path, monkeypatch):
    """With g++ unreachable (off PATH, and a compiler name that does not
    exist) and nothing built yet, the first lowering raises RuntimeError
    naming the build -- the port has no Python fallback for a missing
    toolchain (the JAX package degrades instead) -- and so do the native
    engine and every later call."""
    for name in ('_lib', '_lib_error', '_lower_mod', '_lower_error'):
        monkeypatch.setattr(native, name, None)
    monkeypatch.setattr(native, 'BUILD_DIR', tmp_path / 'build')
    monkeypatch.setattr(native, 'CXX', 'g++-not-installed')
    monkeypatch.setenv('PATH', str(tmp_path))
    chans = [wt.gaussian(1e-6) >> 1e-6]
    with pytest.raises(RuntimeError, match='building the lowering walker'):
        lt.lower_schedule(chans, 0, 2e-6, 1e9)
    with pytest.raises(RuntimeError, match='not found on PATH'):
        wt.synthesize(chans, 0, 2e-6, 1e9, device='cpu')
    with pytest.raises(RuntimeError, match='not found on PATH'):
        wt.synthesize(chans, 0, 2e-6, 1e9, engine='native')
    low = python_lowering(lt.lower_schedule, chans, 0, 2e-6, 1e9)
    with pytest.raises(RuntimeError, match='building the native engine'):
        native.synthesize_native(low)
    assert not native.available() and not native.lower_available()
    assert 'not found on PATH' in native.build_error()
    assert not (tmp_path / 'build').exists()
    # the paths that never reach the walker still run
    out = wt.synthesize(chans, 0, 2e-6, 1e9, engine='numpy')
    assert out.shape == (1, 2000)


def test_loading_keeps_float64_subnormals():
    """Loading both libraries leaves FTZ/DAZ off in the process: wavecore
    is compiled with -ffast-math but linked without it."""
    code = ("import numpy as np, torch\n"
            "from waveforms_tpu_torch import native\n"
            "native._load(); native._load_lower()\n"
            "x = np.float64(5e-324)\n"
            "assert x * 1.0 == x and x * 1.0 > 0, 'numpy flushed'\n"
            "t = torch.tensor([5e-324], dtype=torch.float64)\n"
            "assert (t * 1.0).item() > 0, 'torch flushed'\n"
            "print('subnormals-ok')\n")
    r = subprocess.run([sys.executable, '-c', code], cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr[-2000:]
    assert 'subnormals-ok' in r.stdout
    assert torch.tensor([5e-324], dtype=torch.float64).item() > 0
