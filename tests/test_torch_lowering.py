"""The port's host layers against the JAX package's: lowering and plans.

``waveforms_tpu_torch`` carries its own copy of the IR, the models and the
lowering (it must import without JAX).  The same waveforms, built in each
package, lower to descriptor arrays that are equal element for element;
so do waveforms carried across by the wire format, and the live-subtile
and panel plans built from them.

Both sides lower on their Python paths here (each package's native walker
is switched off for the comparison, by the fixtures ``jax_python_lowering``
and ``torch_python_lowering``); ``tests/test_torch_native.py`` holds the
port's walker against the JAX package's walker and against the Python path.
"""

import dataclasses

import numpy as np
import pytest

import bench
import waveforms_tpu as wj
import waveforms_tpu.ops.lowering as lj
import waveforms_tpu.ops.sparse_synth as sj
import waveforms_tpu_torch as wt
import waveforms_tpu_torch.ops.lowering as lt
import waveforms_tpu_torch.ops.sparse_synth as st
from waveforms_tpu_torch import schedules
from waveforms_tpu_torch.convert import lowered_from_jax, waveform_from_jax

ARRAYS = ('seg_lo', 'seg_hi', 'nterm', 'amp', 'nfac', 'op', 'power',
          'shift_hi', 'q32', 'args', 'clip_min', 'clip_max', 'ext')
SCALARS = ('n_samples', 'start', 'sample_rate', 'bucket_samples')


def opcode_cases(w):
    """(channels, start, stop, fs, bucket_samples) per case, built from the
    package ``w`` -- every opcode the lowering emits (the waveforms of
    tests/test_pallas_synth.py)."""
    bf = (151e6, -83e6, 217e6)
    I, Q = w.mixing(0.5 * w.cosPulse(20e-9), freq=-20e6, DRAGScaling=1e-10)
    clipped = 2 * w.gaussian(1e-6)
    clipped.max, clipped.min = 1.0, 0.2
    rng = np.random.default_rng(5)
    stack = w.WaveVStack([(0.3 * w.cosPulse(40e-9) >> o)
                          for o in rng.uniform(0, 7e-6, 60)])
    return {
        'basic_shapes': ([w.gaussian(1e-6), w.cosPulse(1e-6),
                          w.square(1e-6, edge=0.2e-6),
                          w.square(1e-6, edge=0.2e-6, type='cos'),
                          w.square(1e-6, edge=0.2e-6, type='linear'),
                          w.sinc(20e6), w.cosh(1e6) * w.square(2e-6),
                          w.sinh(1e6) * w.square(2e-6),
                          w.mollifier(1e-6, d=2),
                          w.poly([0.5, 1e5, -1e11]) * w.square(3e-6)],
                         -2e-6, 2e-6, 1e9, 'auto'),
        'carriers': ([w.cos(2 * np.pi * 137.137e6, 0.3),
                      w.gaussian(2.5e-3) * w.cos(2 * np.pi * 250e6)],
                     0.0, 8e-6, 2e9, 'auto'),
        'drag_mixing': ([I, Q, w.drag(100e6, 20e-9, plateau=10e-9,
                                      delta=2e6, block_freq=250e6,
                                      phase=0.4, t0=3e-9) >> 0.1e-6],
                        -0.1e-6, 0.4e-6, 2e9, 'auto'),
        'chirps': ([w.chirp(1e6, 50e6, 1e-5, 0.3, 'linear'),
                    w.chirp(1e6, 50e6, 1e-5, 0.3, 'exponential'),
                    w.chirp(1e6, 50e6, 1e-5, 0.3, 'hyperbolic')],
                   0.0, 8e-6, 2e9, 'auto'),
        'hermite_clip_exp_pow': ([w.gaussian(1e-6, d=2),
                                  w.gaussian(1e-6, plateau=0.5e-6, d=1),
                                  clipped, w.exp(1e5) * w.square(2e-6),
                                  (w.gaussian(50e-9) ** 6) >> 100e-9,
                                  w.square(1e-6) * w.cosh(1e6) ** -1],
                                 -2e-6, 2e-6, 1e9, 'auto'),
        'interp': ([w.samplingPoints(
            1e-7, 10e-6, np.sin(np.linspace(0, 3, 33)) + 0.1)],
            -1e-6, 12e-6, 1e9, 'auto'),
        'multitone_drag': ([w.drag_sin(0.2e9, 22.3e-9, plateau=6.1e-9,
                                       delta=3e6, block_freq=bf, phase=0.1),
                            w.drag_sinx(0.2e9, 22.3e-9, plateau=6.1e-9,
                                        delta=3e6, block_freq=bf, phase=0.1,
                                        tab=0.5)],
                           -5e-9, 40e-9, 2e9, 'auto'),
        'multi_bucket': ([stack, stack >> 1e-7], 0.0, 8.192e-6, 2e9, 4096),
    }


def bench_cases(w):
    """bench.py's three builders, cut to 4 channels, at full span."""
    return {
        'flagship': (schedules.build_schedule(n_channels=4) if w is wt
                     else bench.build_schedule(n_channels=4), 0.0, 1e-3),
        'mid': (schedules.build_mid_schedule(n_channels=4) if w is wt
                else bench.build_mid_schedule(n_channels=4), 0.0,
                524.288e-6),
        'dense': (schedules.build_dense_schedule(n_channels=4) if w is wt
                  else bench.build_dense_schedule(n_channels=4), 0.0, 1e-3),
    }


@pytest.fixture
def jax_python_lowering(monkeypatch):
    """Lower on the JAX package's Python path."""
    monkeypatch.setattr(lj, '_lower_schedule_native', lambda *a, **k: None)


@pytest.fixture
def torch_python_lowering(monkeypatch):
    """Lower on the port's Python path, the twin of jax_python_lowering."""
    monkeypatch.setattr(lt, '_lower_schedule_native', lambda *a, **k: None)


def assert_lowered_equal(a, b):
    assert a.shape == b.shape
    for name in ARRAYS:
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name),
                                      err_msg=name)
    for name in SCALARS:
        assert getattr(a, name) == getattr(b, name), name


@pytest.mark.parametrize('case', list(opcode_cases(wj)))
def test_lowering_matches_jax(case, jax_python_lowering,
                              torch_python_lowering):
    cj, start, stop, fs, bs = opcode_cases(wj)[case]
    ct = opcode_cases(wt)[case][0]
    low_j = lj.lower_schedule(cj, start, stop, fs, bucket_samples=bs)
    low_t = lt.lower_schedule(ct, start, stop, fs, bucket_samples=bs)
    assert_lowered_equal(low_t, low_j)
    if case == 'multi_bucket':
        assert low_t.n_buckets > 1


@pytest.mark.parametrize('stratum', ['flagship', 'mid', 'dense'])
def test_bench_schedules_lower_equal(stratum, jax_python_lowering,
                                     torch_python_lowering):
    cj, start, stop = bench_cases(wj)[stratum]
    ct = bench_cases(wt)[stratum][0]
    low_j = lj.lower_schedule(cj, start, stop, bench.FS)
    low_t = lt.lower_schedule(ct, start, stop, schedules.FS)
    assert_lowered_equal(low_t, low_j)


@pytest.mark.parametrize('case', ['basic_shapes', 'drag_mixing',
                                  'multitone_drag', 'multi_bucket'])
def test_wire_format_carries_waveforms(case, jax_python_lowering,
                                       torch_python_lowering):
    """A JAX waveform carried across by tolist/fromlist lowers to the same
    descriptors as the original."""
    cj, start, stop, fs, bs = opcode_cases(wj)[case]
    carried = [waveform_from_jax(w) for w in cj]
    assert all(type(w).__module__.startswith('waveforms_tpu_torch')
               for w in carried)
    low_j = lj.lower_schedule(cj, start, stop, fs, bucket_samples=bs)
    low_t = lt.lower_schedule(carried, start, stop, fs, bucket_samples=bs)
    assert_lowered_equal(low_t, low_j)
    t = np.arange(start, stop, 1 / fs)
    for a, b in zip(carried, cj):
        np.testing.assert_array_equal(a(t), b(t))


def test_lowered_from_jax_copies_every_field():
    cj, start, stop, fs, bs = opcode_cases(wj)['multitone_drag']
    low_j = lj.lower_schedule(cj, start, stop, fs)
    low_t = lowered_from_jax(low_j)
    assert isinstance(low_t, lt.LoweredSchedule)
    assert_lowered_equal(low_t, low_j)
    for f in dataclasses.fields(lt.LoweredSchedule):
        v = getattr(low_t, f.name)
        if isinstance(v, np.ndarray):
            assert v is not getattr(low_j, f.name)   # a copy, not a view


PLAN_FIELDS = ('work_c', 'work_b', 'work_t', 'work_o', 'work_s0', 'work_s1')
PANEL_FIELDS = ('start', 'work_t', 'work_o', 'work_s0', 'work_s1')


@pytest.mark.parametrize('case', ['flagship', 'mid', 'multi_bucket',
                                  'chirps'])
def test_plans_match_jax(case, jax_python_lowering,
                         torch_python_lowering):
    if case in ('flagship', 'mid'):
        cj, start, stop = bench_cases(wj)[case]
        ct = bench_cases(wt)[case][0]
        fs, bs = bench.FS, 'auto'
    else:
        cj, start, stop, fs, bs = opcode_cases(wj)[case]
        ct = opcode_cases(wt)[case][0]
    low_j = lj.lower_schedule(cj, start, stop, fs, bucket_samples=bs)
    low_t = lt.lower_schedule(ct, start, stop, fs, bucket_samples=bs)
    sp_j, sp_t = sj.build_sparse_plan(low_j), st.build_sparse_plan(low_t)
    for name in PLAN_FIELDS:
        np.testing.assert_array_equal(getattr(sp_t, name),
                                      getattr(sp_j, name), err_msg=name)
    assert (sp_t.n_live, sp_t.n_tiles, sp_t.window_samples) == (
        sp_j.n_live, sp_j.n_tiles, sp_j.window_samples)
    pp_j, pp_t = sj.build_panel_plan(low_j), st.build_panel_plan(low_t)
    for name in PANEL_FIELDS:
        np.testing.assert_array_equal(getattr(pp_t, name),
                                      getattr(pp_j, name), err_msg=name)
    assert (pp_t.P, pp_t.n_panels, pp_t.n_live) == (
        pp_j.P, pp_j.n_panels, pp_j.n_live)
