"""The double tier's dense path against the JAX double tier.

The same ``keep_f64`` lowering goes through the JAX ``synthesize_hi``
(double-f32, in interpret mode as tests/test_hi_synth.py runs it on the
CPU) and through the port's ``synthesize_hi`` on CPU tensors, which is the
plain float64 version of ``csrc/synth_dense_hi.cu``
(``ops.reference_hi.dense_walk_hi``).

Tolerances, of each channel's peak: 2e-9 between the two (the sum of both
sides' 1e-9 contracts), and each side against the float64 oracle at the
JAX suite's own limit for the case (1e-9; 2e-9 for the long carrier and
chirp and multi-tone DRAG; 2e-7 at f32 clip rails).
"""

import numpy as np
import pytest
import torch

import bench
import waveforms_tpu as wj
import waveforms_tpu.ops.lowering as lj
from waveforms_tpu.ops.hi_synth import HiSchedule as HiScheduleJ
from waveforms_tpu.ops.hi_synth import synthesize_hi as synthesize_hi_j
import waveforms_tpu_torch as wt
import waveforms_tpu_torch.ops.lowering as lt
from waveforms_tpu_torch import kernels, schedules
from waveforms_tpu_torch.convert import lowered_from_jax
from waveforms_tpu_torch.ops.hi_synth import (HI_OPS, HiSchedule,
                                              synthesize_hi)
from test_torch_lowering import (assert_lowered_equal,  # noqa: F401
                                 jax_python_lowering, torch_python_lowering)
from test_torch_synth import oracle, rel

FS = 2e9
SPAN = 8.192e-6
TOL = 1e-9
TOL_JAX = 2e-9


def hi_cases(w):
    """name -> (channels, start, stop, bucket_samples, oracle tolerance),
    built with package ``w`` (tests/test_hi_synth.py's schedules, grouped so
    that the JAX side compiles few kernels; drag_sin(x) on a 90-sample
    window, because its interpret compile is slow)."""
    rng = np.random.default_rng(0)
    pulses = []
    for _ in range(2):
        wv = w.zero()
        for _ in range(6):
            wv = wv + ((w.gaussian(4e-7) >> float(rng.uniform(0, 7e-6)))
                       * w.cos(2 * np.pi * rng.uniform(1e6, 5e7),
                               rng.uniform(0, 6)))
        pulses.append(wv)
    clipped = (2.0 * w.gaussian(2e-6)) >> 4e-6
    clipped.min, clipped.max = -1.0, 1.0
    rng = np.random.default_rng(5)
    stack = w.WaveVStack([(0.3 * w.cosPulse(40e-9) >> o)
                          for o in rng.uniform(0, 7e-6, 60)])
    bf = (151e6, -83e6, 217e6)
    chirps = (schedules.build_dense_schedule if w is wt
              else bench.build_dense_schedule)
    return {
        'gaussian_cos': (pulses, 0.0, SPAN, 'auto', TOL),
        'exp_sinc_linear': ([(w.exp(-2e6) >> 1e-6) * w.square(3e-6, edge=0)
                             >> 2e-6, w.sinc(8e6) >> 4e-6,
                             w.poly([0.5, 1e5, -1e11]) * w.square(3e-6)
                             >> 4e-6],
                            0.0, SPAN, 'auto', TOL),
        'erf_flux': ([w.square(2e-6, edge=1e-7, type='erf') >> 3e-6,
                      (w.step(2e-7) >> 1e-6) * w.cos(2 * np.pi * 1.5e7, 0.4),
                      w.step(1e-8) >> 4e-6],
                     0.0, SPAN, 'auto', TOL),
        'drag': ([w.drag(freq=50e6, width=100e-9, plateau=40e-9, delta=1e6,
                         block_freq=None, phase=0.3) >> 2e-6],
                 0.0, SPAN, 'auto', TOL),
        'cosh_sinh_powers': ([w.coshPulse(8e-7, plateau=4e-7) >> 3e-6,
                              (w.sinh(2e6) * w.gaussian(1e-6)) >> 3e-6,
                              (w.gaussian(1e-6) ** 3) >> 3e-6,
                              (w.square(2e-6) * w.cosh(1e6) ** -1) >> 3e-6],
                             0.0, SPAN, 'auto', TOL),
        'poly_gauss_mollifier': ([w.gaussian(6e-7, d=d) >> 3e-6
                                  for d in (1, 2, 3)]
                                 + [w.mollifier(2e-6, plateau=5e-7) >> 3e-6]
                                 + [w.mollifier(2e-6, d=d) >> 3e-6
                                    for d in (1, 2, 3)],
                                 0.0, SPAN, 'auto', TOL),
        'linear_chirp': (chirps(n_channels=2, duration=3.2768e-5), 0.0,
                         3.2768e-5, 'auto', TOL),
        'exotic_chirps': ([w.chirp(1e6, 8e7, SPAN, type=kind)
                           * w.gaussian(4e-6) >> 4e-6
                           for kind in ('exponential', 'hyperbolic')],
                          0.0, SPAN, 'auto', TOL),
        'clip_rails': ([clipped], 0.0, SPAN, 'auto', 2e-7),
        'bucketed': ([stack, stack >> 1e-7], 0.0, SPAN, 4096, TOL),
        'drag_sin_x': ([w.drag_sin(0.2e9, 22.3e-9, plateau=6.1e-9, delta=3e6,
                                   block_freq=bf, phase=0.1),
                        w.drag_sinx(0.2e9, 22.3e-9, plateau=6.1e-9,
                                    delta=3e6, block_freq=bf, phase=0.1,
                                    tab=0.5)],
                       -5e-9, 40e-9, 'auto', 2e-9),
    }


def live_ops(low):
    live = np.arange(low.shape[4]) < low.nfac[..., None]
    return {int(o) for o in np.unique(low.op[live])}


def port_hi(low_j, **kw):
    return synthesize_hi(HiSchedule(lowered_from_jax(low_j), 'cpu'), **kw)


@pytest.mark.parametrize('case', list(hi_cases(wj)))
def test_hi_dense_matches_jax_and_oracle(case):
    chans, start, stop, bs, tol = hi_cases(wj)[case]
    low = lj.lower_schedule(chans, start, stop, FS, bucket_samples=bs,
                            keep_f64=True)
    ref = np.asarray(synthesize_hi_j(low, interpret=True))
    got = port_hi(low)
    assert got.dtype == torch.float64 and tuple(got.shape) == ref.shape
    want = np.asarray(wj.synthesize(chans, start, stop, FS, engine='numpy'))
    assert rel(got.numpy(), want) <= tol
    assert rel(ref, want) <= tol
    assert rel(got.numpy(), ref) <= max(TOL_JAX, tol)
    if case == 'bucketed':
        assert low.shape[1] > 1


def opcode_schedules():
    """opcode -> (channels built with the port, start, stop): one schedule
    per HI_OPS opcode, the mollifier at d = 0..3."""
    bf = (151e6, -83e6, 217e6)
    return {
        'linear': ([wt.poly([0.5, 1e5, -1e11]) * wt.square(3e-6),
                    wt.square(1e-6, edge=0.2e-6, type='linear')], -2e-6, 2e-6),
        'gaussian': ([wt.gaussian(1e-6)], -2e-6, 2e-6),
        'cos': ([wt.cos(2 * np.pi * 137.137e6, 0.3)], 0.0, SPAN),
        'exp': ([wt.exp(1e5) * wt.square(2e-6)], -2e-6, 2e-6),
        'sinc': ([wt.sinc(20e6)], -2e-6, 2e-6),
        'drag': ([wt.drag(100e6, 20e-9, plateau=10e-9, delta=2e6,
                          block_freq=250e6, phase=0.4, t0=3e-9) >> 0.1e-6],
                 -0.1e-6, 0.4e-6),
        'linearchirp': ([wt.chirp(1e6, 50e6, 1e-5, 0.3, 'linear')], 0.0,
                        SPAN),
        'erf': ([wt.square(1e-6, edge=0.2e-6)], -2e-6, 2e-6),
        'cosh': ([wt.cosh(1e6) * wt.square(2e-6)], -2e-6, 2e-6),
        'sinh': ([wt.sinh(1e6) * wt.square(2e-6)], -2e-6, 2e-6),
        'poly_gauss': ([wt.gaussian(1e-6, d=2)], -2e-6, 2e-6),
        'mollifier': ([wt.mollifier(1e-6, d=d) for d in (0, 1, 2, 3)],
                      -2e-6, 2e-6),
        'drag_sin': ([wt.drag_sin(0.2e9, 22.3e-9, plateau=6.1e-9, delta=3e6,
                                  block_freq=bf, phase=0.1)], -5e-9, 40e-9),
        'drag_sinx': ([wt.drag_sinx(0.2e9, 22.3e-9, plateau=6.1e-9,
                                    delta=3e6, block_freq=bf, phase=0.1,
                                    tab=0.5)], -5e-9, 40e-9),
    }


def test_opcode_schedules_cover_hi_ops():
    ops = set()
    for chans, start, stop in opcode_schedules().values():
        ops |= live_ops(lt.lower_schedule(chans, start, stop, FS,
                                          keep_f64=True))
    assert ops == set(HI_OPS)


@pytest.mark.parametrize('name', list(opcode_schedules()))
def test_every_opcode_against_the_oracle(name):
    chans, start, stop = opcode_schedules()[name]
    low = lt.lower_schedule(chans, start, stop, FS, keep_f64=True)
    op = getattr(lt, 'OP_' + name.upper())
    assert op in live_ops(low)
    got = synthesize_hi(low, device='cpu')
    want = wt.synthesize(chans, start, stop, FS, engine='numpy')
    tol = 2e-9 if name.startswith('drag_sin') else TOL
    assert torch.isfinite(got).all()
    assert rel(got.numpy(), want) <= tol


@pytest.mark.parametrize('which', ['carrier_2M', 'chirp_1M'])
def test_long_phase_accumulation(which):
    """2M samples of a 123.456789 MHz carrier and a 1M-sample linear chirp
    at 2e-9 (tests/test_hi_synth.py's limits): the int32 turns and the f64
    residual over long spans."""
    if which == 'carrier_2M':
        chans, stop = [wt.cos(2 * np.pi * 123.456789e6, 0.7)], 1.048576e-3
    else:
        stop = 5.24288e-4
        chans = schedules.build_dense_schedule(n_channels=1, duration=stop)
    got = synthesize_hi(lt.lower_schedule(chans, 0.0, stop, FS,
                                          keep_f64=True), device='cpu')
    assert rel(got.numpy(), oracle(chans, 0.0, stop, FS)) <= 2e-9


@pytest.mark.parametrize('case', ['gaussian_cos', 'keep_f64_carrier',
                                  'multitone_drag', 'bucketed'])
def test_keep_f64_lowering_matches_jax(case, jax_python_lowering,
                                      torch_python_lowering):
    """The port's keep_f64 lowering is array-equal to the JAX package's,
    the residual planes args_lo and amp_lo included."""
    if case == 'keep_f64_carrier':
        cj = [wj.gaussian(4e-7) * wj.cos(2 * np.pi * 3e7, 0.1) >> 2e-6]
        ct = [wt.gaussian(4e-7) * wt.cos(2 * np.pi * 3e7, 0.1) >> 2e-6]
        start, stop, bs = 0.0, SPAN, 'auto'
    elif case == 'multitone_drag':
        cj, start, stop, bs = hi_cases(wj)['drag_sin_x'][:4]
        ct = hi_cases(wt)['drag_sin_x'][0]
    else:
        cj, start, stop, bs = hi_cases(wj)[case][:4]
        ct = hi_cases(wt)[case][0]
    low_j = lj.lower_schedule(cj, start, stop, FS, bucket_samples=bs,
                              keep_f64=True)
    low_t = lt.lower_schedule(ct, start, stop, FS, bucket_samples=bs,
                              keep_f64=True)
    assert_lowered_equal(low_t, low_j)
    for name in ('args_lo', 'amp_lo'):
        assert getattr(low_t, name) is not None
        np.testing.assert_array_equal(getattr(low_t, name),
                                      getattr(low_j, name), err_msg=name)


def test_lowered_from_jax_gives_the_ports_own_output(
        jax_python_lowering, torch_python_lowering):
    """convert.lowered_from_jax carries a JAX keep_f64 lowering over whole:
    the plain version's output from it is bit-equal to the output from the
    port's own lowering of the same waveforms."""
    cj, start, stop, bs = hi_cases(wj)['poly_gauss_mollifier'][:4]
    ct = hi_cases(wt)['poly_gauss_mollifier'][0]
    low_j = lj.lower_schedule(cj, start, stop, FS, keep_f64=True)
    carried = lowered_from_jax(low_j)
    np.testing.assert_array_equal(carried.args_lo, low_j.args_lo)
    np.testing.assert_array_equal(carried.amp_lo, low_j.amp_lo)
    own = lt.lower_schedule(ct, start, stop, FS, keep_f64=True)
    assert torch.equal(synthesize_hi(carried, device='cpu'),
                       synthesize_hi(own, device='cpu'))


@pytest.mark.parametrize('case', ['gaussian_cos', 'bucketed'])
def test_split_planes(case):
    """combine=False: hi == f32(out) and hi + lo within 1e-14 of the peak of
    the f64 output (the split loses at most 2^-48 of each sample)."""
    chans, start, stop, bs, _ = hi_cases(wt)[case]
    dev = HiSchedule(lt.lower_schedule(chans, start, stop, FS,
                                       bucket_samples=bs, keep_f64=True),
                     'cpu')
    out = synthesize_hi(dev)
    hi, lo = synthesize_hi(dev, combine=False)
    assert hi.dtype == lo.dtype == torch.float32
    assert torch.equal(hi, out.float())
    err = (hi.double() + lo.double() - out).abs().amax(dim=1)
    assert (err <= 1e-14 * out.abs().amax(dim=1)).all()


@pytest.mark.parametrize('side', ['jax', 'port'])
def test_hischedule_refusals(side):
    """The JAX HiSchedule's gates, with its exception classes, on both
    sides: no keep_f64 lowering -> ValueError; a complex part or a live
    opcode outside HI_OPS -> UnsupportedFactor.  The port also takes that
    opcode in a dead slot (its gate reads live slots only)."""
    w, lower, hisched, unsupported = {
        'jax': (wj, lj.lower_schedule, HiScheduleJ, lj.UnsupportedFactor),
        'port': (wt, lt.lower_schedule, lambda low: HiSchedule(low, 'cpu'),
                 lt.UnsupportedFactor),
    }[side]
    chans = [w.gaussian(1e-6)]
    with pytest.raises(ValueError, match='keep_f64'):
        hisched(lower(chans, -1e-6, 1e-6, FS))
    with pytest.raises(unsupported):
        hisched(lower([(1 + 1j) * w.gaussian(1e-6)], -1e-6, 1e-6, FS,
                      part='complex', keep_f64=True))
    low = lower(chans, -1e-6, 1e-6, FS, keep_f64=True, pad_to=(1, 1, 2))
    if side == 'port':
        low.op[0, 0, 0, 0, 1] = lt.OP_EXPCHIRP        # dead slot: accepted
        hisched(low)
    low.op[0, 0, 0, 0, 0] = lt.OP_EXPCHIRP            # live slot: refused
    with pytest.raises(unsupported, match=str(lt.OP_EXPCHIRP)):
        hisched(low)


def test_cpu_tensors_take_the_plain_version():
    low = lt.lower_schedule([wt.gaussian(1e-6)], -1e-6, 1e-6, FS,
                            keep_f64=True)
    before = kernels.launch_counts()
    synthesize_hi(low, device='cpu')
    assert kernels.launch_counts() == before
