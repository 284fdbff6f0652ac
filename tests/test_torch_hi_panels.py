"""The double tier's panel path, its route and the entry point.

The port's ``synthesize_hi_panels`` on CPU tensors (the plain float64
version of ``csrc/synth_panel_hi.cu``, ``ops.reference_hi.panel_walk_hi``)
against the JAX ``synthesize_hi_panels`` in interpret mode; the port's hi
route against the function the JAX ``synthesize_hi_routed`` calls; and
``synthesize(..., precision='double')`` on ``device='cpu'``.  Tolerances as
in test_torch_hi.
"""

from functools import partial

import numpy as np
import pytest
import torch

import waveforms_tpu as wj
import waveforms_tpu.ops.hi_synth as hj
import waveforms_tpu.ops.lowering as lj
import waveforms_tpu_torch as wt
from waveforms_tpu_torch import kernels
from waveforms_tpu_torch.convert import lowered_from_jax, waveform_from_jax
from waveforms_tpu_torch.ops.hi_synth import (HiSchedule, classify_hi_route,
                                              synthesize_hi,
                                              synthesize_hi_panels,
                                              synthesize_hi_routed)
from waveforms_tpu_torch.ops.sparse_synth import build_panel_plan
from test_torch_engine import bench_case
from test_torch_hi import TOL, TOL_JAX, hi_cases
from test_torch_panel import sparse_pulses
from test_torch_synth import oracle, rel

FS = 2e9
SPAN = 8.192e-6


def hi_sparse(seed=3, n=3):
    """tests/test_hi_synth.py's sparse hi schedule: 30 ns gaussian-windowed
    100 MHz carriers, four per channel."""
    rng = np.random.default_rng(seed)
    chans = []
    for c in range(n):
        wv = wj.zero()
        for _ in range(4):
            wv = wv + ((wj.gaussian(3e-8) >> float(rng.uniform(0, 7e-6)))
                       * wj.cos(2 * np.pi * (1e8 + 1e6 * c), 0.3))
        chans.append(wv)
    return chans, 0.0, SPAN


PANEL_CASES = {
    'hi_sparse': hi_sparse,
    'sparse_pulses': lambda: sparse_pulses()[:3],
    'drag_sin_x': lambda: (hi_cases(wj)['drag_sin_x'][:3]),
}


@pytest.mark.parametrize('case', list(PANEL_CASES))
def test_hi_panels_match_jax_and_oracle(case):
    chans, start, stop = PANEL_CASES[case]()
    low = lj.lower_schedule(chans, start, stop, FS, keep_f64=True)
    assert low.shape[1] == 1
    ref = np.asarray(hj.synthesize_hi_panels(low, interpret=True))
    low_t = lowered_from_jax(low)
    plan = build_panel_plan(low_t)
    got = synthesize_hi_panels(HiSchedule(low_t, 'cpu'), plan=plan)
    assert got.dtype == torch.float64 and tuple(got.shape) == ref.shape
    want = oracle(chans, start, stop, FS)
    tol = 2e-9 if case == 'drag_sin_x' else TOL
    assert rel(got.numpy(), want) <= tol
    assert rel(ref, want) <= tol
    assert rel(got.numpy(), ref) <= TOL_JAX
    # panel and dense evaluate each sample with the same formulas
    assert rel(got.numpy(),
               synthesize_hi(low_t, device='cpu').numpy()) <= 1e-14
    if case == 'hi_sparse':
        assert plan.n_live < plan.n_panels * (plan.P // plan.Rs) * len(chans)


def test_hi_panels_split_planes_and_silent_zeros():
    chans, start, stop = hi_sparse()
    low = lowered_from_jax(lj.lower_schedule(chans, start, stop, FS,
                                             keep_f64=True))
    plan = build_panel_plan(low)
    dev = HiSchedule(low, 'cpu')
    out = synthesize_hi_panels(dev, plan=plan)
    hi, lo = synthesize_hi_panels(dev, plan=plan, combine=False)
    assert torch.equal(hi, out.float())
    assert ((hi.double() + lo.double() - out).abs().max()
            <= 1e-14 * out.abs().max())
    tile = plan.Rs * 128
    live = torch.zeros(out.shape, dtype=torch.bool)
    slot = np.searchsorted(plan.start, np.arange(plan.n_live), 'right') - 1
    for c, o in zip(slot // plan.n_panels, plan.work_o[:plan.n_live]):
        live[c, o * tile:(o + 1) * tile] = True
    assert not out[~live].any() and not lo[~live].any()


def test_hi_panels_refuse_buckets():
    chans, start, stop, bs, _ = hi_cases(wt)['bucketed']
    low = wt.ops.lowering.lower_schedule(chans, start, stop, FS,
                                         bucket_samples=bs, keep_f64=True)
    with pytest.raises(wt.UnsupportedFactor, match='single-bucket'):
        synthesize_hi_panels(low, device='cpu')


def _route_cases():
    """name -> (JAX channels, start, stop, lowering kwargs, the JAX hi
    route), spanning occupancy, bucket count and window length."""
    dense_short = [wj.gaussian(6e-6) * wj.cos(2 * np.pi * 3e7) >> 4e-6
                   for _ in range(2)]
    long_sparse = [(wj.gaussian(3e-8) >> 1e-5) * wj.cos(2 * np.pi * 1e8)
                   for _ in range(2)]
    half = [wj.square(60e-6) >> 30e-6 for _ in range(2)]
    return {
        'flagship': (partial(bench_case, 'flagship'), {}, 'panel'),
        'mid': (partial(bench_case, 'mid'), {}, 'panel'),
        'dense': (partial(bench_case, 'dense'), {}, 'dense'),
        'hi_sparse': (lambda: hi_sparse() + (FS,), {}, 'panel'),
        'short_dense_small': (lambda: (dense_short, 0.0, SPAN, FS), {},
                              'panel'),
        'long_low_occupancy': (lambda: (long_sparse, 0.0, 262.144e-6, FS),
                               {}, 'panel'),
        'long_half_occupancy': (lambda: (half, 0.0, 131.072e-6, FS), {},
                                'dense'),
        'bucketed': (lambda: hi_cases(wj)['bucketed'][:3] + (FS,),
                     {'bucket_samples': 4096}, 'dense'),
    }


class _Picked(Exception):
    pass


@pytest.mark.parametrize('case', list(_route_cases()))
def test_hi_route_parity_with_jax(case, monkeypatch):
    """classify_hi_route picks the kernel that the JAX synthesize_hi_routed
    calls on the same keep_f64 lowering (caught by spies, which stop it
    before any kernel runs).  The JAX choice is asserted first."""
    build, low_kw, kind = _route_cases()[case]
    chans, start, stop, fs = build()
    low = lj.lower_schedule(chans, start, stop, fs, keep_f64=True, **low_kw)

    def spy(name, *a, **k):
        raise _Picked(name)

    monkeypatch.setattr(hj, 'synthesize_hi', partial(spy, 'dense'))
    monkeypatch.setattr(hj, 'synthesize_hi_panels', partial(spy, 'panel'))
    with pytest.raises(_Picked) as picked:
        hj.synthesize_hi_routed(low)
    assert picked.value.args[0] == kind
    kind_t, plan = classify_hi_route(lowered_from_jax(low))
    assert kind_t == kind
    assert (plan is None) == (kind_t == 'dense')


def test_hi_routed_picks_the_routes_kernel():
    chans, start, stop = hi_sparse()
    low = lowered_from_jax(lj.lower_schedule(chans, start, stop, FS,
                                             keep_f64=True))
    routed = synthesize_hi_routed(low, device='cpu')
    assert torch.equal(routed, synthesize_hi_panels(low, device='cpu'))
    hi, lo = synthesize_hi_routed(low, combine=False, device='cpu')
    assert torch.equal(hi, routed.float())


def _small():
    chans = [wt.gaussian(4e-7) * wt.cos(2 * np.pi * 3e7, 0.2) >> 2e-6,
             wt.square(2e-6, edge=1e-7, type='erf') >> 4e-6]
    return chans, 0.0, SPAN


@pytest.mark.parametrize('engine', ['auto', 'cuda', 'cuda-dense'])
def test_engine_double_matches_oracle(engine):
    chans, start, stop = _small()
    kernels.reset_launch_counts()
    got = wt.synthesize(chans, start, stop, FS, engine=engine,
                        precision='double', device='cpu')
    assert sum(kernels.launch_counts().values()) == 0     # plain versions
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float64
    want = wt.synthesize(chans, start, stop, FS, engine='numpy')
    assert rel(got.numpy(), want) <= TOL


@pytest.mark.parametrize('engine', ['cuda-panel', 'cuda-sparse', 'cuda-stack'])
def test_engine_double_refuses_forced_engines(engine):
    chans, start, stop = _small()
    with pytest.raises(ValueError, match='unsupported on engine'):
        wt.synthesize(chans, start, stop, FS, engine=engine,
                      precision='double', device='cpu')


def test_engine_double_refuses_narrowing():
    chans, start, stop = _small()
    with pytest.raises(ValueError, match='narrowing'):
        wt.synthesize(chans, start, stop, FS, precision='double',
                      out_dtype=torch.int16, device='cpu')


def test_engine_double_complex_part():
    """A complex part fails the double tier's gate: under 'auto' the
    numpy oracle answers, as the JAX engine's host f64 engines do; under
    'cuda' and 'cuda-dense' the UnsupportedFactor propagates."""
    chans = [(0.3 + 0.4j) * wt.gaussian(4e-7) * wt.cos(2 * np.pi * 3e7)
             >> 2e-6]
    got = wt.synthesize(chans, 0.0, SPAN, FS, part='complex',
                        precision='double', device='cpu')
    want = wt.synthesize(chans, 0.0, SPAN, FS, part='complex',
                         engine='numpy')
    np.testing.assert_array_equal(got.numpy(), want)
    for engine in ('cuda', 'cuda-dense'):
        with pytest.raises(wt.UnsupportedFactor):
            wt.synthesize(chans, 0.0, SPAN, FS, part='complex',
                          engine=engine, precision='double', device='cpu')


def test_engine_double_matches_jax_engine():
    """The entry point against the JAX engine's double tier on the same
    waveforms (engine='pallas', interpret mode on the CPU)."""
    chans_j, start, stop = hi_sparse(seed=4, n=2)
    got = wt.synthesize([waveform_from_jax(w) for w in chans_j], start, stop,
                        FS, precision='double', device='cpu')
    ref = np.asarray(wj.synthesize(chans_j, start, stop, FS, engine='pallas',
                                   precision='double'))
    assert rel(got.numpy(), ref) <= TOL_JAX


def test_engine_double_cuda_without_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    chans, start, stop = _small()
    before = kernels.launch_counts()
    with pytest.raises(RuntimeError, match='no CUDA device'):
        wt.synthesize(chans, start, stop, FS, precision='double',
                      device='cuda')
    assert kernels.launch_counts() == before
