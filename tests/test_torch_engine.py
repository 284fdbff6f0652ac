"""The port's slice end to end: ``waveforms_tpu_torch.synthesize``.

On ``device='cpu'`` the entry point runs the kernels' plain versions; it is
held against ``waveforms_tpu.synthesize(engine='pallas')`` (interpret mode
on the CPU) and the float64 oracle.  Routing follows the JAX package's
rule (route parity on the same lowered schedules), the entry point takes
the JAX package's argument order, the package imports without JAX, and the
modes that the JAX package refuses, or that an engine does not support,
refuse loudly.
"""

import os
import subprocess
import sys
from functools import partial

import numpy as np
import pytest
import torch

import bench
import waveforms_tpu as wj
import waveforms_tpu_torch as wt
from waveforms_tpu.engine import classify_pallas_route
from waveforms_tpu.ops.lowering import lower_schedule as lower_j
from waveforms_tpu_torch import kernels, schedules
from waveforms_tpu_torch.convert import lowered_from_jax, waveform_from_jax
from waveforms_tpu_torch.engine import classify_route
from waveforms_tpu_torch.ops.lowering import lower_schedule as lower_t
from test_torch_lowering import (jax_python_lowering,  # noqa: F401
                                 opcode_cases, torch_python_lowering)
from test_torch_panel import sparse_pulses
from test_torch_synth import RTOL, TOL_JAX, oracle, rel

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, 'tools'))
import bench_suite  # noqa: E402  (tools/ is not a package)

E2E = {
    'sparse_pulses': sparse_pulses()[:4],
    'basic_shapes': opcode_cases(wj)['basic_shapes'][:4],
    'multi_bucket': opcode_cases(wj)['multi_bucket'][:4],
}


@pytest.mark.parametrize('case', list(E2E))
@pytest.mark.parametrize('engine', ['auto', 'cuda-dense', 'cuda-panel'])
def test_slice_matches_jax_engine_and_oracle(case, engine):
    chans, start, stop, fs = E2E[case]
    port = [waveform_from_jax(w) for w in chans]
    bs = 4096 if case == 'multi_bucket' else 'auto'
    got = wt.synthesize(port, start, stop, fs, engine=engine, device='cpu',
                        bucket_samples=bs)
    assert isinstance(got, torch.Tensor) and got.device.type == 'cpu'
    jax_engine = {'auto': 'pallas', 'cuda-dense': 'pallas-dense',
                  'cuda-panel': 'pallas-panel'}[engine]
    ref = np.asarray(wj.synthesize(chans, start, stop, fs, engine=jax_engine,
                                   bucket_samples=bs))
    assert rel(got.numpy(), ref) <= TOL_JAX
    assert rel(got.numpy(), oracle(chans, start, stop, fs)) <= RTOL


def test_slice_int16_matches_host_codes():
    chans, start, stop, fs = E2E['sparse_pulses']
    port = [waveform_from_jax(w) for w in chans]
    codes = wt.synthesize(port, start, stop, fs, device='cpu',
                          out_dtype=torch.int16, dac_scale=30000.0)
    assert codes.dtype == torch.int16
    host = wt.synthesize(port, start, stop, fs, engine='numpy',
                         out_dtype=np.int16, dac_scale=30000.0)
    jax_host = wj.synthesize(chans, start, stop, fs, engine='numpy',
                             out_dtype=np.int16, dac_scale=30000.0)
    np.testing.assert_array_equal(host, jax_host)
    assert np.abs(codes.numpy().astype(int) - host).max() <= 1


def test_numpy_engine_is_the_jax_oracle():
    chans, start, stop, fs, bs = opcode_cases(wj)['drag_mixing']
    port = [waveform_from_jax(w) for w in chans]
    np.testing.assert_array_equal(
        wt.synthesize(port, start, stop, fs, engine='numpy'),
        wj.synthesize(chans, start, stop, fs, engine='numpy'))


@pytest.mark.parametrize('stratum', ['flagship', 'mid', 'dense'])
def test_bench_routes_match_jax(stratum):
    """The three bench schedules at full size route as the JAX package
    routes them: flagship and mid to the panel kernel, dense to the dense
    grid."""
    builder_t, stop = schedules.STRATA[stratum]
    builder_j = {'flagship': bench.build_schedule,
                 'mid': bench.build_mid_schedule,
                 'dense': bench.build_dense_schedule}[stratum]
    kind_j, _ = classify_pallas_route(lower_j(builder_j(), 0.0, stop,
                                              bench.FS))
    kind_t, plan = classify_route(lower_t(builder_t(), 0.0, stop,
                                          schedules.FS))
    assert kind_t == kind_j == {'flagship': 'panel', 'mid': 'panel',
                                'dense': 'dense'}[stratum]
    assert (plan is not None) == (kind_t == 'panel')


def test_int16_multi_bucket_routes_dense():
    """The panel kernel keeps int16 to one bucket.  Such a schedule at 25%
    padded occupancy goes dense, as in the JAX package; at 12.5%, below
    SPARSE_OCCUPANCY_THRESHOLD, it goes to the worklist kernel, as in the
    JAX package (before the worklist kernel was ported it went dense), and
    the worklist kernel stores its codes."""
    # one short pulse per channel: 1 of 4 subtiles live
    chans = [0.5 * wt.gaussian(3e-8) >> (1e-6 + 1e-7 * c) for c in range(4)]
    low = lower_t(chans, 0.0, 8.192e-6, 2e9, bucket_samples=4096)
    assert low.n_buckets > 1
    assert classify_route(low)[0] == 'panel'
    assert classify_route(low, out_dtype=torch.int16)[0] == 'dense'
    with pytest.raises(wt.UnsupportedFactor):
        classify_route(low, force='panel', out_dtype=np.int16)
    # 1 of 8 subtiles live
    low = lower_t(chans, 0.0, 16.384e-6, 2e9, bucket_samples=4096)
    assert classify_route(low, out_dtype=torch.int16)[0] == 'sparse'
    codes = wt.synthesize(chans, 0.0, 16.384e-6, 2e9, bucket_samples=4096,
                          out_dtype=torch.int16, device='cpu')
    host = wt.synthesize(chans, 0.0, 16.384e-6, 2e9, engine='numpy',
                         out_dtype=np.int16)
    assert np.abs(codes.numpy().astype(int) - host).max() <= 1


def test_import_loads_no_jax():
    code = ("import sys; import waveforms_tpu_torch, "
            "waveforms_tpu_torch.engine, waveforms_tpu_torch.kernels, "
            "waveforms_tpu_torch.convert, waveforms_tpu_torch.schedules, "
            "waveforms_tpu_torch.native, waveforms_tpu_torch.ops.torch_eval, "
            "waveforms_tpu_torch.ops.torch_basis, waveforms_tpu_torch.dsl, "
            "waveforms_tpu_torch.__main__, waveforms_tpu_torch.version, "
            "waveforms_tpu_torch.utils.freeze, "
            "waveforms_tpu_torch.utils.profiling, "
            "waveforms_tpu_torch.cross_engine; "
            "bad = [m for m in sys.modules if m == 'jax' "
            "or m.startswith(('jax.', 'jaxlib', 'waveforms_tpu.')) "
            "or m == 'waveforms_tpu']; print(bad); assert not bad, bad")
    r = subprocess.run([sys.executable, '-c', code], cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr[-2000:]


def test_cuda_without_gpu_raises(monkeypatch):
    """device='cuda' never carries on with the CPU."""
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    chans, start, stop, fs = E2E['sparse_pulses']
    port = [waveform_from_jax(w) for w in chans]
    before = kernels.launch_counts()
    with pytest.raises(RuntimeError, match='no CUDA device'):
        wt.synthesize(port, start, stop, fs, device='cuda')
    assert kernels.launch_counts() == before


@pytest.mark.parametrize('kwargs, match', [
    ({'precision': 'double', 'engine': 'cuda-stack'},
     'unsupported on engine'),
    ({'out_dtype': torch.bfloat16}, None),
    ({'out_dtype': np.float16}, None),
    ({'out_dtype': np.int32}, 'int16 only'),
    ({'engine': 'pallas'}, 'unknown engine'),
    ({'precision': 'double', 'out_dtype': torch.bfloat16}, 'contradicts'),
    ({'precision': 'double', 'out_dtype': np.float32}, 'contradicts'),
    ({'part': 'complex', 'out_dtype': np.float16}, 'requires f32'),
])
def test_unported_modes_raise(kwargs, match):
    """Modes the port refuses, as the JAX package refuses them; the
    narrowed stores (``match`` None) return the f32 result rounded once."""
    chans = [wt.gaussian(1e-6)]
    if match is None:
        got = wt.synthesize(chans, -1e-6, 1e-6, 1e9, device='cpu', **kwargs)
        dt = {torch.bfloat16: torch.bfloat16,
              np.float16: torch.float16}[kwargs['out_dtype']]
        f32 = wt.synthesize(chans, -1e-6, 1e-6, 1e9, device='cpu')
        assert got.dtype == dt and torch.equal(got, f32.to(dt))
        return
    with pytest.raises(ValueError, match=match):
        wt.synthesize(chans, -1e-6, 1e-6, 1e9, device='cpu', **kwargs)


def test_play_sparse_refuses_narrowed_stores():
    """The worklist sequence play has no narrowed store, as in JAX
    (``Sequencer.play_many(sparse=True)``)."""
    from waveforms_tpu_torch.ops import Sequencer
    seq = Sequencer([lower_t([wt.gaussian(3e-8) >> 1e-6], 0.0, 4.096e-6,
                             2e9)], device='cpu')
    with pytest.raises(NotImplementedError, match='f32-only'):
        seq.play_many([0], sparse=True, out_dtype=torch.bfloat16)


def test_pair_mode_schedule_is_refused():
    """A pair-mode schedule is refused for anything but f32 accumulation
    into complex64, on every kernel, as in the JAX package."""
    from waveforms_tpu_torch import kernels
    from waveforms_tpu_torch.ops.synth import (DeviceSchedule,
                                               synthesize_device)
    low = lower_t([(1 + 1j) * wt.gaussian(2e-7)], -3e-7, 3e-7, 2e9,
                  part='complex')
    dev = DeviceSchedule(low, 'cpu')
    with pytest.raises(ValueError, match='pair-mode'):
        synthesize_device(dev, out_dtype=torch.int16)
    with pytest.raises(ValueError, match='pair-mode'):
        kernels._out_kind(torch.empty((1, low.n_samples)), None,
                          (1, low.n_samples), pair=True)
    assert synthesize_device(dev).dtype == torch.complex64


def _route_cases():
    """name -> (JAX channels, start, stop, fs, lowering kwargs, route
    kwargs, the JAX router's kind)."""
    def ladder(n_pulses):
        return _ladder_j(n_pulses, 8), 0.0, 524.288e-6, 2e9

    def suite(name):
        return bench_suite.build(name)

    def midband():
        rng = np.random.default_rng(17)
        chans = []
        for c in range(2):
            x = wj.zero()
            for _ in range(120):
                I, _ = wj.mixing(0.5 * wj.cosPulse(200e-9)
                                 >> rng.uniform(0, 90e-6),
                                 freq=-150e6 - 2e6 * c, DRAGScaling=1e-10)
                x = x + I
            chans.append(x)
        return chans, 0.0, 100e-6, 2e9

    low_occ = ([0.5 * wj.gaussian(3e-8) >> (1e-6 + 1e-7 * c)
                for c in range(4)], 0.0, 16.384e-6, 2e9)
    return {
        'flagship': (partial(bench_case, 'flagship'), {}, {}, 'panel'),
        'mid': (partial(bench_case, 'mid'), {}, {}, 'panel'),
        'dense': (partial(bench_case, 'dense'), {}, {}, 'dense'),
        'ladder60': (partial(ladder, 60), {}, {}, 'stack'),
        'ladder120': (partial(ladder, 120), {}, {}, 'stack'),
        'vstack_1000x200k': (partial(suite, 'vstack_1000x200k'), {}, {},
                             'stack'),
        'overlap100_drag_2200': (partial(suite, 'overlap100_drag_2200'), {},
                                 {}, 'stack'),
        'int16_buckets_low_occ': (lambda: low_occ,
                                  {'bucket_samples': 4096},
                                  {'out_dtype': np.int16}, 'sparse'),
        'flagship_complex': (partial(bench_case, 'flagship'),
                             {'part': 'complex'}, {}, 'panel'),
        'midband_stack': (midband, {}, {}, 'stack'),
    }


def bench_case(name):
    builder = {'flagship': bench.build_schedule,
               'mid': bench.build_mid_schedule,
               'dense': bench.build_dense_schedule}[name]
    stop = schedules.STRATA[name][1]
    return builder(n_channels=4), 0.0, stop, bench.FS


def _ladder_j(n_pulses, n_channels):
    """tools/tpu_capture.py's occupancy ladder (_ladder_chans), built with
    the JAX package: the port's schedules.build_ladder_schedule."""
    rng = np.random.default_rng(5)
    chans = []
    for c in range(n_channels):
        x = wj.zero()
        for _ in range(n_pulses):
            I, _ = wj.mixing(0.5 * wj.cosPulse(200e-9)
                             >> rng.uniform(0, 524.288e-6 * 0.9),
                             freq=-150e6 - 2e6 * c, DRAGScaling=1e-10)
            x += I
        chans.append(x)
    return chans


@pytest.mark.parametrize('case', list(_route_cases()))
def test_route_parity_with_jax(case):
    """classify_route gives the JAX router's kind on the same lowered
    schedule ('panel-windowed' read as 'panel').  The JAX kind is asserted
    first, so that a schedule that stops routing where intended fails
    loudly."""
    build, low_kw, route_kw, kind = _route_cases()[case]
    chans, start, stop, fs = build()
    low = lower_j(chans, start, stop, fs, **low_kw)
    kind_j, _ = classify_pallas_route(low, **route_kw)
    assert {'panel-windowed': 'panel'}.get(kind_j, kind_j) == kind
    kind_t, plan = classify_route(lowered_from_jax(low), **route_kw)
    assert kind_t == kind
    assert (plan is None) == (kind_t == 'dense')


def test_ladder_schedule_is_the_capture_ladder(jax_python_lowering,
                                               torch_python_lowering):
    """schedules.build_ladder_schedule builds tools/tpu_capture.py's
    ladder: the same lowering as the JAX-built one (both on their Python
    paths)."""
    from test_torch_lowering import assert_lowered_equal
    low_j = lower_j(_ladder_j(30, 2), 0.0, 524.288e-6, 2e9)
    low_t = lower_t(schedules.build_ladder_schedule(30, n_channels=2), 0.0,
                    524.288e-6, 2e9)
    assert_lowered_equal(lowered_from_jax(low_j), low_t)


def test_slice_stack_route_matches_jax_engine_and_oracle():
    """A small ladder (the mid-band schedule of tests/test_stack_synth.py)
    through the entry point: routed to the stack route, against the JAX
    package's engine='pallas' (interpret mode) and the oracle."""
    chans, start, stop, fs = _route_cases()['midband_stack'][0]()
    port = [waveform_from_jax(w) for w in chans]
    kernels.reset_launch_counts()
    got = wt.synthesize(port, start, stop, fs, device='cpu')
    assert kernels.launch_counts()['synth_stack'] == 0   # plain version
    ref = np.asarray(wj.synthesize(chans, start, stop, fs, engine='pallas'))
    assert rel(got.numpy(), ref) <= TOL_JAX
    want = oracle([c.simplify() for c in chans], start, stop, fs)
    assert rel(got.numpy(), want) <= RTOL
    codes = wt.synthesize(port, start, stop, fs, out_dtype=np.int16,
                          device='cpu')
    host = wt.synthesize(port, start, stop, fs, engine='numpy',
                         out_dtype=np.int16)
    assert np.abs(codes.numpy().astype(int) - host).max() <= 1


@pytest.mark.parametrize('engine, kind', [('cuda-stack', 'stack'),
                                          ('cuda-sparse', 'sparse')])
def test_forced_engines_match_jax(engine, kind):
    chans, start, stop, fs = E2E['sparse_pulses']
    port = [waveform_from_jax(w) for w in chans]
    if kind == 'stack':
        chans, start, stop, fs = _route_cases()['midband_stack'][0]()
        port = [waveform_from_jax(w) for w in chans]
    got = wt.synthesize(port, start, stop, fs, engine=engine, device='cpu')
    ref = np.asarray(wj.synthesize(chans, start, stop, fs,
                                   engine=engine.replace('cuda', 'pallas')))
    assert rel(got.numpy(), ref) <= TOL_JAX


def test_cuda_stack_refuses_what_it_cannot_batch():
    with pytest.raises(wt.UnsupportedFactor, match='batchable'):
        wt.synthesize([wt.gaussian(2e-6) >> 4e-6], 0.0, 8.192e-6, 2e9,
                      engine='cuda-stack', device='cpu')


def test_signature_is_the_jax_order():
    """synthesize(channels, start, stop, sample_rate, engine,
    bucket_samples, part, precision, out_dtype, dac_scale, device): a
    positional call with precision in its place gives the keyword call's
    output."""
    import inspect
    names = list(inspect.signature(wt.synthesize).parameters)
    jax_names = list(inspect.signature(wj.synthesize).parameters)
    assert names == jax_names + ['device']
    chans, start, stop, fs = E2E['sparse_pulses']
    port = [waveform_from_jax(w) for w in chans]
    pos = wt.synthesize(port, start, stop, fs, 'auto', 'auto', 'real',
                        'single', torch.int16, 30000.0, 'cpu')
    kw = wt.synthesize(port, start, stop, fs, device='cpu',
                       precision='single', out_dtype=torch.int16,
                       dac_scale=30000.0)
    assert pos.dtype == torch.int16
    assert torch.equal(pos, kw)


@pytest.mark.parametrize('engine', ['auto', 'cuda-dense', 'cuda-stack'])
def test_precision_double_is_not_ported(engine):
    """precision='double' on the kernel engines: 'auto' and 'cuda-dense'
    run the double tier and return float64 within 1e-9 of the oracle;
    'cuda-stack', which has no double tier, raises as the JAX package's
    forced pallas engines do."""
    chans = [wt.gaussian(1e-6)]
    want = wt.synthesize(chans, -1e-6, 1e-6, 1e9, engine='numpy')
    if engine == 'cuda-stack':
        with pytest.raises(ValueError, match='unsupported on engine'):
            wt.synthesize(chans, -1e-6, 1e-6, 1e9, engine=engine,
                          precision='double', device='cpu')
    else:
        got = wt.synthesize(chans, -1e-6, 1e-6, 1e9, engine=engine,
                            precision='double', device='cpu')
        assert got.dtype == torch.float64
        assert rel(got.numpy(), want) <= 1e-9
    with pytest.raises(ValueError, match='unknown precision'):
        wt.synthesize(chans, -1e-6, 1e-6, 1e9, engine=engine,
                      precision='half', device='cpu')
    # the numpy engine is the float64 oracle: it takes 'double' as JAX does
    out = wt.synthesize(chans, -1e-6, 1e-6, 1e9, engine='numpy',
                        precision='double')
    assert out.dtype == np.float64

