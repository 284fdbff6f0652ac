"""The port's slice end to end: ``waveforms_tpu_torch.synthesize``.

On ``device='cpu'`` the entry point runs the kernels' plain versions; it is
held against ``waveforms_tpu.synthesize(engine='pallas')`` (interpret mode
on the CPU) and the float64 oracle.  Routing follows the JAX package's
occupancy rule, the package imports without JAX, and the parts not ported
yet refuse loudly.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import bench
import waveforms_tpu as wj
import waveforms_tpu_torch as wt
from waveforms_tpu.engine import classify_pallas_route
from waveforms_tpu.ops.lowering import lower_schedule as lower_j
from waveforms_tpu_torch import kernels, schedules
from waveforms_tpu_torch.convert import waveform_from_jax
from waveforms_tpu_torch.engine import classify_route
from waveforms_tpu_torch.ops.lowering import lower_schedule as lower_t
from test_torch_lowering import opcode_cases
from test_torch_panel import sparse_pulses
from test_torch_synth import RTOL, TOL_JAX, oracle, rel

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

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
    """The panel kernel keeps int16 to one bucket; such a schedule that the
    JAX package sends to its worklist kernel goes dense here."""
    # one short pulse per channel: 1 of 4 subtiles live
    chans = [0.5 * wt.gaussian(3e-8) >> (1e-6 + 1e-7 * c) for c in range(4)]
    low = lower_t(chans, 0.0, 8.192e-6, 2e9, bucket_samples=4096)
    assert low.n_buckets > 1
    assert classify_route(low)[0] == 'panel'
    assert classify_route(low, out_dtype=torch.int16)[0] == 'dense'
    with pytest.raises(wt.UnsupportedFactor):
        classify_route(low, force='panel', out_dtype=np.int16)


def test_import_loads_no_jax():
    code = ("import sys; import waveforms_tpu_torch, "
            "waveforms_tpu_torch.engine, waveforms_tpu_torch.kernels, "
            "waveforms_tpu_torch.convert, waveforms_tpu_torch.schedules; "
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
    ({'part': 'complex'}, 'pair mode'),
    ({'out_dtype': torch.bfloat16}, 'bf16'),
    ({'out_dtype': np.float16}, 'not ported'),
    ({'out_dtype': np.int32}, 'int16 only'),
    ({'engine': 'pallas'}, 'unknown engine'),
])
def test_unported_modes_raise(kwargs, match):
    chans = [wt.gaussian(1e-6)]
    with pytest.raises(ValueError, match=match):
        wt.synthesize(chans, -1e-6, 1e-6, 1e9, device='cpu', **kwargs)


def test_pair_mode_schedule_is_refused():
    from waveforms_tpu_torch.ops.synth import DeviceSchedule
    low = lower_t([(1 + 1j) * wt.gaussian(2e-7)], -3e-7, 3e-7, 2e9,
                  part='complex')
    with pytest.raises(ValueError, match='pair mode'):
        DeviceSchedule(low, 'cpu')

