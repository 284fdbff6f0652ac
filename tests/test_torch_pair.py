"""Pair mode (``part='complex'``) on the dense, panel and worklist kernels'
plain versions, against the JAX kernels' pair mode and the oracle.

A ``part='complex'`` lowering carries a second amplitude plane; the kernels
then compute each term's factor product once, starting from 1.0, and scale
it by both planes into a complex64 result.  The same lowered schedule goes
through the JAX package's ``synthesize_device`` / ``synthesize_panels`` /
``synthesize_sparse`` (interpret mode, as its own tests run them on the
CPU) and the port's counterparts on ``device='cpu'``.

Tolerances: within 1e-6 of each channel's peak modulus against the JAX
kernels (both f32, same formulas) and 2e-6 against
``engine='numpy', part='complex'``.
"""

import numpy as np
import pytest
import torch

import waveforms_tpu as wj
import waveforms_tpu.ops.sparse_synth as sj
from waveforms_tpu.ops.lowering import lower_schedule as lower_j
from waveforms_tpu.ops.pallas_synth import DeviceSchedule as DeviceJ
from waveforms_tpu.ops.pallas_synth import synthesize_device as synth_j
import waveforms_tpu_torch as wt
from waveforms_tpu_torch.convert import lowered_from_jax, waveform_from_jax
from waveforms_tpu_torch.ops.sparse_synth import (build_panel_plan,
                                                  build_sparse_plan,
                                                  synthesize_panels,
                                                  synthesize_sparse)
from waveforms_tpu_torch.ops.synth import (DeviceSchedule, synthesize_device,
                                           validate_out_mode)
from test_torch_synth import RTOL, TOL_JAX

FS = 2e9


def rel(a, b):
    """Max over channels of max|a - b| / max|b|, complex by modulus."""
    a = np.asarray(a, np.complex128)
    b = np.asarray(b, np.complex128)
    peak = np.maximum(np.abs(b).max(axis=-1), 1e-30)
    return float((np.abs(a - b).max(axis=-1) / peak).max())


def cases():
    """(channels, start, stop, bucket_samples): the pair-mode schedules of
    tests/test_pallas_synth.py and tests/test_sparse_synth.py."""
    I, Q = wj.mixing(0.5 * wj.cosPulse(50e-9), freq=-80e6, DRAGScaling=1e-10)
    fused = [(1 + 0.5j) * wj.gaussian(2e-7) * wj.cos(2 * np.pi * 150e6),
             I + 1j * Q]
    rng = np.random.default_rng(3)
    pulses = []
    for c in range(4):
        x = wj.zero()
        for _ in range(6):
            x += ((0.4 + 0.6j) * wj.gaussian(3e-8)
                  * wj.cos(2 * np.pi * (5e7 + 1e6 * c))
                  >> float(rng.uniform(1e-7, 8e-6)))
        pulses.append(x)
    clipped = 2 * wj.gaussian(1e-6)
    clipped.max, clipped.min = 1.0, 0.2
    return {
        'fused': (fused, -1e-7, 1e-7, 'auto'),
        'pulses': (pulses, 0.0, 8.192e-6, 'auto'),
        'pulses_4_buckets': (pulses, 0.0, 8.192e-6, 4096),
        'clipped': ([(0.5 + 0.5j) * wj.gaussian(1e-6), clipped], -2e-6,
                    2e-6, 'auto'),
    }


def complex_oracle(chans, start, stop):
    return wj.synthesize(chans, start, stop, FS, engine='numpy',
                         part='complex')


def lowered(case):
    chans, start, stop, bs = cases()[case]
    low = lower_j(chans, start, stop, FS, part='complex', bucket_samples=bs)
    assert low.amp_im is not None
    return chans, start, stop, low, lowered_from_jax(low)


def port(route, low_t):
    dev = DeviceSchedule(low_t, 'cpu')
    if route == 'dense':
        return synthesize_device(dev)
    if route == 'panel':
        return synthesize_panels(dev, plan=build_panel_plan(low_t))
    return synthesize_sparse(dev, plan=build_sparse_plan(low_t))


def jax_pair(route, low):
    if route == 'dense':
        return synth_j(DeviceJ(low), rows_per_tile=8, interpret=True)
    if route == 'panel':
        return sj.synthesize_panels(DeviceJ(low), low=low, interpret=True)
    return sj.synthesize_sparse(DeviceJ(low), low=low, interpret=True)


@pytest.mark.parametrize('case', list(cases()))
@pytest.mark.parametrize('route', ['dense', 'panel', 'sparse'])
def test_pair_mode_matches_jax_and_oracle(route, case):
    chans, start, stop, low, low_t = lowered(case)
    got = port(route, low_t)
    assert got.dtype == torch.complex64
    ref = np.asarray(jax_pair(route, low))
    assert ref.dtype == np.complex64 and got.shape == ref.shape
    assert rel(got.numpy(), ref) <= TOL_JAX
    if case != 'clipped':
        # a clipped complex channel: the kernels clip each plane on its own
        # (the JAX pair mode, held above); the oracle clips otherwise
        assert rel(got.numpy(), complex_oracle(chans, start, stop)) <= RTOL


def test_pair_mode_is_one_product_per_term():
    """The real plane of a pair-mode pass equals part='real' synthesized on
    its own, and the imaginary plane part='imag', to f32 noise: one factor
    product per term serves both planes."""
    chans, start, stop, _, low_t = lowered('pulses')
    pair = port('dense', low_t)
    for part, plane in (('real', torch.real), ('imag', torch.imag)):
        one = lowered_from_jax(lower_j(chans, start, stop, FS, part=part))
        assert rel(plane(pair).numpy(), port('dense', one).numpy()) <= TOL_JAX


@pytest.mark.parametrize('out_dtype', [torch.int16, np.int16])
def test_pair_mode_needs_f32(out_dtype):
    _, _, _, _, low_t = lowered('fused')
    dev = DeviceSchedule(low_t, 'cpu')
    with pytest.raises(ValueError, match='f32'):
        synthesize_device(dev, out_dtype=out_dtype)
    with pytest.raises(ValueError, match='f32'):
        validate_out_mode(out_dtype, 2, 32767.0, 'cpu', pair=True)
    chans = [waveform_from_jax(w) for w in cases()['fused'][0]]
    with pytest.raises(ValueError, match='f32'):
        wt.synthesize(chans, -1e-7, 1e-7, FS, part='complex',
                      out_dtype=out_dtype, device='cpu')


@pytest.mark.parametrize('engine', ['auto', 'cuda-dense', 'cuda-panel',
                                    'cuda-sparse'])
def test_synthesize_complex_matches_jax_engine(engine):
    """The entry point with part='complex' against the JAX package's, on
    the CPU (interpret mode), and the numpy engine's complex oracle."""
    chans, start, stop, bs = cases()['pulses']
    port_chans = [waveform_from_jax(w) for w in chans]
    got = wt.synthesize(port_chans, start, stop, FS, engine=engine,
                        part='complex', device='cpu')
    assert got.dtype == torch.complex64 and got.shape == (4, 16384)
    jax_engine = engine.replace('cuda', 'pallas')
    ref = np.asarray(wj.synthesize(chans, start, stop, FS,
                                   engine='pallas' if engine == 'auto'
                                   else jax_engine, part='complex'))
    assert rel(got.numpy(), ref) <= TOL_JAX
    host = wt.synthesize(port_chans, start, stop, FS, engine='numpy',
                         part='complex')
    np.testing.assert_array_equal(host, complex_oracle(chans, start, stop))
    assert rel(got.numpy(), host) <= RTOL
