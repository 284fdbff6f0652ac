"""Narrowed float stores (bf16, f16) on every f32 route, on the CPU.

The JAX package narrows every f32 store: the kernel's f32 sum rounded once
to ``out_dtype`` (``acc.astype(out_dtype)``).  The port does the same in
its kernels (``__float2bfloat16_rn`` / ``__float2half_rn``) and in their
plain versions (``Tensor.to``), which run here on ``device='cpu'``.

For each route -- dense (K1), single-bucket panel (K2), worklist (K7),
stack (K5, narrowed in the kernel and after the wide residual), the
stacked-table sequence (K6), ``Sequencer.play_many`` / ``play_packed``,
and the ``'numpy'`` engine -- in bf16 and in f16:

* the port's narrowed output equals the same call's f32 output rounded
  once (``.to(dtype)``), bit for bit;
* at every sample it lies within one ulp of the narrow type of the JAX
  function's output with the same ``out_dtype`` (Pallas in interpret
  mode, as the JAX suite runs it on the CPU), plus the two packages' f32
  contract (TOL_JAX = 1e-6 of the channel's peak): rounding is monotonic,
  so two f32 sums that differ by e round to values at most e + one ulp
  apart.  Away from zero the f32 noise is far below a bf16/f16 ulp and the
  bound is one ulp; near zero (a 1e-10 DRAG quadrature) it is the noise;
* the ``'numpy'`` engine equals the JAX ``'numpy'`` engine bit for bit.

Route parity with the JAX router under bf16 covers multi-bucket schedules,
whose panels refuse narrowed stores in both packages.
"""

from functools import lru_cache

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import waveforms_tpu as wj
import waveforms_tpu.ops.sparse_synth as spj
import waveforms_tpu.ops.stack_synth as stj
from waveforms_tpu.engine import classify_pallas_route
from waveforms_tpu.ops.lowering import lower_schedule as lower_j
from waveforms_tpu.ops.pallas_synth import DeviceSchedule as DeviceJ
from waveforms_tpu.ops.pallas_synth import synthesize_device as dense_j
from waveforms_tpu.ops.sequencer import Sequencer as SeqJ
from waveforms_tpu.ops.stack_seq import StackSequencer as StackSeqJ
import waveforms_tpu_torch as wt
from waveforms_tpu_torch.convert import lowered_from_jax, waveform_from_jax
from waveforms_tpu_torch.engine import classify_route
from waveforms_tpu_torch.ops import Sequencer, StackSequencer
from waveforms_tpu_torch.ops.sparse_synth import (build_panel_plan,
                                                  build_sparse_plan,
                                                  synthesize_panels,
                                                  synthesize_sparse)
from waveforms_tpu_torch.ops.stack_synth import (build_stack_plan,
                                                 synthesize_stack)
from waveforms_tpu_torch.ops.synth import (DeviceSchedule,
                                           normalize_out_dtype,
                                           synthesize_device)
from test_torch_lowering import opcode_cases
from test_torch_panel import sparse_pulses
from test_torch_synth import TOL_JAX

FS = 2e9
#: (torch dtype, the JAX spelling)
NARROW = {'bf16': (torch.bfloat16, jnp.bfloat16),
          'f16': (torch.float16, jnp.float16)}


def within_one_ulp(a, b):
    """a == b, or |a - b| <= one ulp of the narrow type at max(|a|, |b|)
    + TOL_JAX of each channel's finite peak, at every sample (a, b: one
    16-bit float dtype; a value past the type's range is inf in both)."""
    big = torch.maximum(a.abs(), b.abs())
    ulp = (big.view(torch.int16) + 1).view(a.dtype).float() - big.float()
    fb = b.float()
    peak = torch.where(torch.isfinite(fb), fb.abs(), 0.0).amax(
        dim=-1, keepdim=True)
    near = (a.float() - fb).abs() <= ulp + TOL_JAX * peak
    return bool(((a == b) | near).all())


def check(narrow, f32, ref, dt):
    """``narrow`` (port, narrowed) against the same call's f32 output and
    the JAX function's narrowed output ``ref``."""
    assert narrow.dtype == dt and narrow.shape == f32.shape
    assert torch.equal(narrow, f32.to(dt))
    ref = torch.from_numpy(np.asarray(ref).astype(np.float32)).to(dt)
    assert ref.shape == narrow.shape
    assert within_one_ulp(narrow, ref)


def port(low):
    return DeviceSchedule(lowered_from_jax(low), 'cpu')


DENSE = ('basic_shapes', 'drag_mixing', 'multi_bucket')


@pytest.mark.parametrize('name', list(NARROW))
@pytest.mark.parametrize('case', DENSE)
def test_dense_narrow_store(case, name):
    dt, jdt = NARROW[name]
    chans, start, stop, fs, bs = opcode_cases(wj)[case]
    low = lower_j(chans, start, stop, fs, bucket_samples=bs)
    dev = port(low)
    check(synthesize_device(dev, out_dtype=dt), synthesize_device(dev),
          dense_j(DeviceJ(low), rows_per_tile=8, interpret=True,
                  out_dtype=jdt), dt)


def _walk_cases():
    return {'sparse_pulses': sparse_pulses(),
            'drag_mixing': opcode_cases(wj)['drag_mixing'],
            'pulses_4_buckets': sparse_pulses()[:4] + (4096,)}


@pytest.mark.parametrize('name', list(NARROW))
@pytest.mark.parametrize('case', ['sparse_pulses', 'drag_mixing'])
def test_panel_narrow_store(case, name):
    """Single-bucket panels (the JAX panel kernel refuses narrowed stores
    on several buckets, and so does the port's)."""
    dt, jdt = NARROW[name]
    chans, start, stop, fs, bs = _walk_cases()[case]
    low = lower_j(chans, start, stop, fs, bucket_samples=bs)
    plan = build_panel_plan(lowered_from_jax(low))
    dev = port(low)
    check(synthesize_panels(dev, plan=plan, out_dtype=dt),
          synthesize_panels(dev, plan=plan),
          spj.synthesize_panels(DeviceJ(low), plan=spj.build_panel_plan(low),
                                interpret=True, out_dtype=jdt), dt)


@pytest.mark.parametrize('name', list(NARROW))
@pytest.mark.parametrize('case', ['sparse_pulses', 'pulses_4_buckets'])
def test_sparse_narrow_store(case, name):
    """The worklist kernel stores each subtile once onto a zero background
    of the narrow type, with one bucket or several."""
    dt, jdt = NARROW[name]
    chans, start, stop, fs, bs = _walk_cases()[case]
    low = lower_j(chans, start, stop, fs, bucket_samples=bs)
    plan = build_sparse_plan(lowered_from_jax(low))
    dev = port(low)
    check(synthesize_sparse(dev, plan=plan, out_dtype=dt),
          synthesize_sparse(dev, plan=plan),
          spj.synthesize_sparse(DeviceJ(low), plan=spj.build_sparse_plan(low),
                                interpret=True, out_dtype=jdt), dt)


def _stack_chans(case):
    """tests/test_stack_synth.py:276's vstack (narrowed in the kernel) and
    the same with a wide square (narrowed after the residual)."""
    rng = np.random.default_rng(41)
    wl = [float(a) * wj.cosPulse(50e-9) >> o
          for a, o in zip(rng.uniform(0.2, 1.0, 30),
                          rng.uniform(0, 8e-6, 30))]
    if case == 'mixed_wide':
        wl = wl + [0.25 * wj.square(6e-6) >> 4e-6]
    return [wj.WaveVStack(wl)]


@pytest.mark.parametrize('name', list(NARROW))
@pytest.mark.parametrize('case', ['vstack', 'mixed_wide'])
def test_stack_narrow_store(case, name):
    """No DAC scale on a float store, in the kernel (no residual) or after
    the residual, as in JAX."""
    dt, jdt = NARROW[name]
    low = lower_j(_stack_chans(case), 0.0, 8.192e-6, FS)
    low_t = lowered_from_jax(low)
    plan = build_stack_plan(low_t)
    assert (plan.wide is None) == (case == 'vstack')
    got = synthesize_stack(low_t, plan, out_dtype=dt, dac_scale=30000.0,
                           device='cpu')
    check(got, synthesize_stack(low_t, plan, device='cpu'),
          stj.synthesize_stack(low, stj.build_stack_plan(low),
                               interpret=True, out_dtype=jdt), dt)


@lru_cache(maxsize=None)
def _stack_table():
    rng = np.random.default_rng(11)
    chans = [[wj.WaveVStack([
        (float(a) * wj.cosPulse(50e-9) >> o)
        for a, o in zip(rng.uniform(0.2, 1.0, 40),
                        rng.uniform(0, 8.192e-6 - 1e-7, 40))])]
        for _ in range(3)]
    lows = [lower_j(ch, 0.0, 8.192e-6, FS) for ch in chans]
    return lows, StackSequencer([lowered_from_jax(low) for low in lows],
                                device='cpu')


@pytest.mark.parametrize('name', list(NARROW))
def test_stack_seq_narrow_store(name):
    dt, jdt = NARROW[name]
    lows, st = _stack_table()
    ks = [2, 0, 99, -3, 1]
    check(st.play_packed(ks, out_dtype=dt), st.play_packed(ks),
          StackSeqJ(lows).play_packed(ks, interpret=True, out_dtype=jdt), dt)
    assert torch.equal(st.play(1, out_dtype=dt), st.play(1).to(dt))


@lru_cache(maxsize=None)
def _gates_table():
    chans = [
        [wj.gaussian(100e-9) >> 0.3e-6, wj.cosPulse(80e-9) >> 0.7e-6],
        [0.7 * wj.square(200e-9, edge=20e-9) >> 0.5e-6,
         wj.drag_sin(0.2e9, 22.3e-9, plateau=6.1e-9, delta=3e6,
                     block_freq=(151e6,), phase=0.1) >> 0.4e-6],
        [wj.gaussian(60e-9) * wj.cos(2 * np.pi * 150e6) >> 0.2e-6,
         wj.cosPulse(50e-9) >> 0.8e-6]]
    lows = [lower_j(ch, 0.0, 1e-6, FS) for ch in chans]
    return SeqJ(lows), Sequencer([lowered_from_jax(low) for low in lows],
                                 device='cpu')


@pytest.mark.parametrize('name', list(NARROW))
@pytest.mark.parametrize('method', ['play_many', 'play_packed',
                                    'play_replay'])
def test_sequencer_narrow_store(method, name):
    dt, jdt = NARROW[name]
    sj, st = _gates_table()
    ks = [2, 0, 99, -3, 1]
    kw = {'play_many': {'rows_per_tile': 8}, 'play_packed': {'Rs': 8},
          'play_replay': {}}[method]
    got = getattr(st, method)(ks, out_dtype=dt, **kw)
    ref = getattr(sj, method)(np.array(ks, np.int32), interpret=True,
                              out_dtype=jdt, **kw)
    check(got, getattr(st, method)(ks, **kw), ref, dt)
    assert torch.equal(st.play(2, out_dtype=dt), got[0])


@pytest.mark.parametrize('name', list(NARROW))
def test_numpy_engine_narrows_as_jax(name):
    """The host engine rounds its float64 result once, as the JAX host
    engine does: f16 through numpy, bf16 as ml_dtypes does it (through
    f32), returned as a CPU torch.bfloat16 tensor."""
    dt, jdt = NARROW[name]
    chans, start, stop, fs, _ = opcode_cases(wj)['drag_mixing']
    ours = [waveform_from_jax(w) for w in chans]
    got = wt.synthesize(ours, start, stop, fs, engine='numpy', out_dtype=dt)
    ref = wj.synthesize(chans, start, stop, fs, engine='numpy',
                        out_dtype=jdt)
    f64 = wt.synthesize(ours, start, stop, fs, engine='numpy')
    if dt == torch.float16:
        assert got.dtype == np.float16
        np.testing.assert_array_equal(got, ref)
        np.testing.assert_array_equal(got, f64.astype(np.float16))
    else:
        assert isinstance(got, torch.Tensor) and got.dtype == dt
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(ref).astype(np.float32))
        assert torch.equal(got, torch.from_numpy(f64).to(dt))


@pytest.mark.parametrize('spelling, want', [
    (torch.bfloat16, torch.bfloat16), (jnp.bfloat16, torch.bfloat16),
    (jnp.dtype(jnp.bfloat16), torch.bfloat16), ('bfloat16', torch.bfloat16),
    (torch.float16, torch.float16), (np.float16, torch.float16),
    (jnp.float16, torch.float16), ('float16', torch.float16)])
def test_every_spelling_of_the_narrow_types(spelling, want):
    assert normalize_out_dtype(spelling) == want


def _route_cases():
    """name -> (JAX channels, start, stop, bucket_samples)."""
    quarter = [0.5 * wj.gaussian(3e-8) >> (1e-6 + 1e-7 * c)
               for c in range(4)]
    chans, start, stop, _, _ = sparse_pulses()
    return {
        'panel_one_bucket': (chans, start, stop, 'auto'),
        'panel_four_buckets': (chans, start, stop, 4096),
        'low_occupancy_buckets': (quarter, 0.0, 16.384e-6, 4096),
        'quarter_occupancy_buckets': (quarter, 0.0, 8.192e-6, 4096),
    }


@pytest.mark.parametrize('case', list(_route_cases()))
def test_route_parity_with_jax_under_bf16(case):
    """classify_route under out_dtype=bf16 gives the JAX router's kind;
    a multi-bucket schedule that goes to the panel kernel in f32 goes
    elsewhere in bf16, in both packages.  The entry point then stores
    bf16 equal to its own f32 output rounded once."""
    chans, start, stop, bs = _route_cases()[case]
    low = lower_j(chans, start, stop, FS, bucket_samples=bs)
    kind_j, _ = classify_pallas_route(low, out_dtype=jnp.bfloat16)
    kind_t, _ = classify_route(lowered_from_jax(low),
                               out_dtype=torch.bfloat16)
    assert kind_t == {'panel-windowed': 'panel'}.get(kind_j, kind_j)
    f32_kind = classify_route(lowered_from_jax(low))[0]
    if low.n_buckets > 1 and f32_kind == 'panel':
        assert kind_t != 'panel'
    ours = [waveform_from_jax(w) for w in chans]
    got = wt.synthesize(ours, start, stop, FS, bucket_samples=bs,
                        out_dtype=torch.bfloat16, device='cpu')
    f32 = wt.synthesize(ours, start, stop, FS, bucket_samples=bs,
                        device='cpu')
    assert torch.equal(got, f32.to(torch.bfloat16))
