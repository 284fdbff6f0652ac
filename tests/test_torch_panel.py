"""The panel kernel's plain PyTorch version against the JAX panel kernel.

The same lowered schedule and the same PanelPlan go through the JAX panel
kernel (``synthesize_panels``, interpret mode) and through the port's
panel path on ``device='cpu'``, the plain version of
``csrc/synth_panel.cu`` (``ops.reference.panel_walk``): zeros everywhere,
the live subtiles walked over their own segment ranges, multi-bucket
subtiles accumulated across buckets.  Tolerances as in test_torch_synth.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import waveforms_tpu as wj
import waveforms_tpu.ops.sparse_synth as sj
from waveforms_tpu.ops.lowering import lower_schedule as lower_j
from waveforms_tpu.ops.pallas_synth import DeviceSchedule as DeviceJ
from waveforms_tpu_torch import UnsupportedFactor
from waveforms_tpu_torch.convert import lowered_from_jax
from waveforms_tpu_torch.ops.sparse_synth import (build_panel_plan,
                                                  synthesize_panels)
from waveforms_tpu_torch.ops.synth import DeviceSchedule
from test_torch_lowering import opcode_cases
from test_torch_synth import ORACLE_TOL, RTOL, TOL_JAX, oracle, rel

FS = 2e9


def sparse_pulses(n=4, pulses=6, stop=8.192e-6, seed=1):
    """Gaussian-windowed carriers scattered over the window (the shape of
    tests/test_panel_synth.py's schedules, cut to 16k samples)."""
    rng = np.random.default_rng(seed)
    out = []
    for c in range(n):
        w = wj.zero()
        for _ in range(pulses):
            w += (0.3 * wj.gaussian(3e-8) * wj.cos(2 * np.pi * (5e7 + 1e6 * c))
                  >> float(rng.uniform(1e-7, stop - 1e-7)))
        out.append(w)
    return out, 0.0, stop, FS, 'auto'


def cases():
    c = {k: opcode_cases(wj)[k] for k in ('basic_shapes', 'drag_mixing',
                                           'multitone_drag', 'multi_bucket',
                                           'chirps')}
    c['sparse_pulses'] = sparse_pulses()
    return c


def both(case, out_dtype=None, dac_scale=32767.0):
    """(port, JAX, lowering, plan) for one case."""
    chans, start, stop, fs, bs = cases()[case]
    low = lower_j(chans, start, stop, fs, bucket_samples=bs)
    low_t = lowered_from_jax(low)
    plan = build_panel_plan(low_t)
    got = synthesize_panels(DeviceSchedule(low_t, 'cpu'), plan=plan,
                            out_dtype=out_dtype, dac_scale=dac_scale).numpy()
    ref = np.asarray(sj.synthesize_panels(
        DeviceJ(low), plan=sj.build_panel_plan(low), interpret=True,
        out_dtype=jnp.int16 if out_dtype is not None else jnp.float32,
        dac_scale=dac_scale))
    return got, ref, low, plan


@pytest.mark.parametrize('case', list(cases()))
def test_panel_walk_matches_jax_and_oracle(case):
    chans, start, stop, fs, bs = cases()[case]
    got, ref, low, plan = both(case)
    assert got.dtype == np.float32 and got.shape == ref.shape
    assert rel(got, ref) <= TOL_JAX
    assert rel(got, oracle(chans, start, stop, fs)) <= ORACLE_TOL.get(
        case, RTOL)
    if case == 'multi_bucket':
        assert plan.n_buckets > 1


def test_silent_subtiles_are_exact_zeros():
    got, _, low, plan = both('sparse_pulses')
    tile = plan.Rs * 128
    live = np.zeros(got.shape, bool)
    slot = np.searchsorted(plan.start, np.arange(plan.n_live), 'right') - 1
    chan = slot // (plan.n_panels * plan.n_buckets)
    for c, o in zip(chan, plan.work_o[:plan.n_live]):
        live[c, o * tile:(o + 1) * tile] = True
    assert plan.n_live < live.size // tile          # really sparse
    assert not got[~live].any()
    assert got[live].any()


@pytest.mark.parametrize('case', ['sparse_pulses', 'drag_mixing'])
def test_int16_on_one_bucket(case):
    """int16 codes equal clip(round_half_even(f32 * scale)) of the port's
    own f32 panel output, within one code of the JAX panel kernel's."""
    scales = np.linspace(16000.0, 32767.0,
                         len(cases()[case][0])).astype(np.float32)
    f32 = both(case)[0]
    codes, ref, _, plan = both(case, out_dtype=np.int16, dac_scale=scales)
    assert plan.n_buckets == 1 and codes.dtype == np.int16
    expected = np.clip(np.round(f32 * scales[:, None]), -32768, 32767)
    np.testing.assert_array_equal(codes, expected.astype(np.int16))
    assert np.abs(codes.astype(np.int64) - ref.astype(np.int64)).max() <= 1


def test_int16_needs_one_bucket():
    chans, start, stop, fs, bs = cases()['multi_bucket']
    low = lowered_from_jax(lower_j(chans, start, stop, fs,
                                   bucket_samples=bs))
    with pytest.raises(UnsupportedFactor):
        synthesize_panels(DeviceSchedule(low, 'cpu'), low=low,
                          out_dtype=torch.int16)


def test_stale_plan_is_refused():
    chans, start, stop, fs, bs = cases()['sparse_pulses']
    low = lowered_from_jax(lower_j(chans, start, stop, fs))
    other = lowered_from_jax(lower_j(chans[:2], start, stop, fs))
    with pytest.raises(ValueError, match='rebuild the plan'):
        synthesize_panels(DeviceSchedule(low, 'cpu'),
                          plan=build_panel_plan(other))

