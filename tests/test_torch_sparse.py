"""The worklist kernel's plain PyTorch version against the JAX worklist
kernel.

The same lowered schedule and the same SparsePlan go through the JAX
worklist kernel (``synthesize_sparse``, interpret mode, as
tests/test_sparse_synth.py runs it on the CPU) and through the port's
worklist path on ``device='cpu'``, the plain version of
``csrc/synth_sparse.cu`` (``ops.reference.sparse_walk``): a zeroed output,
and every live subtile of the worklist evaluated over its own segment range
and stored once.  f32, int16 and pair mode, with one bucket and with
several, and at subtile heights of Rs 1, 8 and 32 rows on windows that
are not a multiple of the subtile, both plans built by each package's own
``build_sparse_plan(low, Rs=...)``.  Tolerances as in test_torch_synth (1e-6 of each channel's peak
against the JAX kernel, 2e-6 against the oracle); int16 codes within one
code of JAX's.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import waveforms_tpu as wj
import waveforms_tpu.ops.sparse_synth as sj
from waveforms_tpu.ops.lowering import lower_schedule as lower_j
from waveforms_tpu.ops.pallas_synth import DeviceSchedule as DeviceJ
from waveforms_tpu_torch import kernels
from waveforms_tpu_torch.convert import lowered_from_jax
from waveforms_tpu_torch.ops.sparse_synth import (SparseWork,
                                                  build_sparse_plan,
                                                  synthesize_sparse)
from waveforms_tpu_torch.ops.synth import DeviceSchedule
from test_torch_lowering import opcode_cases
from test_torch_panel import sparse_pulses
from test_torch_synth import ORACLE_TOL, RTOL, TOL_JAX, oracle, rel


def cases():
    c = {k: opcode_cases(wj)[k] for k in ('drag_mixing', 'multi_bucket',
                                           'chirps')}
    c['sparse_pulses'] = sparse_pulses()
    c['pulses_4_buckets'] = sparse_pulses()[:4] + (4096,)
    # 15,999 samples: the last subtile is ragged at every Rs
    c['ragged_pulses'] = sparse_pulses(stop=7.9995e-6)
    return c


# subtile heights: the default 32 keeps each case's own test id
RS = (32, 8, 1)


def rs_params(names):
    return [pytest.param(n, rs, id=n if rs == 32 else f'{n}-Rs{rs}')
            for n in names for rs in RS]


def both(case, out_dtype=None, dac_scale=32767.0, Rs=32):
    """(port, JAX, lowering, plan) for one case, both plans at ``Rs``."""
    chans, start, stop, fs, bs = cases()[case]
    low = lower_j(chans, start, stop, fs, bucket_samples=bs)
    low_t = lowered_from_jax(low)
    plan = build_sparse_plan(low_t, Rs=Rs)
    got = synthesize_sparse(DeviceSchedule(low_t, 'cpu'), plan=plan,
                            out_dtype=out_dtype, dac_scale=dac_scale).numpy()
    ref = np.asarray(sj.synthesize_sparse(
        DeviceJ(low), plan=sj.build_sparse_plan(low, Rs=Rs), interpret=True,
        out_dtype=jnp.int16 if out_dtype is not None else jnp.float32,
        dac_scale=dac_scale))
    return got, ref, low, plan


@pytest.mark.parametrize('case, Rs', rs_params(cases()))
def test_sparse_walk_matches_jax_and_oracle(case, Rs):
    chans, start, stop, fs, bs = cases()[case]
    got, ref, low, plan = both(case, Rs=Rs)
    assert plan.Rs == Rs
    assert got.dtype == np.float32 and got.shape == ref.shape
    assert rel(got, ref) <= TOL_JAX
    assert rel(got, oracle(chans, start, stop, fs)) <= ORACLE_TOL.get(
        case, RTOL)
    if bs == 4096:
        assert low.n_buckets > 1


@pytest.mark.parametrize('case, Rs', rs_params(
    ['sparse_pulses', 'pulses_4_buckets', 'ragged_pulses']))
def test_sparse_int16_codes_match_jax(case, Rs):
    """int16 needs no single-bucket rule on the worklist kernel: buckets
    are whole subtiles, so each subtile's codes are stored once."""
    got, ref, low, _ = both(case, out_dtype=np.int16, dac_scale=30000.0,
                            Rs=Rs)
    assert got.dtype == np.int16 and ref.dtype == np.int16
    assert np.abs(got.astype(int) - ref).max() <= 1


def test_sparse_plan_matches_jax():
    chans, start, stop, fs, bs = cases()['pulses_4_buckets']
    low = lower_j(chans, start, stop, fs, bucket_samples=bs)
    pj = sj.build_sparse_plan(low)
    pt = build_sparse_plan(lowered_from_jax(low))
    for name in ('work_c', 'work_b', 'work_t', 'work_o', 'work_s0',
                 'work_s1'):
        np.testing.assert_array_equal(getattr(pt, name), getattr(pj, name),
                                      err_msg=name)
    assert (pt.n_live, pt.n_tiles, pt.window_samples) == (
        pj.n_live, pj.n_tiles, pj.window_samples)


def test_only_live_subtiles_are_written():
    """The worklist kernel stores its live subtiles and nothing else: the
    caller's background survives everywhere else (padding items, whose
    output subtile is n_tiles, write nothing)."""
    chans, start, stop, fs, bs = cases()['sparse_pulses']
    low_t = lowered_from_jax(lower_j(chans, start, stop, fs))
    plan = build_sparse_plan(low_t)
    assert len(plan.work_o) > plan.n_live            # padding present
    dev = DeviceSchedule(low_t, 'cpu')
    out = torch.full((dev.shape[0], plan.window_samples), 7.0)
    kernels.synth_sparse(dev, SparseWork.upload(plan, 'cpu'), out, None)
    tile = plan.Rs * 128
    live = np.zeros(out.shape, bool)
    for c, o in zip(plan.work_c[:plan.n_live], plan.work_o[:plan.n_live]):
        live[c, o * tile:(o + 1) * tile] = True
    assert (out.numpy()[~live] == 7.0).all()
    ref = synthesize_sparse(dev, plan=plan).numpy()
    np.testing.assert_array_equal(out.numpy()[live], ref[live])


def test_sparse_refuses_a_plan_of_another_schedule():
    chans, start, stop, fs, _ = cases()['sparse_pulses']
    low_t = lowered_from_jax(lower_j(chans, start, stop, fs))
    other = lowered_from_jax(lower_j(chans[:2], start, stop, fs))
    with pytest.raises(ValueError, match='channels'):
        synthesize_sparse(DeviceSchedule(low_t, 'cpu'),
                          plan=build_sparse_plan(other))
