"""The port's sharded panel and worklist paths against the JAX package's.

``synthesize_panels_sharded`` (K2, one launch a shard) and
``synthesize_sparse_sharded`` (K7, one launch a shard over a zeroed block)
of ``waveforms_tpu_torch.ops.sparse_synth`` on a (4, 2) mesh that names the
CPU eight times (the kernels' plain versions), against the same functions
of ``waveforms_tpu.ops.sparse_synth`` on the JAX package's 8-device CPU
mesh in interpret mode, as tests/test_sparse_synth.py and
tests/test_panel_synth.py run them.  Each port result equals the port's
single-device kernel on the same lowering and plan bit for bit and lies
within 1e-6 of each channel's peak of JAX's (int16 within one code; bf16
equal to the port's own f32 result rounded once).  The per-shard
worklists (``shard_sparse_work``, ``shard_panel_work``) equal JAX's array
for array, and their counts scale as 1/P.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import waveforms_tpu as wj
import waveforms_tpu.ops.sparse_synth as sj
from waveforms_tpu.core import WaveVStack as VStackJ
from waveforms_tpu.ops.lowering import lower_schedule as lower_j
from waveforms_tpu_torch.convert import lowered_from_jax
from waveforms_tpu_torch.ops import sparse_synth as st
from waveforms_tpu_torch.ops.lowering import UnsupportedFactor
from waveforms_tpu_torch.ops.synth import DeviceSchedule
from test_torch_mesh import FS, bf16_step, mesh_j, mesh_t, np_of, \
    sparse_schedule
from test_torch_synth import TOL_JAX, rel

KERNELS = {'panel': (st.synthesize_panels_sharded, st.synthesize_panels,
                     sj.synthesize_panels_sharded),
           'sparse': (st.synthesize_sparse_sharded, st.synthesize_sparse,
                      sj.synthesize_sparse_sharded)}


def _cases():
    """(JAX channels, stop, part, bucket_samples) of the JAX suite's sharded
    sparse and panel cases, cut to 16,384 samples."""
    rng = np.random.default_rng(41)
    pair = [VStackJ([((0.4 + 0.6j) * wj.cosPulse(60e-9) >> o)
                     for o in rng.uniform(0, 7e-6, 5)]) for _ in range(6)]
    return {
        'single_bucket': (sparse_schedule(6, seed=8), 'real', None),
        'pair': (pair, 'complex', None),
        'bucketed': (sparse_schedule(6, seed=9), 'real', 4096),
        'ragged': (sparse_schedule(5, seed=3), 'real', None),
    }


def _lowered(case, stop=8.192e-6):
    chans, part, bs = _cases()[case]
    if case == 'ragged':
        stop = 7.9995e-6                  # 15,999 samples
    low = lower_j(chans, 0, stop, FS, part=part, bucket_samples=bs)
    assert (low.shape[1] > 1) == (case == 'bucketed')
    return low, lowered_from_jax(low)


@pytest.mark.parametrize('kernel, case, dtype', [
    (k, c, d) for k in KERNELS for c in _cases()
    for d in ('float32', 'int16', 'bfloat16')
    if d == 'float32' or c != 'pair'])          # pair mode is f32 only
def test_sharded_matches_single_device_and_jax(kernel, case, dtype):
    low, low_t = _lowered(case)
    sharded, single, jax_fn = KERNELS[kernel]
    tdt = {'int16': torch.int16, 'bfloat16': torch.bfloat16}.get(dtype)
    jdt = {'int16': jnp.int16, 'bfloat16': jnp.bfloat16}.get(
        dtype, jnp.float32)
    scale = np.linspace(20000.0, 32767.0, low.shape[0], dtype=np.float32)
    refused = (kernel == 'panel' and case == 'bucketed'
               and dtype != 'float32')
    if refused:
        # a narrowed store with two local buckets: both packages refuse
        with pytest.raises(UnsupportedFactor, match='multi-bucket'):
            sharded(low_t, mesh_t(), Rs=8, out_dtype=tdt)
        with pytest.raises(Exception, match='multi-bucket'):
            jax_fn(low, mesh_j(), Rs=8, interpret=True, out_dtype=jdt)
        return
    plane = sharded(low_t, mesh_t(), Rs=8, out_dtype=tdt, dac_scale=scale)
    got = plane.gather()
    want = single(DeviceSchedule(low_t, 'cpu'), low_t, Rs=8, out_dtype=tdt,
                  dac_scale=scale)
    assert got.dtype == want.dtype and torch.equal(got, want)
    ref = np_of(jax_fn(low, mesh_j(), Rs=8, interpret=True, out_dtype=jdt,
                       dac_scale=scale))
    got = np_of(got)
    if dtype == 'int16':
        assert np.abs(got.astype(int) - ref).max() <= 1
    elif dtype == 'bfloat16':
        f32 = sharded(low_t, mesh_t(), Rs=8).gather()
        assert torch.equal(plane.gather(), f32.to(torch.bfloat16))
        assert (np.abs(got - ref) <= bf16_step(ref)).all()
    elif case == 'pair':
        assert rel(got.real, ref.real) <= TOL_JAX
        assert rel(got.imag, ref.imag) <= TOL_JAX
    else:
        assert rel(got, ref) <= TOL_JAX


@pytest.mark.parametrize('kernel', list(KERNELS))
def test_combine_pair_false_planes(kernel):
    """Pair mode as two f32 planes equal to the complex result's parts
    (the JAX suite's test_sharded_combine_pair_false_planes)."""
    _, low_t = _lowered('pair')
    sharded = KERNELS[kernel][0]
    z = sharded(low_t, mesh_t(), Rs=8).gather()
    re, im = sharded(low_t, mesh_t(), Rs=8, combine_pair=False)
    assert re.dtype == im.dtype == torch.float32
    assert torch.equal(re.gather(), z.real) and torch.equal(im.gather(),
                                                             z.imag)


@pytest.mark.parametrize('case', ['single_bucket', 'bucketed', 'ragged'])
def test_shard_worklists_equal_jax(case):
    """The per-shard worklists and panel segmentations equal JAX's array
    for array, at the layout each sharded path computes."""
    low, low_t = _lowered(case)
    C, NB = low.shape[:2]
    nc, nt, Rs = 4, 2, 8
    cs = -(-C // nc)
    tile = Rs * 128
    if NB > 1:
        nb_local = -(-NB // nt)
        tps = nb_local * (low.bucket_samples // tile)
    else:
        nb_local = 1
        tps = -(-(-(-low.n_samples // 128) // Rs) // nt)
    plan_j = sj.build_sparse_plan(low, Rs=Rs)
    plan_t = st.build_sparse_plan(low_t, Rs=Rs)
    a = st.shard_sparse_work(plan_t, nc, nt, cs, tps, nb_local)
    b = sj.shard_sparse_work(plan_j, nc, nt, cs, tps, nb_local)
    for x, y in zip(a[0], b[0]):
        assert np.array_equal(x, y)
    assert np.array_equal(a[1], b[1]) and a[2] == b[2]
    a = st.shard_panel_work(plan_t, nc, nt, cs, tps, nb_local, Rs)
    b = sj.shard_panel_work(plan_j, nc, nt, cs, tps, nb_local, Rs)
    for x, y in zip(a[0], b[0]):
        assert np.array_equal(x, y)
    assert np.array_equal(a[1], b[1]) and a[2:] == b[2:]


def test_sharded_work_scales_with_devices():
    """Per-shard worklist lengths track 1/P with bounded skew on a
    uniformly scattered schedule (the JAX suite's
    test_sharded_work_and_bytes_scale_with_devices)."""
    rng = np.random.default_rng(7)
    chans = [VStackJ([(wj.cosPulse(50e-9) >> float(rng.uniform(0, 7.9e-6)))
                      for _ in range(40)]) for _ in range(8)]
    low_t = lowered_from_jax(lower_j(chans, 0, 8.192e-6, FS,
                                     bucket_samples=None))
    plan = st.build_sparse_plan(low_t, Rs=8)
    nc, nt = 4, 2
    tps = -(-(-(-low_t.n_samples // 128) // 8) // nt)
    _, counts, K = st.shard_sparse_work(plan, nc, nt, 8 // nc, tps)
    total = counts.sum()
    assert total == plan.n_live
    assert counts.max() <= 2.5 * total / (nc * nt), counts


def test_sharded_rejects_a_foreign_plan():
    """A plan built from another lowering raises before any launch."""
    _, low_t = _lowered('single_bucket')
    _, other = _lowered('ragged')
    plan = st.build_sparse_plan(other, Rs=8)
    with pytest.raises(ValueError, match='lowering'):
        st.synthesize_sparse_sharded(low_t, mesh_t(), Rs=8, plan=plan)
    with pytest.raises(ValueError, match='Rs=8'):
        st.synthesize_panels_sharded(low_t, mesh_t(), Rs=32, plan=plan)
